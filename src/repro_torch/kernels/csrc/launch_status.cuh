// How a launch function of the port reports what went wrong.
//
// Every extern "C" launch function returns 0 or a CUDA error code.  Where
// it refuses or fails, `launch_fail` also records why on the calling
// thread, and `launch_why()` hands that text to the wrapper
// (kernels/_build.py `launch`), which puts it in the message it raises:
// a plan that disagrees with the compiled tiles, a tensor map that
// cuTensorMapEncodeTiled refuses and a launch the runtime refuses all
// return cudaErrorInvalidValue and differ only there.
//
// `LaunchScope` opens a launch function that uses it: the runtime keeps
// the last error of each host thread until someone reads it, and a launch
// function checks its launches with cudaGetLastError(), so an error that
// an earlier runtime call of the same thread left behind would be
// reported as this function's own.  The scope reads and drops it on entry
// (noting it in the text, should this call fail) and drops whatever this
// call left on exit.  A fault of a running kernel is sticky and is not
// dropped: cudaGetLastError() goes on returning it.

#pragma once

#include <cuda_runtime.h>
#include <stdio.h>

static thread_local char launch_why_text[320];
static thread_local cudaError_t launch_stale = cudaSuccess;

// Record why this call returns `code` (printf-style) and return it.
template <typename... A>
static int launch_fail(int code, const char* fmt, A... args) {
  int n = snprintf(launch_why_text, sizeof launch_why_text, fmt, args...);
  if (n < 0) n = 0;
  if (launch_stale != cudaSuccess && n < (int)sizeof launch_why_text)
    snprintf(launch_why_text + n, sizeof launch_why_text - n,
             " (an earlier call on this thread had left %s pending; "
             "dropped on entry)", cudaGetErrorName(launch_stale));
  return code;
}

// The error of the launch just made, recorded as `what`'s, or 0.
static int launch_check(const char* what) {
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess
             ? 0
             : launch_fail((int)e, "%s: %s", what, cudaGetErrorString(e));
}

struct LaunchScope {
  LaunchScope() {
    launch_why_text[0] = '\0';
    launch_stale = cudaGetLastError();
  }
  ~LaunchScope() { (void)cudaGetLastError(); }
};

extern "C" const char* launch_why() { return launch_why_text; }
