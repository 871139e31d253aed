// Mamba-1 selective-scan forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `mamba_scan` of
// src/repro/kernels/mamba_scan.py (function at :61, pallas_call at :86):
// from h0 (B, di, N), for t = 0 .. S-1
//     h   = exp(dt_t * A) * h + (dt_t * x_t) (x) B_t
//     y_t = h . C_t + D * x_t
// over float32 x, dt (B, S, di), A (di, N), B, C (B, S, N), D (di,);
// returns y (B, S, di) and hT (B, di, N).  Its caller on the serving path
// is the "mamba" policy class: one launch encodes a daemon batch's
// arrival history, (1, 32, di = 8, N = 4), with the history carry as h0.
//
// Design.  The TPU kernel keeps a (block_d, N) state tile in VMEM and
// walks the sequence with a fori_loop inside a sequential grid axis; it
// asserts S % block_s == 0.  Here ONE THREAD PER (batch, channel) keeps
// h[N] and A[channel, :] in registers and loops over t itself; a block
// holds 128 channels of one batch row.  Per chunk of 16 steps the block
// stages B_t and C_t (shared by all its channels) in shared memory, and
// each thread loads its 16 x and dt values (neighbouring threads read
// neighbouring channels) before the steps, so the loads are in flight
// together.  Any S is taken: the ragged last chunk is masked by index.
// A step with dt = 0 leaves h bit-exact (exp(0) = 1, 0 * x * B = 0), which
// the daemon uses to keep pad rows out of the carry.  expf is the
// accurate one, not __expf: the reference exponentiates in float32.
//
// What bounds it.  The only loop-carried dependence is h = fma(dA, h, u),
// one FMA per step and state element; exp, the products and y's sum
// hang off it.  At the policy path's shape the whole launch is 8 threads
// and 32 steps, ~6 kFLOP and ~5 KB: its roofline bound is nanoseconds,
// so its time is launch latency plus the 32-step chain of loads and
// exp / FMA latencies.  At a wide shape (2, 256, 1024, 16) the bound is
// bytes (x, dt and y, ~6.6 MB) at ~2 us, and 2,048 threads occupy 16 SMs:
// the per-step latency, not bandwidth, sets the pace.

#include <cuda_runtime.h>
#include <math.h>

#define MS_BLOCK 128   // channels per block, one per thread
#define MS_CHUNK 16    // steps staged per round

template <int N>
__global__ void __launch_bounds__(MS_BLOCK) mamba_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ dskip,
    const float* __restrict__ h0, float* __restrict__ y,
    float* __restrict__ hT, int s, int di) {
  __shared__ float s_b[MS_CHUNK][N];
  __shared__ float s_c[MS_CHUNK][N];
  const int b = blockIdx.y;
  const int ch = blockIdx.x * MS_BLOCK + threadIdx.x;
  const bool live = ch < di;
  const int chc = live ? ch : 0;     // idle threads read channel 0, store nothing
  float h[N], av[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = a[(size_t)chc * N + n];
    h[n] = h0[((size_t)b * di + chc) * N + n];
  }
  const float dsk = dskip[chc];
  const size_t row0 = (size_t)b * s;                 // row (b, 0) of (B, S, .)
  for (int t0 = 0; t0 < s; t0 += MS_CHUNK) {
    const int nt = min(MS_CHUNK, s - t0);
    __syncthreads();                                 // last chunk consumed
    for (int i = threadIdx.x; i < MS_CHUNK * N; i += MS_BLOCK) {
      const int j = i / N, n = i - j * N;
      const size_t off = (row0 + t0 + j) * N + n;
      s_b[j][n] = j < nt ? bm[off] : 0.f;
      s_c[j][n] = j < nt ? cm[off] : 0.f;
    }
    __syncthreads();
    float xs[MS_CHUNK], dts[MS_CHUNK];
#pragma unroll
    for (int j = 0; j < MS_CHUNK; ++j) {
      const size_t off = (row0 + t0 + j) * di + chc;
      xs[j] = j < nt ? x[off] : 0.f;
      dts[j] = j < nt ? dt[off] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < MS_CHUNK; ++j) {
      if (j >= nt) break;                            // the same for the block
      const float u = dts[j] * xs[j];
      float yv = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float da = expf(dts[j] * av[n]);
        h[n] = fmaf(da, h[n], u * s_b[j][n]);
        yv = fmaf(h[n], s_c[j][n], yv);
      }
      if (live) y[(row0 + t0 + j) * di + ch] = fmaf(xs[j], dsk, yv);
    }
  }
  if (!live) return;
#pragma unroll
  for (int n = 0; n < N; ++n) hT[((size_t)b * di + ch) * N + n] = h[n];
}

template <int N>
static void launch(const float* x, const float* dt, const float* a,
                   const float* bm, const float* cm, const float* d,
                   const float* h0, float* y, float* hT, int bsz, int s,
                   int di, cudaStream_t stream) {
  const dim3 grid((di + MS_BLOCK - 1) / MS_BLOCK, bsz);
  mamba_scan_kernel<N><<<grid, MS_BLOCK, 0, stream>>>(x, dt, a, bm, cm, d,
                                                      h0, y, hT, s, di);
}

extern "C" int mamba_scan_launch(const void* x, const void* dt, const void* a,
                                 const void* bm, const void* cm,
                                 const void* d, const void* h0, void* y,
                                 void* hT, int bsz, int s, int di, int n,
                                 void* stream) {
  const float *xf = (const float*)x, *dtf = (const float*)dt,
              *af = (const float*)a, *bf = (const float*)bm,
              *cf = (const float*)cm, *df = (const float*)d,
              *hf = (const float*)h0;
  float *yf = (float*)y, *tf = (float*)hT;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 4: launch<4>(xf, dtf, af, bf, cf, df, hf, yf, tf, bsz, s, di, st); break;
    case 8: launch<8>(xf, dtf, af, bf, cf, df, hf, yf, tf, bsz, s, di, st); break;
    case 16: launch<16>(xf, dtf, af, bf, cf, df, hf, yf, tf, bsz, s, di, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
