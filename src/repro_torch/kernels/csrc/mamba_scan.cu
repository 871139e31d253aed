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
// arrival history, (1, 32, di = 8, N = 4), with the history carry as h0;
// the LM mixer's prefill launches it once a mamba layer.  A second
// instance, for training, also writes the state at each chunk's start,
// which the backward (mamba_scan_bwd.cu) reruns its chunks from; the
// serving instance's code is unchanged by it.
//
// Design.  The TPU kernel keeps a (block_d, N) state tile in VMEM and
// walks the sequence with a fori_loop inside a sequential grid axis.  Here
// the steps and the states of a channel are spread over a warp's lanes,
// and a step is an affine map of the state, h -> dA_t h + u_t B_t (dA_t =
// exp(dt_t A), u_t = dt_t x_t), so a chunk of steps is a scan of maps with
// (a2, b2) o (a1, b1) = (a2 a1, a2 b1 + b2).  The launch plan
// (kernels/mamba_scan.py, `scan_plan`) sets three things: a block holds W
// warps, one channel each, of one batch row; a lane holds SPL of the N
// states (G = N / SPL lanes a step); and the warp's 32 / G = SEG segments
// of L consecutive steps make a chunk of CH = SEG L steps.  Per chunk:
//   1. the block's x and dt tile (CH steps x W channels, 4-byte copies)
//      and the chunk's B and C rows (16-byte copies) arrive in shared
//      memory by cp.async, issued a chunk ahead (double buffer), so that
//      every global load of a chunk is in flight before its first
//      dependent step; A, D and h0 are loaded while the first chunk is in
//      flight.  Steps past S and channels past di are zero-filled: dt = 0
//      is the identity map;
//   2. each lane composes its segment's maps in order (segment 0 starts
//      from the carry, so its b is the state itself: h0 is folded into
//      the first step);
//   3. an inclusive Hillis-Steele scan over the segments (log2 SEG
//      shuffle steps; a lane combines only lanes before it) gives each
//      segment the state at its end, and a shuffle the state at its start;
//   4. each lane runs its L steps again from that state, h = fma(dA, h,
//      u B), and y_t is the sum of h C over its SPL states, then over the
//      G lanes by shuffles, plus D x_t, staged in shared memory and stored
//      by the block in coalesced rows;
//   5. the last segment's state is the next chunk's carry.
// No cumulative product is ever divided: a product of dA that underflows
// is a map that forgets, not a NaN.  The association of a step depends on
// (N, SPL, L) only, never on S, so dt = 0 pad rows after row n_real leave
// hT bit for bit the hT of the truncated sequence (identity maps compose
// exactly); `policy.mamba_encode_sequence` relies on that for the daemon's
// carry.  A NaN in dt at step t reaches y from t on and that channel's hT,
// and nothing earlier.  expf is the accurate one, not __expf: the
// reference exponentiates in float32.  tests/test_torch_scan_plan.py holds
// a numpy model of this association to the JAX reference.
//
// What bounds it (times from an H100 SXM, PERF.md section 6).  At the
// policy path's shape the launch moves 4.5 KB and does ~8 kFLOP: its
// roofline bound is nanoseconds.  It takes ~2.1 us against a launch floor
// (an empty kernel in a CUDA graph) of 0.8-1.2 us; the rest is one load
// round trip and one chunk's chain of 2 steps, 4 scan steps and 2 steps
// again.  The one-thread-a-channel kernel before it took 5.5-5.9 us, which
// was not launch latency: two chunks of 16 steps on 8 live threads, each
// chunk two dependent global round trips.  At a wide shape (2, 256, 1024,
// 16) the bound is bytes (x, dt and y, 6.7 MB) at 2.0 us, and the kernel
// takes 13.3-14.2 us (before: ~92): 2,048 channels give 16 warps an SM, and
// with 8.4 M accurate expf and the second pass a lane issues ~600
// instructions a chunk at ~0.4 a cycle a scheduler.

#include "mamba_scan.cuh"

// STATES: the training instance, which also writes the state at each
// chunk's start (the carry before its first step, h0 for chunk 0) to
// p.states, (B, chunks, di, N); the backward reruns a chunk from it.  The
// serving instance (STATES false) compiles to the same code as before the
// training instance existed.
template <int N, int SPL, int L, bool STATES>
__global__ void __launch_bounds__(MS_MAX_WARPS * 32)
    mamba_scan_kernel(const ScanArgs p) {
  using S = Scan<N, SPL, L>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int w_count = blockDim.x >> 5;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int seg = lane / S::G, g = lane - seg * S::G;
  const int b = blockIdx.y, ch0 = blockIdx.x * w_count, ch = ch0 + w;
  const bool live = ch < p.di;
  const int chc = live ? ch : p.di - 1;   // idle warps read a real channel
  const int buf_floats = S::buf_floats(w_count);
  float* sy = smem + 2 * buf_floats;
  const int nch = (p.s + S::CH - 1) / S::CH;
  // this thread's x, dt and y elements: channel w_ld, steps t_ld + 32 k
  // (W is a power of two)
  const int w_ld = threadIdx.x & (w_count - 1);
  const int t_ld = threadIdx.x >> (__ffs(w_count) - 1);
  const bool bc16 = ((reinterpret_cast<uintptr_t>(p.bm) |
                      reinterpret_cast<uintptr_t>(p.cm)) & 15) == 0;

  load_chunk<N, SPL, L>(p, smem, w_count, b, ch0, 0, w_ld, t_ld, bc16);
  cp_async_commit();
  if (nch > 1)
    load_chunk<N, SPL, L>(p, smem + buf_floats, w_count, b, ch0, S::CH, w_ld,
                          t_ld, bc16);
  cp_async_commit();
  // while the first chunk is in flight: the lane's A, D and carry
  float av[SPL], h[SPL];
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    av[k] = p.a[(size_t)chc * N + g * SPL + k];
    h[k] = p.h0[((size_t)b * p.di + chc) * N + g * SPL + k];
  }
  const float dsk = p.d[chc];

  for (int c = 0; c < nch; ++c) {
    if constexpr (STATES) {
      if (live && seg == 0) {
        float* st = p.states + (((size_t)b * nch + c) * p.di + ch) * N +
                    g * SPL;
#pragma unroll
        for (int k = 0; k < SPL; ++k) st[k] = h[k];
      }
    }
    const float* buf = smem + (c & 1) * buf_floats;
    const float* sb = buf + seg * S::SS + g * SPL;
    const float* sc = sb + S::BC;
    const float* sx = buf + 2 * S::BC + w * S::TP + seg * L;
    const float* sdt = sx + w_count * S::TP;
    cp_async_wait1();                 // this chunk has arrived ...
    __syncthreads();                  // ... for every thread of the block
    // 1. the segment's steps: dA, u B, and their composition in order
    float xs[L], da[L][SPL], ub[L][SPL];
    float sa[SPL], sbv[SPL];
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      sa[k] = 1.0f;
      sbv[k] = seg == 0 ? h[k] : 0.0f;   // the carry folded into segment 0
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      xs[j] = sx[j];
      const float dtj = sdt[j];
      const float u = dtj * xs[j];
      float bv[SPL];
      ld_states<SPL>(sb + j * N, bv);
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        da[j][k] = expf(dtj * av[k]);
        ub[j][k] = u * bv[k];
        sa[k] = da[j][k] * sa[k];
        sbv[k] = fmaf(da[j][k], sbv[k], ub[j][k]);
      }
    }
    // 2. inclusive scan over the segments: segment seg gets the state at
    // its end
#pragma unroll
    for (int dd = 1; dd < S::SEG; dd *= 2) {
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        const float pa = __shfl_up_sync(0xffffffffu, sa[k], dd * S::G);
        const float pb = __shfl_up_sync(0xffffffffu, sbv[k], dd * S::G);
        if (seg >= dd) {
          sbv[k] = fmaf(sa[k], pb, sbv[k]);
          sa[k] = sa[k] * pa;
        }
      }
    }
    // 3. the state at the segment's start, and its steps again
    float hs[SPL];
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      const float prev = __shfl_up_sync(0xffffffffu, sbv[k], S::G);
      hs[k] = seg == 0 ? h[k] : prev;
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      float part = 0.0f, cv[SPL];
      ld_states<SPL>(sc + j * N, cv);
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        hs[k] = fmaf(da[j][k], hs[k], ub[j][k]);
        part = fmaf(hs[k], cv[k], part);
      }
#pragma unroll
      for (int o = 1; o < S::G; o *= 2)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (g == 0) sy[w * S::TP + seg * L + j] = fmaf(xs[j], dsk, part);
    }
    // 4. the last segment's state carries into the next chunk
#pragma unroll
    for (int k = 0; k < SPL; ++k)
      h[k] = __shfl_sync(0xffffffffu, hs[k], (S::SEG - 1) * S::G + g);
    __syncthreads();                  // y tile complete, buffer consumed
    if (c + 2 < nch)                  // the chunk after next, into it
      load_chunk<N, SPL, L>(p, smem + (c & 1) * buf_floats, w_count, b, ch0,
                            (c + 2) * S::CH, w_ld, t_ld, bc16);
    cp_async_commit();
    const int t0 = c * S::CH;
#pragma unroll
    for (int t = t_ld; t < S::CH; t += 32) {
      if (t0 + t < p.s && ch0 + w_ld < p.di)
        p.y[((size_t)b * p.s + t0 + t) * p.di + ch0 + w_ld] =
            sy[w_ld * S::TP + t];
    }
  }
  if (live && seg == 0) {
#pragma unroll
    for (int k = 0; k < SPL; ++k)
      p.hT[((size_t)b * p.di + ch) * N + g * SPL + k] = h[k];
  }
}

template <int N, int SPL, int L, bool STATES>
static int launch(const ScanArgs& p, int warps, dim3 grid, cudaStream_t st) {
  using S = Scan<N, SPL, L>;
  const size_t bytes = sizeof(float) * S::smem_floats(warps);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mamba_scan_kernel<N, SPL, L, STATES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  mamba_scan_kernel<N, SPL, L, STATES><<<grid, warps * 32, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

// The instances: for each N in STATE_SIZES the (SPL, L) of the launch
// plan's two regimes, SCAN_LANES_FEW and SCAN_LANES in
// kernels/mamba_scan.py (SCAN_BUILT there lists the same).
#define MS_INSTANCES(X)                                                    \
  X(4, 2, 2) X(4, 2, 8) X(8, 4, 2) X(8, 4, 8) X(16, 4, 4) X(16, 4, 8)

template <bool STATES>
static int launch_plan(const ScanArgs& p, int bsz, int n, int states,
                       int seg_len, int warps, int grid_x, int grid_y,
                       void* stream) {
  const bool ok = bsz >= 1 && p.s >= 1 && p.di >= 1 && warps >= 1 &&
                  warps <= MS_MAX_WARPS && (warps & (warps - 1)) == 0 &&
                  grid_y == bsz && grid_y <= 65535 &&
                  (long long)grid_x * warps >= p.di &&
                  (long long)(grid_x - 1) * warps < p.di;
  if (!ok) return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x, grid_y);
  const cudaStream_t st = (cudaStream_t)stream;
#define MS_CASE(NN, SS, LL) \
  if (n == NN && states == SS && seg_len == LL) \
    return launch<NN, SS, LL, STATES>(p, warps, grid, st);
  MS_INSTANCES(MS_CASE)
#undef MS_CASE
  return (int)cudaErrorInvalidValue;
}

// One launch of the plan (states SPL, seg_len L, warps W, grid); returns a
// CUDA error code (0 = launched).  The grid must cover every channel of
// every batch row.
extern "C" int mamba_scan_launch(const void* x, const void* dt, const void* a,
                                 const void* bm, const void* cm,
                                 const void* d, const void* h0, void* y,
                                 void* hT, int bsz, int s, int di, int n,
                                 int states, int seg_len, int warps,
                                 int grid_x, int grid_y, void* stream) {
  const ScanArgs p{(const float*)x, (const float*)dt, (const float*)a,
                   (const float*)bm, (const float*)cm, (const float*)d,
                   (const float*)h0, (float*)y, (float*)hT, nullptr, s, di};
  return launch_plan<false>(p, bsz, n, states, seg_len, warps, grid_x,
                            grid_y, stream);
}

// The training instance's launch: the same plan, and the chunk-start
// states into `chunk_states`, (B, ceil(S / CH), di, N) float32.
extern "C" int mamba_scan_states_launch(
    const void* x, const void* dt, const void* a, const void* bm,
    const void* cm, const void* d, const void* h0, void* y, void* hT,
    void* chunk_states, int bsz, int s, int di, int n, int states,
    int seg_len, int warps, int grid_x, int grid_y, void* stream) {
  if (chunk_states == nullptr) return (int)cudaErrorInvalidValue;
  const ScanArgs p{(const float*)x, (const float*)dt, (const float*)a,
                   (const float*)bm, (const float*)cm, (const float*)d,
                   (const float*)h0, (float*)y, (float*)hT,
                   (float*)chunk_states, s, di};
  return launch_plan<true>(p, bsz, n, states, seg_len, warps, grid_x,
                           grid_y, stream);
}
