// Mamba-1 selective-scan backward for Hopper (sm_90a), kernel 6's
// gradient.
//
// No Pallas kernel has it: the reference trains through XLA's autodiff of
// its chunked scan (src/repro/models/mamba.py:62, `selective_scan`), and
// its TPU kernel (src/repro/kernels/mamba_scan.py:61) has no backward.
// Given the forward's inputs, the state at each chunk's start (the
// training instance of mamba_scan.cu writes them), dy (B, S, di) and dhT
// (B, di, N) or nothing, with G_t = dL/dh_t:
//     G_{S-1} = dhT + dy_{S-1} C_{S-1},  G_t = dA_{t+1} G_{t+1} + dy_t C_t
//     dx_t  = D dy_t + dt_t sum_n G_t B_t
//     ddt_t = x_t sum_n G_t B_t + sum_n G_t A dA_t h_{t-1}
//     dB_t  = sum_d G_t u_t,   dC_t = sum_d dy_t h_t
//     dA    = sum_{b,t} G_t dA_t dt_t h_{t-1},   dD = sum_{b,t} dy_t x_t
//     dh0   = dA_0 G_0
// (dA_t = exp(dt_t A), u_t = dt_t x_t).
//
// Design.  With P_t = dA_t G_t, a step backwards is the affine map
// P_{t+1} -> dA_t (P_{t+1} + dy_t C_t), so the reverse recurrence is the
// forward's scan of maps run from the last step to the first, and the
// forward's launch plan carries over (kernels/mamba_scan.py `scan_bwd_plan`
// takes `scan_plan`'s SPL and L, so a chunk is the forward's chunk): a
// block holds W warps of one batch row, a channel each; a lane holds SPL
// states of a segment of L steps.  Blocks walk their chunks from the last
// to the first and carry P across chunks (dhT into the last; steps past S
// are zero-filled, dt = 0 is the identity map).  Per chunk:
//   1. x, dt, dy of W channels and the chunk's B and C rows arrive in
//      shared memory (cp.async, zero-filled past S and di), and the lane
//      reads its channel's state at the chunk's start;
//   2. the forward again, in the forward's association: each lane keeps
//      its segment's dA (L x SPL) and its states h_t (L x SPL) in
//      registers, from the chunk state through an inclusive scan over the
//      segments;
//   3. each lane composes its segment's reverse maps from its last step to
//      its first (the last segment from the carry), an inclusive suffix
//      Hillis-Steele scan over the segments (a lane combines only lanes
//      after it) gives each segment P at its start, and a shuffle P at
//      its end;
//   4. the lane runs its L steps again in reverse: G_t, dx_t and ddt_t
//      (sums over its SPL states, then over the G lanes by shuffles),
//      dA and dD summed in registers, and its G_t u_t and dy_t h_t for dB
//      and dC into its own slots of its warp's slab in shared memory;
//   5. the block sums the slabs over its warps in order and writes one
//      partial a block, (B, blocks, S, N), and stores dx and ddt rows.
// After the last chunk, dA and dD are summed over the segments by
// shuffles (per-row partials) and dh0 = P_0 is written where asked for.
// A second kernel sums the dB and dC partials over the blocks and the dA
// and dD partials over the batch rows, in a fixed order: every gradient
// repeats bit for bit from call to call (no atomics).
//
// What bounds it (PERF.md section 6, row 6b).  At falcon-mamba-7b's
// training shape (8, 512, 8192, 16) the call must read x, dt, dy and the
// chunk states and write dx and ddt: ~0.71 GB, ~0.21 ms at 3.35 TB/s; the
// exponentials (one a (b, t, d, n), 0.128 ms) are recomputed from dt, not
// stored.  This first version also writes and reads the dB / dC block
// partials (2 x B x S x N x di / W floats, 0.54 GB at that shape) and
// loads each chunk synchronously (no double buffer): both are later work.

#include "mamba_scan.cuh"

#define MSB_MAX_WARPS 8

struct BwdArgs {
  ScanArgs f;                  // x, dt, a, bm, cm, d (and s, di) as forward
  const float *states, *dy, *dhT;   // dhT may be null (zero)
  float *dx, *ddt;             // (B, S, di)
  float *db_part, *dc_part;    // (B, blocks, S, N)
  float *da_part;              // (B, di, N)
  float *dd_part;              // (B, di)
  float* dh0;                  // (B, di, N) or null
  int nbx;                     // gridDim.x
};

// SPL consecutive floats into 4 * SPL-byte aligned shared memory
template <int SPL>
__device__ __forceinline__ void st_states(float* p, const float (&v)[SPL]) {
  if constexpr (SPL == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (SPL == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < SPL; ++k) p[k] = v[k];
  }
}

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int N, int SPL, int L>
struct BwdTiles {
  using S = Scan<N, SPL, L>;
  // floats before the dB / dC slabs: the B and C tiles (as the forward's),
  // then x, dt, dy, dx and ddt (W x TP each), rounded up to 16 bytes
  __host__ __device__ static constexpr int slab_offset(int w) {
    return (2 * S::BC + 5 * w * S::TP + 3) / 4 * 4;
  }
  // and the two slabs, W x BC each: a warp's per-lane G u and dy h
  __host__ __device__ static constexpr int smem_floats(int w) {
    return slab_offset(w) + 2 * w * S::BC;
  }
};

template <int N, int SPL, int L>
__global__ void __launch_bounds__(MSB_MAX_WARPS * 32)
    mamba_scan_bwd_kernel(const BwdArgs p) {
  using S = Scan<N, SPL, L>;
  using T = BwdTiles<N, SPL, L>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int w_count = blockDim.x >> 5, nthr = blockDim.x;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int seg = lane / S::G, g = lane - seg * S::G;
  const int b = blockIdx.y, ch0 = blockIdx.x * w_count, ch = ch0 + w;
  const int s_len = p.f.s, di = p.f.di;
  const bool live = ch < di;
  const int chc = live ? ch : di - 1;     // idle warps read a real channel
  const int nch = (s_len + S::CH - 1) / S::CH;
  const int wt = w_count * S::TP;
  float* sdy = smem + 2 * S::BC + 2 * wt;  // after load_chunk's x and dt
  float* sdx = sdy + wt;
  float* sddt = sdx + wt;
  float* red_b = smem + T::slab_offset(w_count);
  float* red_c = red_b + w_count * S::BC;
  float* my_b = red_b + w * S::BC + seg * S::SS + g * SPL;
  float* my_c = red_c + w * S::BC + seg * S::SS + g * SPL;
  // this thread's x, dt, dy, dx and ddt elements: channel w_ld, steps
  // t_ld + 32 k (W is a power of two)
  const int w_ld = threadIdx.x & (w_count - 1);
  const int t_ld = threadIdx.x >> (__ffs(w_count) - 1);
  const bool bc16 = ((reinterpret_cast<uintptr_t>(p.f.bm) |
                      reinterpret_cast<uintptr_t>(p.f.cm)) & 15) == 0;

  float av[SPL], carry[SPL], da_acc[SPL];
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    av[k] = p.f.a[(size_t)chc * N + g * SPL + k];
    carry[k] = p.dhT ? p.dhT[((size_t)b * di + chc) * N + g * SPL + k] : 0.0f;
    da_acc[k] = 0.0f;
  }
  const float dsk = p.f.d[chc];
  float dd_acc = 0.0f;

  for (int c = nch - 1; c >= 0; --c) {
    const int t0 = c * S::CH;
    __syncthreads();                  // the last chunk's tiles are consumed
    // 1. the chunk's tiles, and the lane's state at the chunk's start
    load_chunk<N, SPL, L>(p.f, smem, w_count, b, ch0, t0, w_ld, t_ld, bc16);
#pragma unroll
    for (int t = t_ld; t < S::CH; t += 32) {
      const bool ok = ch0 + w_ld < di && t0 + t < s_len;
      const size_t off =
          ok ? ((size_t)b * s_len + t0 + t) * di + ch0 + w_ld : 0;
      cp_async4(smem_u32(sdy + w_ld * S::TP + t), p.dy + off, ok);
    }
    cp_async_commit();
    float hc[SPL];
#pragma unroll
    for (int k = 0; k < SPL; ++k)
      hc[k] = p.states[(((size_t)b * nch + c) * di + chc) * N + g * SPL + k];
    cp_async_wait0();
    __syncthreads();

    const float* lb = smem + seg * S::SS + g * SPL;
    const float* lc = lb + S::BC;
    const float* lx = smem + 2 * S::BC + w * S::TP + seg * L;
    const float* ldt = lx + wt;
    const float* ldy = ldt + wt;

    // 2. the forward again: dA, the segment's maps composed in order
    // (segment 0 from the chunk state), the scan, the states
    float da[L][SPL], hs[L][SPL], h_in[SPL];
    {
      float sa[SPL], sbv[SPL];
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        sa[k] = 1.0f;
        sbv[k] = seg == 0 ? hc[k] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const float dtj = ldt[j];
        const float u = dtj * lx[j];
        float bv[SPL];
        ld_states<SPL>(lb + j * N, bv);
#pragma unroll
        for (int k = 0; k < SPL; ++k) {
          da[j][k] = expf(dtj * av[k]);
          sa[k] = da[j][k] * sa[k];
          sbv[k] = fmaf(da[j][k], sbv[k], u * bv[k]);
        }
      }
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
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        const float prev = __shfl_up_sync(0xffffffffu, sbv[k], S::G);
        h_in[k] = seg == 0 ? hc[k] : prev;
      }
      float h[SPL];
#pragma unroll
      for (int k = 0; k < SPL; ++k) h[k] = h_in[k];
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const float u = ldt[j] * lx[j];
        float bv[SPL];
        ld_states<SPL>(lb + j * N, bv);
#pragma unroll
        for (int k = 0; k < SPL; ++k) {
          h[k] = fmaf(da[j][k], h[k], u * bv[k]);
          hs[j][k] = h[k];
        }
      }
    }

    // 3. the reverse maps P -> dA_t (P + dy_t C_t), from the segment's
    // last step to its first (the last segment from the carry), and the
    // suffix scan: segment seg gets P at its start, then P at its end
    float v[SPL];
    {
      float ra[SPL], rb[SPL];
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        ra[k] = 1.0f;
        rb[k] = seg == S::SEG - 1 ? carry[k] : 0.0f;
      }
#pragma unroll
      for (int j = L - 1; j >= 0; --j) {
        const float dyj = ldy[j];
        float cv[SPL];
        ld_states<SPL>(lc + j * N, cv);
#pragma unroll
        for (int k = 0; k < SPL; ++k) {
          rb[k] = da[j][k] * fmaf(dyj, cv[k], rb[k]);
          ra[k] = da[j][k] * ra[k];
        }
      }
#pragma unroll
      for (int dd = 1; dd < S::SEG; dd *= 2) {
#pragma unroll
        for (int k = 0; k < SPL; ++k) {
          const float pa = __shfl_down_sync(0xffffffffu, ra[k], dd * S::G);
          const float pb = __shfl_down_sync(0xffffffffu, rb[k], dd * S::G);
          if (seg + dd < S::SEG) {
            rb[k] = fmaf(ra[k], pb, rb[k]);
            ra[k] = ra[k] * pa;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        const float next = __shfl_down_sync(0xffffffffu, rb[k], S::G);
        v[k] = seg == S::SEG - 1 ? carry[k] : next;
      }
    }

    // 4. the segment's steps in reverse
#pragma unroll
    for (int j = L - 1; j >= 0; --j) {
      const float dtj = ldt[j], xj = lx[j], dyj = ldy[j];
      const float u = dtj * xj;
      float bv[SPL], cv[SPL], gu[SPL], yh[SPL];
      ld_states<SPL>(lb + j * N, bv);
      ld_states<SPL>(lc + j * N, cv);
      float gb = 0.0f, gah = 0.0f;
#pragma unroll
      for (int k = 0; k < SPL; ++k) {
        const float hp = j > 0 ? hs[j > 0 ? j - 1 : 0][k] : h_in[k];
        const float gk = fmaf(dyj, cv[k], v[k]);          // G_t
        const float pk = da[j][k] * gk;                    // P_t
        gb = fmaf(gk, bv[k], gb);
        gah = fmaf(pk * av[k], hp, gah);
        da_acc[k] = fmaf(pk * dtj, hp, da_acc[k]);
        gu[k] = gk * u;
        yh[k] = dyj * hs[j][k];
        v[k] = pk;
      }
      st_states<SPL>(my_b + j * N, gu);
      st_states<SPL>(my_c + j * N, yh);
#pragma unroll
      for (int o = 1; o < S::G; o *= 2) {
        gb += __shfl_xor_sync(0xffffffffu, gb, o);
        gah += __shfl_xor_sync(0xffffffffu, gah, o);
      }
      if (g == 0) {
        sdx[w * S::TP + seg * L + j] = fmaf(dsk, dyj, dtj * gb);
        sddt[w * S::TP + seg * L + j] = fmaf(xj, gb, gah);
        dd_acc = fmaf(dyj, xj, dd_acc);
      }
    }
    // P at the chunk's start, from segment 0: the next chunk's carry
#pragma unroll
    for (int k = 0; k < SPL; ++k)
      carry[k] = __shfl_sync(0xffffffffu, v[k], g);
    __syncthreads();                  // slabs and dx, ddt tiles complete

    // 5. dB and dC: the warps' slabs summed in order, one partial a block
    for (int i = threadIdx.x; i < S::CH * N; i += nthr) {
      const int t = i / N, n = i - t * N;
      const int sg = t / L, j = t - sg * L;
      const int off = sg * S::SS + j * N + n;
      float sb = 0.0f, sc = 0.0f;
      for (int ww = 0; ww < w_count; ++ww) {
        sb += red_b[ww * S::BC + off];
        sc += red_c[ww * S::BC + off];
      }
      if (t0 + t < s_len) {
        const size_t o =
            (((size_t)b * p.nbx + blockIdx.x) * s_len + t0 + t) * N + n;
        p.db_part[o] = sb;
        p.dc_part[o] = sc;
      }
    }
#pragma unroll
    for (int t = t_ld; t < S::CH; t += 32) {
      if (t0 + t < s_len && ch0 + w_ld < di) {
        const size_t o = ((size_t)b * s_len + t0 + t) * di + ch0 + w_ld;
        p.dx[o] = sdx[w_ld * S::TP + t];
        p.ddt[o] = sddt[w_ld * S::TP + t];
      }
    }
  }
  // 6. dA and dD over the segments (each g keeps its states' sums; dD is
  // on the g = 0 lanes), the row's partials, and dh0 = P_0
#pragma unroll
  for (int o = S::G; o < 32; o *= 2) {
#pragma unroll
    for (int k = 0; k < SPL; ++k)
      da_acc[k] += __shfl_xor_sync(0xffffffffu, da_acc[k], o);
    dd_acc += __shfl_xor_sync(0xffffffffu, dd_acc, o);
  }
  if (live && seg == 0) {
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      p.da_part[((size_t)b * di + ch) * N + g * SPL + k] = da_acc[k];
      if (p.dh0) p.dh0[((size_t)b * di + ch) * N + g * SPL + k] = carry[k];
    }
    if (g == 0) p.dd_part[(size_t)b * di + ch] = dd_acc;
  }
}

// The fixed-order sums: dB and dC (B, S, N) over the blocks' partials,
// dA (di, N) and dD (di,) over the batch rows' partials.
__global__ void __launch_bounds__(256) mamba_scan_bwd_reduce_kernel(
    const float* __restrict__ db_part, const float* __restrict__ dc_part,
    const float* __restrict__ da_part, const float* __restrict__ dd_part,
    float* db, float* dc, float* da, float* dd, int bsz, int s, int di,
    int n, int nbx) {
  const long long sn = (long long)s * n;
  const long long n_bc = bsz * sn, n_a = (long long)di * n;
  const long long total = n_bc + n_a + di;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    if (i < n_bc) {
      const long long bb = i / sn, r = i - bb * sn;
      const float* pb = db_part + bb * nbx * sn + r;
      const float* pc = dc_part + bb * nbx * sn + r;
      float sb = 0.0f, sc = 0.0f;
#pragma unroll 4
      for (int k = 0; k < nbx; ++k) {
        sb += pb[k * sn];
        sc += pc[k * sn];
      }
      db[i] = sb;
      dc[i] = sc;
    } else if (i < n_bc + n_a) {
      const long long r = i - n_bc;
      float sa = 0.0f;
      for (int bb = 0; bb < bsz; ++bb) sa += da_part[bb * n_a + r];
      da[r] = sa;
    } else {
      const long long r = i - n_bc - n_a;
      float sd = 0.0f;
      for (int bb = 0; bb < bsz; ++bb) sd += dd_part[bb * (long long)di + r];
      dd[r] = sd;
    }
  }
}

template <int N, int SPL, int L>
static int launch(const BwdArgs& p, int warps, dim3 grid, cudaStream_t st) {
  const size_t bytes = sizeof(float) * BwdTiles<N, SPL, L>::smem_floats(warps);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mamba_scan_bwd_kernel<N, SPL, L>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  mamba_scan_bwd_kernel<N, SPL, L><<<grid, warps * 32, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

// The instances: the forward's (SPL, L) for each N (MS_INSTANCES of
// mamba_scan.cu; SCAN_BUILT in kernels/mamba_scan.py).
#define MSB_INSTANCES(X)                                                   \
  X(4, 2, 2) X(4, 2, 8) X(8, 4, 2) X(8, 4, 8) X(16, 4, 4) X(16, 4, 8)

// One backward call: the scan kernel on the plan (states SPL, seg_len L,
// warps W, grid) and the reduction kernel on `reduce_blocks` blocks of 256
// threads; returns a CUDA error code (0 = launched).  dhT and dh0 may be
// null.  The partials are (B, grid_x, S, N) each, (B, di, N) and (B, di).
extern "C" int mamba_scan_bwd_launch(
    const void* x, const void* dt, const void* a, const void* bm,
    const void* cm, const void* d, const void* chunk_states, const void* dy,
    const void* dhT, void* dx, void* ddt, void* db_part, void* dc_part,
    void* da_part, void* dd_part, void* dh0, void* db, void* dc, void* da,
    void* dd, int bsz, int s, int di, int n, int states, int seg_len,
    int warps, int grid_x, int grid_y, int reduce_blocks, void* stream) {
  const bool ok = bsz >= 1 && s >= 1 && di >= 1 && warps >= 1 &&
                  warps <= MSB_MAX_WARPS && (warps & (warps - 1)) == 0 &&
                  grid_y == bsz && grid_y <= 65535 &&
                  (long long)grid_x * warps >= di &&
                  (long long)(grid_x - 1) * warps < di && reduce_blocks >= 1;
  if (!ok) return (int)cudaErrorInvalidValue;
  BwdArgs p;
  p.f = ScanArgs{(const float*)x, (const float*)dt, (const float*)a,
                 (const float*)bm, (const float*)cm, (const float*)d,
                 nullptr, nullptr, nullptr, nullptr, s, di};
  p.states = (const float*)chunk_states;
  p.dy = (const float*)dy;
  p.dhT = (const float*)dhT;
  p.dx = (float*)dx;
  p.ddt = (float*)ddt;
  p.db_part = (float*)db_part;
  p.dc_part = (float*)dc_part;
  p.da_part = (float*)da_part;
  p.dd_part = (float*)dd_part;
  p.dh0 = (float*)dh0;
  p.nbx = grid_x;
  const dim3 grid(grid_x, grid_y);
  const cudaStream_t st = (cudaStream_t)stream;
  int err = (int)cudaErrorInvalidValue;
#define MSB_CASE(NN, SS, LL) \
  if (n == NN && states == SS && seg_len == LL) \
    err = launch<NN, SS, LL>(p, warps, grid, st);
  MSB_INSTANCES(MSB_CASE)
#undef MSB_CASE
  if (err != 0) return err;
  mamba_scan_bwd_reduce_kernel<<<reduce_blocks, 256, 0, st>>>(
      (const float*)db_part, (const float*)dc_part, (const float*)da_part,
      (const float*)dd_part, (float*)db, (float*)dc, (float*)da, (float*)dd,
      bsz, s, di, n, grid_x);
  return (int)cudaGetLastError();
}
