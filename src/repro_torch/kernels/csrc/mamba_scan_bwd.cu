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
// (dA_t = exp(dt_t A), u_t = dt_t x_t).  With P_t = dA_t G_t a step
// backwards is the affine map P_{t+1} -> dA_t (P_{t+1} + dy_t C_t): the
// reverse recurrence is a scan of maps, run on the forward's chunks
// (kernels/mamba_scan.py `scan_bwd_plan` takes `scan_plan`'s SPL and L, so
// the training forward's chunk states line up), with P carried from the
// last chunk to the first (dhT into the last; steps past S are
// zero-filled, and dt = 0 is the identity map).
//
// What bounds it (PERF.md section 6, row 6b).  At falcon-mamba-7b's
// training shape (8, 512, 8192, 16) the call must read x, dt, dy and the
// chunk states and write dx and ddt: ~0.71 GB, 0.21 ms at 3.35 TB/s.  The
// arithmetic is ~16 float32 operations and one exponential a (b, t, d,
// n), ~0.13 ms each at the card's peaks; the shared-memory traffic of a
// scan that keeps a chunk's tiles on chip, ~0.5 ms.  These use different
// pipes, so the first version (2.69 ms) was latency that nothing hid: 163
// registers a thread held one block of 8 warps an SM, each chunk waited
// for its own loads behind four barriers, and its dB / dC partials, one
// per 8 channels, were 0.54 GB of traffic.  No tensor core helps: dB_t =
// sum_d G_t u_t and dC_t = sum_d dy_t h_t are, at each step, products of
// a (channels x N) matrix with a vector, and everything else is the
// elementwise recurrence.
//
// Design.  A block serves R = W K channels of one batch row: W warps (at
// most 8, a power of two), each walking its K channels in turn, a chunk
// at a time from the last chunk to the first.  A lane holds SPL states of
// a segment of L steps (G = N / SPL lanes a step, SEG = 32 / G segments, a
// chunk of CH = SEG L steps), as the forward.
//   * Two blocks an SM: __launch_bounds__(256, 2) caps a thread at 128
//     registers.  dA_t is not kept (the first version held it, L SPL
//     registers a lane): it is recomputed with one ex2.approx wherever it
//     is used, three a (b, t, d, n).  A lane's dC slots live in its
//     warp's slab in shared memory and the dB slots of the segment's
//     first L / 2 steps in a half slab; only the other L SPL / 2 dB slots,
//     summed over the warp's K channels, stay in registers.  Values that
//     the passes do not use (the thread's and block's indices, the shared
//     layout, the chunk count) are read afresh where used, so that none is
//     held over them: every instance spills nothing.
//   * Chunk loads ahead of use: two stages of cp.async groups, each with
//     the chunk's B and C rows, the x and dt rows of the R channels and
//     their chunk-start states; chunk c - 1's arrive while chunk c is
//     computed, and a chunk waits at one barrier for its tiles.  dy, for
//     which two blocks leave no shared memory, is prefetched into L1 with
//     them and read into registers once a channel.
//   * Per channel and chunk, three passes over a lane's L steps: (A)
//     forward, composing the forward maps h -> dA h + u B (segment 0 from
//     the chunk state) and the reverse maps P -> dA (P + dy C) (composed
//     in forward order: a <- a dA_t, b <- b + a dy_t C_t; the last
//     segment's applied to the carry), then an inclusive Hillis-Steele
//     scan over the segments for each (up and down), which gives every
//     segment h and P at its start and its end; (B) forward again, the
//     states h_t into registers and dy_t h_t into the dC slots; (C)
//     backwards: G_t, P_t, dx_t and ddt_t (sums over the lane's states,
//     then over the G lanes by shuffles; they overwrite x_t and dt_t in
//     the stage), dA and dD summed in registers, G_t u_t into the dB
//     slots.  Then dA and dD over the segments by shuffles into the
//     channel's sums in shared memory, and P at the chunk's start is the
//     channel's carry.
//   * After the block's passes, one barrier; dx (D dy_t added) and ddt go
//     out, 128 bytes a row at R = 32; the warps' dC slabs are summed in
//     order into one partial a block, (B, blocks, S, N), then their dB
//     slots likewise: 4 B S N di / R bytes each, a quarter of the first
//     version's at K = 4.
// A second kernel sums the dB and dC partials over the blocks and the dA
// and dD partials over the batch rows, in a fixed order: every gradient
// repeats bit for bit from call to call (no atomics).

#include "launch_status.cuh"
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
  int nch;                     // chunks of S steps
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

// 2^x, one MUFU instruction (relative error ~2^-22; denormal results
// flush to zero)
__device__ __forceinline__ float ex2f(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

#define MSB_LOG2E 1.4426950408889634f

// The thread's lane and warp and the block's coordinates, read afresh
// where used (volatile: neither held nor spilled over the passes, where
// every register goes to the recurrence)
__device__ __forceinline__ int block_x_now() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(v));
  return v;
}
__device__ __forceinline__ int block_y_now() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(v));
  return v;
}
__device__ __forceinline__ int tid_now() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v;
}
__device__ __forceinline__ int lane_now() {
  int v;
  asm volatile("mov.u32 %0, %%laneid;" : "=r"(v));
  return v;
}
__device__ __forceinline__ int warp_now() { return tid_now() >> 5; }

template <int N, int SPL, int L, int K>
struct BwdTiles {
  using S = Scan<N, SPL, L>;
  // a channel's row of x or dt in a stage, step-major: step t = seg L + j
  // at j SEG + seg (the SEG segments a lane reads at one j are
  // consecutive); a channel's two rows XP floats apart, channels RP (odd:
  // a warp reading one step of 32 channels hits 32 banks)
  static constexpr int XP = S::CH;
  static constexpr int RP = 2 * XP + 1;
  __host__ __device__ static constexpr int pos(int t) {
    return (t % L) * S::SEG + t / L;
  }
  // one stage for W warps: the B and C tiles, the x and dt rows of the R =
  // W K channels, their R chunk-start states; rounded up to 16 bytes
  __host__ __device__ static constexpr int stage_floats(int w) {
    return (2 * S::BC + w * K * RP + w * K * N + 3) / 4 * 4;
  }
  // the warps' slabs, CH N floats each ([j][lane][SPL]): a lane's dC slots
  // over the passes, then its dB slots for their sum over the warps; and
  // a half slab a warp for the dB slots of a segment's first L / 2 steps
  // (the rest stay in registers)
  static constexpr int SLAB = S::CH * N, HALF = L / 2;
  __host__ __device__ static constexpr int region_floats(int w) {
    return w * SLAB;
  }
  __host__ __device__ static constexpr int half_floats(int w) {
    return w * HALF * 32 * SPL;
  }
  // two stages, the region, the half slabs, each channel's carry, dA sums
  // and row of A, each lane's h before its segment (SPL floats), each
  // channel's dD sum
  __host__ __device__ static constexpr int smem_floats(int w) {
    return 2 * stage_floats(w) + region_floats(w) + half_floats(w) +
           w * K * (3 * N + 1) + w * 32 * SPL;
  }
};

// The block's shared memory (BwdTiles), computed afresh where used from
// the block's size (read volatile, so that none of it is held over the
// passes): the two stages, the warps' slabs, each channel's carry, dA sums
// and row of A, each lane's h before its segment, each channel's dD sum.
template <int N, int SPL, int L, int K>
struct Layout {
  int w_count, r_count, stage;
  float *smem, *region, *half, *carry, *da, *a, *hm, *dd;
  __device__ __forceinline__ explicit Layout(float* base) : smem(base) {
    using T = BwdTiles<N, SPL, L, K>;
    int nt;
    asm volatile("mov.u32 %0, %%ntid.x;" : "=r"(nt));
    w_count = nt >> 5;
    r_count = w_count * K;
    stage = T::stage_floats(w_count);
    region = smem + 2 * stage;
    half = region + T::region_floats(w_count);
    carry = half + T::half_floats(w_count);
    da = carry + r_count * N;
    a = da + r_count * N;
    hm = a + r_count * N;
    dd = hm + w_count * 32 * SPL;
  }
  __device__ __forceinline__ float* st(int c) const {
    return smem + (c & 1) * stage;
  }
};

// Chunk c's tiles into one stage (see BwdTiles): every thread of the block
// takes part; steps past S and channels past di are zero-filled.
template <int N, int SPL, int L, int K>
__device__ __forceinline__ void load_stage(const BwdArgs& p, float* st,
                                           int r_count, int c) {
  using S = Scan<N, SPL, L>;
  using T = BwdTiles<N, SPL, L, K>;
  const int t0 = c * S::CH, s_len = p.f.s, di = p.f.di;
  const int b = block_y_now(), ch0 = block_x_now() * r_count;
  const bool bc16 = ((reinterpret_cast<uintptr_t>(p.f.bm) |
                      reinterpret_cast<uintptr_t>(p.f.cm)) & 15) == 0;
  load_bc<N, SPL, L>(p.f, st, b, t0, bc16, tid_now());
  float* xt = st + 2 * S::BC;
  float* hct = xt + r_count * T::RP;
  // consecutive threads on consecutive channels of one step (R is a power
  // of two): 4 R contiguous bytes of each of x and dt
  for (int i = tid_now(); i < r_count * S::CH; i += blockDim.x) {
    const int r = i & (r_count - 1), t = i / r_count;
    const bool ok = ch0 + r < di && t0 + t < s_len;
    const size_t off = ok ? ((size_t)b * s_len + t0 + t) * di + ch0 + r : 0;
    float* dst = xt + r * T::RP + T::pos(t);
    cp_async4(smem_u32(dst), p.f.x + off, ok);
    cp_async4(smem_u32(dst + T::XP), p.f.dt + off, ok);
  }
  for (int i = tid_now(); i < r_count * N; i += blockDim.x) {
    const bool ok = ch0 + i / N < di;
    const size_t off =
        ok ? ((size_t)(unsigned)(b * p.nch + c) * di + ch0) * N + i : 0;
    cp_async4(smem_u32(hct + i), p.states + off, ok);
  }
  // dy is read from device memory by the passes (no room left in shared
  // memory): its rows of the R channels into L1 ahead of use
  for (int t = tid_now(); t < S::CH && t0 + t < s_len; t += blockDim.x)
    asm volatile("prefetch.global.L1 [%0];" ::"l"(
        p.dy + ((size_t)b * s_len + t0 + t) * di + ch0));
}

template <int N, int SPL, int L, int K>
__global__ void __launch_bounds__(MSB_MAX_WARPS * 32, 2)
    mamba_scan_bwd_kernel(const BwdArgs p) {
  using S = Scan<N, SPL, L>;
  using T = BwdTiles<N, SPL, L, K>;
  constexpr int LANE_F = 32 * SPL;     // floats of one step of a warp's slab
  constexpr int SLAB = T::SLAB, HALF = T::HALF;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int s_len = p.f.s, di = p.f.di;
  {
    const Layout<N, SPL, L, K> m(smem);
    const int b = blockIdx.y, ch0 = blockIdx.x * m.r_count;
    load_stage<N, SPL, L, K>(p, m.st(p.nch - 1), m.r_count, p.nch - 1);
    cp_async_commit();
    for (int i = tid_now(); i < m.r_count * N; i += blockDim.x) {
      const bool ok = p.dhT != nullptr && ch0 + i / N < di;
      m.carry[i] = ok ? p.dhT[((size_t)b * di + ch0) * N + i] : 0.0f;
      m.da[i] = 0.0f;
      m.a[i] = ch0 + i / N < di ? p.f.a[(size_t)ch0 * N + i] : 0.0f;
    }
    for (int i = tid_now(); i < m.r_count; i += blockDim.x) m.dd[i] = 0.0f;
  }

  for (int c = p.nch - 1; c >= 0; --c) {
    const int t0 = c * S::CH;
    if (c > 0) {          // the other stage was chunk c + 1's, now free
      const Layout<N, SPL, L, K> m(smem);
      load_stage<N, SPL, L, K>(p, m.st(c - 1), m.r_count, c - 1);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();                  // chunk c's tiles have landed

    // the lane's dC slots in the warp's slab, its dB slots of steps j <
    // HALF in the warp's half slab and of the later steps in registers,
    // each summed over the warp's channels
    float gub[L - HALF][SPL];
    {
      const Layout<N, SPL, L, K> m(smem);
      const float zero[SPL] = {};
      float* slab = m.region + warp_now() * SLAB + lane_now() * SPL;
      float* half = m.half + warp_now() * HALF * LANE_F + lane_now() * SPL;
#pragma unroll
      for (int j = 0; j < L; ++j) {
        st_states<SPL>(slab + j * LANE_F, zero);
        if (j < HALF) st_states<SPL>(half + j * LANE_F, zero);
      }
#pragma unroll
      for (int j = 0; j < L - HALF; ++j)
#pragma unroll
        for (int k = 0; k < SPL; ++k) gub[j][k] = 0.0f;
    }

#pragma unroll 1
    for (int kc = 0; kc < K; ++kc) {
      const Layout<N, SPL, L, K> m(smem);
      const int r = warp_now() * K + kc, ch = block_x_now() * m.r_count + r;
      if (ch >= di) break;            // warp-uniform: channels ascend
      float* st = m.st(c);
      const int lane = lane_now(), seg = lane / S::G, g = lane % S::G;
      const float* lb = st + seg * S::SS + g * SPL;
      const float* lc = lb + S::BC;
      float* my_slab = m.region + warp_now() * SLAB + lane * SPL;
      float* my_half = m.half + warp_now() * HALF * LANE_F + lane * SPL;
      float* my_hm = m.hm + warp_now() * 32 * SPL + lane * SPL;
      // x_t at lx[j SEG], dt_t one row on
      float* lx = st + 2 * S::BC + r * T::RP + seg;
      float* ldt = lx + T::XP;
      const float* hc = st + 2 * S::BC + m.r_count * T::RP + r * N + g * SPL;
      // dy_t of the lane's L steps, from device memory (0 past S)
      float dy_r[L];
      {
        const int ty = c * S::CH + seg * L;
        const float* py =
            p.dy + ((size_t)block_y_now() * s_len + ty) * di + ch;
#pragma unroll
        for (int j = 0; j < L; ++j)
          dy_r[j] = ty + j < s_len ? __ldg(py + (size_t)j * di) : 0.0f;
      }
      const float* carry = m.carry + r * N + g * SPL;
      const float* la = m.a + r * N + g * SPL;

      // A. the segment's forward maps (sa, sb; segment 0 from the chunk
      // state) and its reverse maps in forward order (ra = sa, rb), then
      // the scans over the segments: h at each segment's start (hs[0]'s
      // input), P at each segment's end (v)
      float hs[L][SPL], v[SPL];
      {
        float sa[SPL], sb[SPL], ra[SPL], rb[SPL];
#pragma unroll
        for (int k = 0; k < SPL; ++k) {
          sa[k] = 1.0f;
          sb[k] = seg == 0 ? hc[k] : 0.0f;
          rb[k] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < L; ++j) {
          const float dtj = ldt[j * S::SEG], dyj = dy_r[j];
          const float u = dtj * lx[j * S::SEG], dl = dtj * MSB_LOG2E;
          float bv[SPL], cv[SPL];
          float av[SPL];
          ld_states<SPL>(la, av);
          ld_states<SPL>(lb + j * N, bv);
          ld_states<SPL>(lc + j * N, cv);
#pragma unroll
          for (int k = 0; k < SPL; ++k) {
            const float e = ex2f(dl * av[k]);
            sa[k] = e * sa[k];
            sb[k] = fmaf(e, sb[k], u * bv[k]);
            rb[k] = fmaf(sa[k], dyj * cv[k], rb[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < SPL; ++k) {
          ra[k] = sa[k];
          if (seg == S::SEG - 1) rb[k] = fmaf(ra[k], carry[k], rb[k]);
        }
#pragma unroll
        for (int dd = 1; dd < S::SEG; dd *= 2) {
#pragma unroll
          for (int k = 0; k < SPL; ++k) {
            const float pa = __shfl_up_sync(0xffffffffu, sa[k], dd * S::G);
            const float pb = __shfl_up_sync(0xffffffffu, sb[k], dd * S::G);
            const float qa = __shfl_down_sync(0xffffffffu, ra[k], dd * S::G);
            const float qb = __shfl_down_sync(0xffffffffu, rb[k], dd * S::G);
            if (seg >= dd) {
              sb[k] = fmaf(sa[k], pb, sb[k]);
              sa[k] = sa[k] * pa;
            }
            if (seg + dd < S::SEG) {
              rb[k] = fmaf(ra[k], qb, rb[k]);
              ra[k] = ra[k] * qa;
            }
          }
        }
#pragma unroll
        for (int k = 0; k < SPL; ++k) {
          const float prev = __shfl_up_sync(0xffffffffu, sb[k], S::G);
          const float next = __shfl_down_sync(0xffffffffu, rb[k], S::G);
          hs[0][k] = seg == 0 ? hc[k] : prev;
          v[k] = seg == S::SEG - 1 ? carry[k] : next;
        }
        st_states<SPL>(my_hm, hs[0]);  // h before the segment's first step
      }

      // B. the states h_t again, kept in registers for C, and dy_t h_t
      // into the lane's dC slots
#pragma unroll
      for (int j = 0; j < L; ++j) {
        const float dtj = ldt[j * S::SEG], dyj = dy_r[j];
        const float u = dtj * lx[j * S::SEG], dl = dtj * MSB_LOG2E;
        float bv[SPL], q[SPL];
        float av[SPL];
        ld_states<SPL>(la, av);
        ld_states<SPL>(lb + j * N, bv);
        ld_states<SPL>(my_slab + j * LANE_F, q);
#pragma unroll
        for (int k = 0; k < SPL; ++k) {
          hs[j][k] = fmaf(ex2f(dl * av[k]), j ? hs[j ? j - 1 : 0][k]
                                                : hs[0][k], u * bv[k]);
          q[k] = fmaf(dyj, hs[j][k], q[k]);
        }
        st_states<SPL>(my_slab + j * LANE_F, q);
      }

      // C. the segment's steps in reverse
      float da_acc[SPL], dd_acc = 0.0f;
#pragma unroll
      for (int k = 0; k < SPL; ++k) da_acc[k] = 0.0f;
#pragma unroll
      for (int j = L - 1; j >= 0; --j) {
        const float dtj = ldt[j * S::SEG], xj = lx[j * S::SEG],
                    dyj = dy_r[j];
        const float u = dtj * xj, dl = dtj * MSB_LOG2E;
        float bv[SPL], cv[SPL];
        float av[SPL];
        ld_states<SPL>(la, av);
        ld_states<SPL>(lb + j * N, bv);
        ld_states<SPL>(lc + j * N, cv);
        float gb = 0.0f, gah = 0.0f, hm[SPL], q[SPL];
        if (j == 0) ld_states<SPL>(my_hm, hm);      // h before the segment
        if (j < HALF) ld_states<SPL>(my_half + j * LANE_F, q);
#pragma unroll
        for (int k = 0; k < SPL; ++k) {
          const float hp = j ? hs[j ? j - 1 : 0][k] : hm[k];   // h_{t-1}
          const float gk = fmaf(dyj, cv[k], v[k]);           // G_t
          const float pk = ex2f(dl * av[k]) * gk;            // P_t
          gb = fmaf(gk, bv[k], gb);
          gah = fmaf(pk * av[k], hp, gah);
          da_acc[k] = fmaf(pk * dtj, hp, da_acc[k]);
          if (j < HALF)
            q[k] = fmaf(gk, u, q[k]);
          else
            gub[j >= HALF ? j - HALF : 0][k] =
                fmaf(gk, u, gub[j >= HALF ? j - HALF : 0][k]);
          v[k] = pk;
        }
        if (j < HALF) st_states<SPL>(my_half + j * LANE_F, q);
#pragma unroll
        for (int o = 1; o < S::G; o *= 2) {
          gb += __shfl_xor_sync(0xffffffffu, gb, o);
          gah += __shfl_xor_sync(0xffffffffu, gah, o);
        }
        __syncwarp();                 // every lane has read x_t, dt_t
        if (g == 0) {
          lx[j * S::SEG] = dtj * gb;           // dx_t less D dy_t, over x_t
          ldt[j * S::SEG] = fmaf(xj, gb, gah);             // ddt_t over dt_t
          dd_acc = fmaf(dyj, xj, dd_acc);
        }
      }
      // the chunk's dA and dD over the segments into the channel's sums;
      // P at the chunk's start (segment 0) is the next chunk's carry
#pragma unroll
      for (int o = S::G; o < 32; o *= 2) {
#pragma unroll
        for (int k = 0; k < SPL; ++k)
          da_acc[k] += __shfl_xor_sync(0xffffffffu, da_acc[k], o);
        dd_acc += __shfl_xor_sync(0xffffffffu, dd_acc, o);
      }
      if (seg == 0) {
        const Layout<N, SPL, L, K> m2(smem);
#pragma unroll
        for (int k = 0; k < SPL; ++k) {
          m2.da[r * N + g * SPL + k] += da_acc[k];
          m2.carry[r * N + g * SPL + k] = v[k];
        }
        if (g == 0) m2.dd[r] += dd_acc;
      }
    }
    __syncthreads();                  // the passes are done

    const Layout<N, SPL, L, K> m(smem);
    const int r_count = m.r_count, ch0 = block_x_now() * r_count;
    // dx (D dy_t added here) and ddt of the chunk, from the stage's rows
    {
      const float* xt = m.st(c) + 2 * S::BC;
      for (int i = tid_now(); i < r_count * S::CH; i += blockDim.x) {
        const int r = i & (r_count - 1), t = i / r_count;
        if (ch0 + r < di && t0 + t < s_len) {
          const size_t o =
              ((size_t)block_y_now() * s_len + t0 + t) * di + ch0 + r;
          const int src = r * T::RP + T::pos(t);
          p.dx[o] = fmaf(p.f.d[ch0 + r], __ldg(p.dy + o), xt[src]);
          p.ddt[o] = xt[src + T::XP];
        }
      }
    }
    // dC, then dB: the warps' slabs summed in order, one partial a block
    float* part = p.dc_part;
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {
      if (pass == 1) {
        __syncthreads();              // the dC slabs are read
        float* slab = m.region + warp_now() * SLAB + lane_now() * SPL;
        const float* half =
            m.half + warp_now() * HALF * LANE_F + lane_now() * SPL;
#pragma unroll
        for (int j = 0; j < L; ++j) {
          float q[SPL];
          if (j < HALF)
            ld_states<SPL>(half + j * LANE_F, q);
#pragma unroll
          for (int k = 0; k < SPL; ++k)
            if (j >= HALF) q[k] = gub[j >= HALF ? j - HALF : 0][k];
          st_states<SPL>(slab + j * LANE_F, q);
        }
        __syncthreads();
        part = p.db_part;
      }
      for (int i = tid_now(); i < SLAB; i += blockDim.x) {
        const int k = i % SPL, ln = (i / SPL) & 31, j = i / LANE_F;
        const int t = (ln / S::G) * L + j, n = (ln % S::G) * SPL + k;
        float sum = m.region[i];
        for (int ww = 1; ww < m.w_count; ++ww) sum += m.region[ww * SLAB + i];
        if (t0 + t < s_len)
          part[(((size_t)block_y_now() * p.nbx + block_x_now()) * s_len +
                t0 + t) * N + n] =
              sum;
      }
    }
  }
  // each channel's dA and dD sums (this batch row's partials) and dh0 =
  // P_0 (the last chunk's passes wrote them before its barriers)
  const Layout<N, SPL, L, K> m(smem);
  const int b = blockIdx.y, ch0 = blockIdx.x * m.r_count;
  for (int i = tid_now(); i < m.r_count * N; i += blockDim.x) {
    if (ch0 + i / N < di) {
      const size_t o = ((size_t)b * di + ch0) * N + i;
      p.da_part[o] = m.da[i];
      if (p.dh0) p.dh0[o] = m.carry[i];
    }
  }
  for (int i = tid_now(); i < m.r_count; i += blockDim.x)
    if (ch0 + i < di) p.dd_part[(size_t)b * di + ch0 + i] = m.dd[i];
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

// The reverse-scan kernel of an instance with its shared memory set: the
// dynamic bytes, and the carveout at its most, so that two blocks fit.
template <int N, int SPL, int L, int K>
static int prepare(int warps, const void** fn, int* bytes) {
  *fn = (const void*)mamba_scan_bwd_kernel<N, SPL, L, K>;
  *bytes = (int)sizeof(float) * BwdTiles<N, SPL, L, K>::smem_floats(warps);
  cudaError_t e = cudaFuncSetAttribute(
      mamba_scan_bwd_kernel<N, SPL, L, K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(mamba_scan_bwd_kernel<N, SPL, L, K>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  return e == cudaSuccess
             ? 0
             : launch_fail((int)e, "reverse scan: %d bytes of shared memory "
                           "refused: %s", *bytes, cudaGetErrorString(e));
}

// The instances (SCAN_BWD_BUILT in kernels/mamba_scan.py): the forward's
// (SPL, L) for each N, each at the K its plan may take.
#define MSB_INSTANCES(X)                                                 \
  X(4, 2, 2, 1) X(8, 4, 2, 1) X(16, 4, 4, 1) X(4, 2, 8, 1) X(4, 2, 8, 2) \
      X(8, 4, 8, 1) X(8, 4, 8, 2) X(16, 4, 8, 1) X(16, 4, 8, 2)          \
          X(16, 4, 8, 4)

// Each instance's shared bytes at 8 warps, as the plan computes them
// (ScanBwdPlan.shared_bytes; tests/test_torch_scan_plan.py reads these).
static_assert(sizeof(float) * BwdTiles<4, 2, 2, 1>::smem_floats(8) ==
                  22240,
              "ScanBwdPlan.shared_bytes");
static_assert(sizeof(float) * BwdTiles<8, 4, 2, 1>::smem_floats(8) ==
                  32096,
              "ScanBwdPlan.shared_bytes");
static_assert(sizeof(float) * BwdTiles<16, 4, 4, 1>::smem_floats(8) ==
                  45664,
              "ScanBwdPlan.shared_bytes");
static_assert(sizeof(float) * BwdTiles<4, 2, 8, 1>::smem_floats(8) ==
                  52960,
              "ScanBwdPlan.shared_bytes");
static_assert(sizeof(float) * BwdTiles<4, 2, 8, 2>::smem_floats(8) ==
                  70080,
              "ScanBwdPlan.shared_bytes");
static_assert(sizeof(float) * BwdTiles<8, 4, 8, 1>::smem_floats(8) ==
                  89440,
              "ScanBwdPlan.shared_bytes");
static_assert(sizeof(float) * BwdTiles<8, 4, 8, 2>::smem_floats(8) ==
                  107200,
              "ScanBwdPlan.shared_bytes");
static_assert(sizeof(float) * BwdTiles<16, 4, 8, 1>::smem_floats(8) ==
                  82528,
              "ScanBwdPlan.shared_bytes");
static_assert(sizeof(float) * BwdTiles<16, 4, 8, 2>::smem_floats(8) ==
                  93376,
              "ScanBwdPlan.shared_bytes");
static_assert(sizeof(float) * BwdTiles<16, 4, 8, 4>::smem_floats(8) ==
                  115072,
              "ScanBwdPlan.shared_bytes");

static int prepare_plan(int n, int states, int seg_len, int per_warp,
                        int warps, const void** fn, int* bytes) {
#define MSB_CASE(NN, SS, LL, KK)                                        \
  if (n == NN && states == SS && seg_len == LL && per_warp == KK) \
    return prepare<NN, SS, LL, KK>(warps, fn, bytes);
  MSB_INSTANCES(MSB_CASE)
#undef MSB_CASE
  return launch_fail((int)cudaErrorInvalidValue, "no instance for (N, SPL, "
                     "L, K) = (%d, %d, %d, %d)", n, states, seg_len,
                     per_warp);
}

// Blocks of the plan's instance that fit one SM at once (the runtime's
// occupancy calculator), into *blocks; returns 0 or a CUDA error.
extern "C" int mamba_scan_bwd_occupancy(int n, int states, int seg_len,
                                        int per_warp, int warps,
                                        int* blocks) {
  const LaunchScope scope;
  const void* fn;
  int bytes, err;
  if ((err = prepare_plan(n, states, seg_len, per_warp, warps, &fn, &bytes)))
    return err;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, warps * 32, bytes);
  return e == cudaSuccess
             ? 0
             : launch_fail((int)e, "occupancy: %s", cudaGetErrorString(e));
}

// One backward call: the reverse scan on the plan (states SPL, seg_len L,
// per_warp K, warps W, grid) and the reduction kernel on `reduce_blocks`
// blocks of 256 threads; returns a CUDA error code (0 = launched).  dhT
// and dh0 may be null.  The partials are (B, grid_x, S, N) each, (B, di,
// N) and (B, di).
extern "C" int mamba_scan_bwd_launch(
    const void* x, const void* dt, const void* a, const void* bm,
    const void* cm, const void* d, const void* chunk_states, const void* dy,
    const void* dhT, void* dx, void* ddt, void* db_part, void* dc_part,
    void* da_part, void* dd_part, void* dh0, void* db, void* dc, void* da,
    void* dd, int bsz, int s, int di, int n, int states, int seg_len,
    int per_warp, int warps, int grid_x, int grid_y, int reduce_blocks,
    void* stream) {
  const LaunchScope scope;
  const long long rows = (long long)warps * per_warp;
  const bool ok = bsz >= 1 && s >= 1 && di >= 1 && warps >= 1 &&
                  warps <= MSB_MAX_WARPS && (warps & (warps - 1)) == 0 &&
                  grid_y == bsz && grid_y <= 65535 &&
                  (long long)grid_x * rows >= di &&
                  (long long)(grid_x - 1) * rows < di && reduce_blocks >= 1;
  if (!ok)
    return launch_fail((int)cudaErrorInvalidValue, "plan (W %d, K %d, grid "
                       "%d x %d) does not cover B %d x di %d", warps,
                       per_warp, grid_x, grid_y, bsz, di);
  const void* fn;
  int bytes, err;
  if ((err = prepare_plan(n, states, seg_len, per_warp, warps, &fn, &bytes)))
    return err;
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
  const int chunk = 32 / (n / states) * seg_len;     // Scan<N, SPL, L>::CH
  p.nch = (s + chunk - 1) / chunk;
  void* kargs[] = {&p};
  const cudaError_t e =
      cudaLaunchKernel(fn, dim3(grid_x, grid_y), dim3(warps * 32), kargs,
                       (size_t)bytes, (cudaStream_t)stream);
  if (e != cudaSuccess)
    return launch_fail((int)e, "reverse scan launch: %s",
                       cudaGetErrorString(e));
  mamba_scan_bwd_reduce_kernel<<<reduce_blocks, 256, 0,
                                 (cudaStream_t)stream>>>(
      (const float*)db_part, (const float*)dc_part, (const float*)da_part,
      (const float*)dd_part, (float*)db, (float*)dc, (float*)da, (float*)dd,
      bsz, s, di, n, grid_x);
  return launch_check("sums launch");
}
