// Kernel 6's pieces shared by its forward (mamba_scan.cu) and its backward
// (mamba_scan_bwd.cu): cp.async copies, the chunk geometry `Scan` of a
// launch plan (kernels/mamba_scan.py `scan_plan`), the arguments and the
// load of one chunk's tiles into shared memory.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MS_MAX_WARPS 16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 4 or 16 bytes global -> shared; zero-filled when !full
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int N, int SPL, int L>
struct Scan {
  static constexpr int G = N / SPL;      // lanes a step
  static constexpr int SEG = 32 / G;     // segments a warp
  static constexpr int CH = SEG * L;     // steps a chunk
  static_assert(G >= 1 && G <= 32 && 32 % G == 0, "lanes a step");
  // The B and C tiles hold a segment's L rows of N floats at a stride of
  // SS floats, SS = N (mod 32): the 32 / N segments whose states one
  // shared-memory wavefront serves then fall on disjoint banks (at SS =
  // L N they would share them, up to 8-way).  SS is a multiple of 4, so a
  // lane's SPL states load as one vector.
  static constexpr int SS = L * N + ((N * (1 - L)) % 32 + 32) % 32;
  static constexpr int BC = SEG * SS;    // floats of a B or C tile
  static constexpr int TP = CH + 1;      // pitch of a channel's row in the
                                         // x, dt and y tiles (odd: fewer
                                         // bank conflicts)

  // floats of one buffer for W warps: the B and C tiles, then x and dt
  // (W x TP each), rounded up to 16 bytes; of the whole block: two
  // buffers and the y tile (W x TP)
  __host__ __device__ static constexpr int buf_floats(int w) {
    return (2 * BC + 2 * w * TP + 3) / 4 * 4;
  }
  __host__ __device__ static constexpr int smem_floats(int w) {
    return 2 * buf_floats(w) + w * TP;
  }
};

// SPL consecutive floats from 4 * SPL-byte aligned shared memory
template <int SPL>
__device__ __forceinline__ void ld_states(const float* p, float (&v)[SPL]) {
  if constexpr (SPL == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (SPL == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < SPL; ++k) v[k] = p[k];
  }
}

struct ScanArgs {
  const float *x, *dt, *a, *bm, *cm, *d, *h0;
  float *y, *hT;
  float* states;   // (B, chunks, di, N) chunk-start states, or null
  int s, di;
};

// The B and C rows of the chunk starting at step t0 into tiles `sb` and
// `sb + BC`, as [segment][j][n] (Scan::SS), by every thread of the block
// (`tid` its index): in 16-byte pieces where both are 16-byte aligned,
// else in floats.  Steps past S are zero-filled.
template <int N, int SPL, int L>
__device__ __forceinline__ void load_bc(const ScanArgs& p, float* sb, int b,
                                        int t0, bool bc16,
                                        int tid = threadIdx.x) {
  using S = Scan<N, SPL, L>;
  float* sc = sb + S::BC;
  const size_t row0 = ((size_t)b * p.s + t0) * N;
  const int nthr = blockDim.x;
  if (bc16) {
    for (int q = tid; q < S::CH * N / 4; q += nthr) {
      const int t = q / (N / 4), seg = t / L;
      const int dst = seg * S::SS + (t - seg * L) * N + 4 * q - t * N;
      const bool ok = t0 + t < p.s;
      const size_t off = ok ? row0 + 4 * q : 0;
      cp_async16(smem_u32(sb + dst), p.bm + off, ok);
      cp_async16(smem_u32(sc + dst), p.cm + off, ok);
    }
  } else {
    for (int i = tid; i < S::CH * N; i += nthr) {
      const int t = i / N, seg = t / L;
      const int dst = seg * S::SS + (t - seg * L) * N + i - t * N;
      const bool ok = t0 + t < p.s;
      const size_t off = ok ? row0 + i : 0;
      cp_async4(smem_u32(sb + dst), p.bm + off, ok);
      cp_async4(smem_u32(sc + dst), p.cm + off, ok);
    }
  }
}

// The chunk starting at step t0 into one buffer: B, C as [segment][j][n]
// (load_bc), x, dt as [w][t].  Every thread of the block takes part: the
// x and dt elements of channel w_ld at steps t_ld, t_ld + 32, ... (the
// block's 32 W threads cover 32 steps of W channels a pass), and the B
// and C rows.  Steps past S and channels past di are zero-filled.
template <int N, int SPL, int L>
__device__ __forceinline__ void load_chunk(const ScanArgs& p, float* buf,
                                           int w_count, int b, int ch0,
                                           int t0, int w_ld, int t_ld,
                                           bool bc16) {
  using S = Scan<N, SPL, L>;
  float* sx = buf + 2 * S::BC;
  float* sdt = sx + w_count * S::TP;
  const bool ch_ok = ch0 + w_ld < p.di;
#pragma unroll
  for (int t = t_ld; t < S::CH; t += 32) {
    const bool ok = ch_ok && t0 + t < p.s;
    const size_t off =
        ok ? ((size_t)b * p.s + t0 + t) * p.di + ch0 + w_ld : 0;
    cp_async4(smem_u32(sx + w_ld * S::TP + t), p.x + off, ok);
    cp_async4(smem_u32(sdt + w_ld * S::TP + t), p.dt + off, ok);
  }
  load_bc<N, SPL, L>(p, buf, b, t0, bc16);
}
