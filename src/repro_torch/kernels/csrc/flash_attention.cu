// Blocked online-softmax attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (function at :77, pallas_call at
// :120): o = softmax(q k^T / sqrt(D)) v over q (B, Sq, Hq, D) and
// k, v (B, Skv, Hkv, D) in that layout, float32 or bfloat16, GQA groups of
// Hq / Hkv query heads per key/value head, under `causal` the diagonal at
// Skv - Sq, and the output acc / max(l, 1e-30) in q's dtype.  Scores,
// exponentials and sums are float32 in both dtypes.  Its callers are the
// "attention" policy class (one launch scores a whole daemon batch,
// (B pods, N candidate nodes, 2 heads, D = 8), float32) and the LM prefill
// (one launch per attention layer, (B, S, Hq, 128), bfloat16).
//
// Design.  The TPU kernel walks key blocks in the sequential last grid
// axis and carries (m, l, acc) in VMEM scratch.  Here a block of 128
// threads holds 128 / LANES query rows of one (batch, head): LANES threads
// per row, each with D / LANES dims of q and acc, m and l in registers
// (LANES = 1 up to D = 64; at D = 128 four lanes, so q and acc stay at 32
// floats a thread and do not spill, and the partial dot products are summed
// by two __shfl_xor_sync).  The key loop runs inside the block: tiles of
// k and v are staged in shared memory in the input's dtype with 16-byte
// loads (every row group reads the same key, so the loads broadcast),
// scored 16 keys at a time into registers, and folded into the running
// softmax once per 16 keys.  The kernel computes its own offsets, so no
// transpose precedes it; ragged Sq and Skv are masked by index (no
// block-size divisibility, unlike the TPU kernel's assert); under
// `causal`, tiles wholly above the block's last diagonal are skipped, as
// the TPU kernel's `run` guard does.  Scores are kept in base 2 (q k^T
// scaled by log2(e) / sqrt(D), exp2f), which is the same softmax up to
// rounding.  Everything is float32 FMAs on CUDA cores, no TF32.  With
// LANES = 1 and float32 the instructions, and so the results, are those of
// the float32-only kernel this one grew from.
//
// What bounds it.  Per (query, key) pair 4D + 5 operations (QK, PV, the
// scale, max, subtract, exp and sum): at the policy path's shape
// (32, 5000, 2, 8) 1.6e9 pairs and ~59 GFLOP, ~0.88 ms at 67 TFLOP/s,
// against ~41 MB moved (~0.012 ms): operations bound.  At the LM prefill
// (8, 512, 16, 128) bfloat16, causal, the two products are ~34 GFLOP,
// ~0.035 ms on the bf16 tensor cores, against 33.6 MB (~0.010 ms).  The
// design issues float32 FMAs (and, in bfloat16, a conversion per element
// read from shared memory) on CUDA cores; tensor cores (mma.sync / wgmma)
// would lift that ceiling and are later work.  Rows where Sq is not a
// multiple of the block's rows leave threads idle in the last block of
// each (batch, head).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FA_THREADS 128   // threads per block
#define FA_CHUNK 16      // keys scored into registers per softmax update
#define FA_TILE_BYTES 16384   // bytes of k (and as many of v) per tile

// 16 bytes of T as floats
__device__ __forceinline__ void unpack(const uint4& t, float* x, float) {
  const float4 f = *reinterpret_cast<const float4*>(&t);
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}

__device__ __forceinline__ void unpack(const uint4& t, float* x,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// floats as 16 bytes of T
__device__ __forceinline__ uint4 pack(const float* x, float) {
  const float4 f = make_float4(x[0], x[1], x[2], x[3]);
  return *reinterpret_cast<const uint4*>(&f);
}

__device__ __forceinline__ uint4 pack(const float* x, __nv_bfloat16) {
  uint4 t;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  return t;
}

template <typename T, int D, int LANES>
__global__ void __launch_bounds__(FA_THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int sq, int skv, int hq,
    int hkv, int causal, float scale_log2) {
  constexpr int VEC = 16 / sizeof(T);            // elements per 16 bytes
  constexpr int ROW16 = D / VEC;                 // 16-byte words per row
  constexpr int DL = D / LANES;                  // dims a lane owns
  constexpr int NV = DL / VEC;                   // its 16-byte words
  constexpr int ROWS = FA_THREADS / LANES;       // query rows per block
  constexpr int TILE_RAW = FA_TILE_BYTES / (D * (int)sizeof(T));
  constexpr int TILE_K = TILE_RAW < 64 ? TILE_RAW : 64;
  static_assert(NV >= 1 && DL % VEC == 0, "a lane owns whole 16-byte words");
  static_assert(TILE_K % FA_CHUNK == 0, "tile is whole chunks");
  __shared__ uint4 s_k[TILE_K][ROW16];
  __shared__ uint4 s_v[TILE_K][ROW16];
  const int b = blockIdx.x / hq;
  const int h = blockIdx.x - b * hq;
  const int hk = h / (hq / hkv);
  const int row0 = blockIdx.y * ROWS;
  const int row = row0 + threadIdx.x / LANES;
  const int part = threadIdx.x % LANES;          // the lane's slice of D
  const bool live = row < sq;
  const int diag = skv - sq;
  // keys this row sees; and keys any row of the block sees (the loop bound)
  const int my_end = !live ? 0 : causal ? min(skv, row + diag + 1) : skv;
  const int blk_end =
      causal ? min(skv, min(sq, row0 + ROWS) - 1 + diag + 1) : skv;
  // the lanes of one row: they share my_end, so they run the same chunks
  const unsigned gmask =
      LANES == 1 ? 1u
                 : ((1u << LANES) - 1u) << ((threadIdx.x & 31) & ~(LANES - 1));

  float qr[DL], acc[DL];
  const size_t qoff =
      (((size_t)b * sq + (live ? row : 0)) * hq + h) * D + part * DL;
  const T zero_t = T();
#pragma unroll
  for (int c = 0; c < NV; ++c)
    unpack(reinterpret_cast<const uint4*>(q + qoff)[c], qr + c * VEC, zero_t);
#pragma unroll
  for (int d = 0; d < DL; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  const size_t kstride = (size_t)hkv * D;       // between consecutive keys
  const T* kb = k + ((size_t)b * skv * hkv + hk) * D;
  const T* vb = v + ((size_t)b * skv * hkv + hk) * D;
  for (int t0 = 0; t0 < blk_end; t0 += TILE_K) {
    __syncthreads();                            // the last tile is consumed
    for (int i = threadIdx.x; i < TILE_K * ROW16; i += FA_THREADS) {
      const int j = i / ROW16, c = i - j * ROW16;
      const int key = t0 + j;
      uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
      if (key < skv) {
        kk = reinterpret_cast<const uint4*>(kb + key * kstride)[c];
        vv = reinterpret_cast<const uint4*>(vb + key * kstride)[c];
      }
      s_k[j][c] = kk;
      s_v[j][c] = vv;
    }
    __syncthreads();
    const int nk = min(TILE_K, my_end - t0);     // <= 0: nothing visible
    for (int c0 = 0; c0 < nk; c0 += FA_CHUNK) {
      float s[FA_CHUNK];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < FA_CHUNK; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          float kf[VEC];
          unpack(s_k[c0 + j][part * NV + c], kf, zero_t);
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot = fmaf(qr[c * VEC + e], kf[e], dot);
        }
#pragma unroll
        for (int off = 1; off < LANES; off <<= 1)
          dot += __shfl_xor_sync(gmask, dot, off);
        s[j] = (c0 + j < nk) ? dot * scale_log2 : -INFINITY;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = exp2f(m - m_new);      // 0 on the first update
      l *= corr;
#pragma unroll
      for (int d = 0; d < DL; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < FA_CHUNK; ++j) {
        const float p = exp2f(s[j] - m_new);     // NaN scores stay NaN
        l += p;
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          float vf[VEC];
          unpack(s_v[c0 + j][part * NV + c], vf, zero_t);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[c * VEC + e] = fmaf(p, vf[e], acc[c * VEC + e]);
        }
      }
      m = m_new;
    }
  }
  if (!live) return;
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    float out[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = acc[c * VEC + e] / den;
    reinterpret_cast<uint4*>(o + qoff)[c] = pack(out, zero_t);
  }
}

template <typename T, int D, int LANES>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int b, int sq, int skv, int hq, int hkv, int causal,
                  float scale_log2, cudaStream_t stream) {
  constexpr int ROWS = FA_THREADS / LANES;
  const dim3 grid(b * hq, (sq + ROWS - 1) / ROWS);
  flash_attention_kernel<T, D, LANES><<<grid, FA_THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, skv, hq, hkv, causal,
      scale_log2);
  return (int)cudaGetLastError();
}

template <typename T>
static int by_dim(const void* q, const void* k, const void* v, void* o, int b,
                  int sq, int skv, int hq, int hkv, int d, int causal,
                  float sl, cudaStream_t st) {
  switch (d) {
    case 8: return launch<T, 8, 1>(q, k, v, o, b, sq, skv, hq, hkv, causal, sl, st);
    case 16: return launch<T, 16, 1>(q, k, v, o, b, sq, skv, hq, hkv, causal, sl, st);
    case 32: return launch<T, 32, 1>(q, k, v, o, b, sq, skv, hq, hkv, causal, sl, st);
    case 64: return launch<T, 64, 1>(q, k, v, o, b, sq, skv, hq, hkv, causal, sl, st);
    case 128: return launch<T, 128, 4>(q, k, v, o, b, sq, skv, hq, hkv, causal, sl, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype 0: float32, 1: bfloat16.  Rows per block: 128 up to D = 64, 32 at
// D = 128 (rows_per_block() in kernels/flash_attention.py).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int sq,
                                      int skv, int hq, int hkv, int d,
                                      int causal, int dtype, void* stream) {
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)d));
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return by_dim<float>(q, k, v, o, b, sq, skv, hq, hkv, d, causal, scale_log2, st);
  if (dtype == 1)
    return by_dim<__nv_bfloat16>(q, k, v, o, b, sq, skv, hq, hkv, d, causal, scale_log2, st);
  return (int)cudaErrorInvalidValue;
}
