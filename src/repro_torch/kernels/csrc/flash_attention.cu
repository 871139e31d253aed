// Blocked online-softmax attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (function at :77, pallas_call at
// :120): o = softmax(q k^T / sqrt(D)) v over float32 q (B, Sq, Hq, D) and
// k, v (B, Skv, Hkv, D) in that layout, GQA groups of Hq / Hkv query heads
// per key/value head, under `causal` the diagonal at Skv - Sq, and the
// output acc / max(l, 1e-30).  Its caller on the serving path is the
// "attention" policy class: one launch scores a whole daemon batch,
// (B pods, N candidate nodes, 2 heads, D = 8).
//
// Design.  The TPU kernel walks key blocks in the sequential last grid
// axis and carries (m, l, acc) in VMEM scratch.  Here a block holds 128
// query rows of one (batch, head), ONE THREAD PER ROW with q[D], acc[D],
// m and l in registers, and the key loop runs inside the block: tiles of
// 64 keys of k and v are staged in shared memory (every thread reads the
// same key, so the loads broadcast), scored 16 at a time into registers,
// and folded into the running softmax once per 16 keys.  The kernel
// computes its own offsets, so no transpose precedes it; ragged Sq and Skv
// are masked by index (no block-size divisibility, unlike the TPU
// kernel's assert); under `causal`, tiles wholly above the block's last
// diagonal are skipped, as the TPU kernel's `run` guard does.  Scores are
// kept in base 2 (q k^T scaled by log2(e) / sqrt(D), exp2f), which is the
// same softmax up to rounding.  Everything is float32 FMAs, no TF32: the
// reference accumulates in float32.
//
// What bounds it.  Per (query, key) pair 4D + 5 operations (QK, PV, the
// scale, max, subtract, exp and sum): at the policy path's shape
// (32, 5000, 2, 8) 1.6e9 pairs and ~59 GFLOP, ~0.88 ms at 67 TFLOP/s,
// against ~41 MB moved (~0.012 ms): operations bound.  The design issues
// float32 FMAs from registers against broadcast shared-memory reads;
// tensor cores (mma.sync / wgmma) would lift that ceiling and are later
// work.  Rows where Sq is not a multiple of 128 leave threads idle in the
// last block of each (batch, head).

#include <cuda_runtime.h>
#include <math.h>

#define FA_BLOCK_Q 128   // query rows per block, one per thread
#define FA_TILE_K 64     // keys of k and v staged in shared memory per step
#define FA_CHUNK 16      // keys scored into registers per softmax update

template <int D>
__global__ void __launch_bounds__(FA_BLOCK_Q) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int sq, int skv,
    int hq, int hkv, int causal, float scale_log2) {
  constexpr int D4 = D / 4;
  __shared__ float4 s_k[FA_TILE_K][D4];
  __shared__ float4 s_v[FA_TILE_K][D4];
  const int b = blockIdx.x / hq;
  const int h = blockIdx.x - b * hq;
  const int hk = h / (hq / hkv);
  const int row0 = blockIdx.y * FA_BLOCK_Q;
  const int row = row0 + threadIdx.x;
  const bool live = row < sq;
  const int diag = skv - sq;
  // keys this row sees; and keys any row of the block sees (the loop bound)
  const int my_end = !live ? 0 : causal ? min(skv, row + diag + 1) : skv;
  const int blk_end =
      causal ? min(skv, min(sq, row0 + FA_BLOCK_Q) - 1 + diag + 1) : skv;

  float qr[D], acc[D];
  const size_t qoff = (((size_t)b * sq + (live ? row : 0)) * hq + h) * D;
#pragma unroll
  for (int c = 0; c < D4; ++c) {
    const float4 t = reinterpret_cast<const float4*>(q + qoff)[c];
    qr[4 * c] = t.x;
    qr[4 * c + 1] = t.y;
    qr[4 * c + 2] = t.z;
    qr[4 * c + 3] = t.w;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = -INFINITY, l = 0.f;

  const size_t kstride = (size_t)hkv * D;       // between consecutive keys
  const float* kb = k + ((size_t)b * skv * hkv + hk) * D;
  const float* vb = v + ((size_t)b * skv * hkv + hk) * D;
  for (int t0 = 0; t0 < blk_end; t0 += FA_TILE_K) {
    __syncthreads();                            // the last tile is consumed
    for (int i = threadIdx.x; i < FA_TILE_K * D4; i += FA_BLOCK_Q) {
      const int j = i / D4, c = i - j * D4;
      const int key = t0 + j;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (key < skv) {
        kk = reinterpret_cast<const float4*>(kb + key * kstride)[c];
        vv = reinterpret_cast<const float4*>(vb + key * kstride)[c];
      }
      s_k[j][c] = kk;
      s_v[j][c] = vv;
    }
    __syncthreads();
    const int nk = min(FA_TILE_K, my_end - t0);  // <= 0: nothing visible
    for (int c0 = 0; c0 < nk; c0 += FA_CHUNK) {
      float s[FA_CHUNK];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < FA_CHUNK; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < D4; ++c) {
          const float4 kk = s_k[c0 + j][c];
          dot = fmaf(qr[4 * c], kk.x, dot);
          dot = fmaf(qr[4 * c + 1], kk.y, dot);
          dot = fmaf(qr[4 * c + 2], kk.z, dot);
          dot = fmaf(qr[4 * c + 3], kk.w, dot);
        }
        s[j] = (c0 + j < nk) ? dot * scale_log2 : -INFINITY;
        cmax = fmaxf(cmax, s[j]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = exp2f(m - m_new);      // 0 on the first update
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < FA_CHUNK; ++j) {
        const float p = exp2f(s[j] - m_new);     // NaN scores stay NaN
        l += p;
#pragma unroll
        for (int c = 0; c < D4; ++c) {
          const float4 vv = s_v[c0 + j][c];
          acc[4 * c] = fmaf(p, vv.x, acc[4 * c]);
          acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
        }
      }
      m = m_new;
    }
  }
  if (!live) return;
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < D4; ++c) {
    reinterpret_cast<float4*>(o + qoff)[c] =
        make_float4(acc[4 * c] / den, acc[4 * c + 1] / den,
                    acc[4 * c + 2] / den, acc[4 * c + 3] / den);
  }
}

template <int D>
static void launch(const float* q, const float* k, const float* v, float* o,
                   int b, int sq, int skv, int hq, int hkv, int causal,
                   float scale_log2, cudaStream_t stream) {
  const dim3 grid(b * hq, (sq + FA_BLOCK_Q - 1) / FA_BLOCK_Q);
  flash_attention_kernel<D><<<grid, FA_BLOCK_Q, 0, stream>>>(
      q, k, v, o, sq, skv, hq, hkv, causal, scale_log2);
}

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int sq,
                                      int skv, int hq, int hkv, int d,
                                      int causal, void* stream) {
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)d));
  const float* qf = (const float*)q;
  const float* kf = (const float*)k;
  const float* vf = (const float*)v;
  float* of = (float*)o;
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 8: launch<8>(qf, kf, vf, of, b, sq, skv, hq, hkv, causal, scale_log2, st); break;
    case 16: launch<16>(qf, kf, vf, of, b, sq, skv, hq, hkv, causal, scale_log2, st); break;
    case 32: launch<32>(qf, kf, vf, of, b, sq, skv, hq, hkv, causal, scale_log2, st); break;
    case 64: launch<64>(qf, kf, vf, of, b, sq, skv, hq, hkv, causal, scale_log2, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
