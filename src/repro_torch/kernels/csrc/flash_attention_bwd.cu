// Blocked attention backward for Hopper (sm_90a): dQ, dK and dV of kernel
// 7's o = softmax(q k^T / sqrt(D)) v.
//
// Replaces no Pallas kernel: the JAX model trains through XLA's autodiff
// of its attention (src/repro/models/layers.py:124, no custom_vjp), while
// the port runs every training attention through kernel 7
// (flash_attention.cu), whose raw launch carries no gradient.  This is
// the backward of that launch, bound by kernels/flash_attention.py's
// autograd Function.  Layouts as the forward's: q, o, dO (B, Sq, Hq, D),
// k, v (B, Skv, Hkv, D), GQA groups of Hq / Hkv query heads, under
// `causal` the diagonal at Skv - Sq; ragged Sq and Skv masked by index;
// lse (B, Hq, Sq) float32, the forward's natural-log log-sum-exp of each
// row's scaled scores; D in {64, 128}; bfloat16 or float32.
//
// Design (FlashAttention-2's backward order, two kernels, no atomics, so
// a step's gradients repeat bit for bit).  P is recomputed from the saved
// lse, P = exp(q k / sqrt(D) - lse), and with Delta = rowsum(dO o),
// dS = P (dO v^T - Delta):
//   * the dQ kernel, one block per (batch, query head, 64 query rows), 16
//     a warp, first computes Delta of its rows from o and dO and stores it
//     (delta, (B, Hq, Sq) float32), then walks the K/V tiles its rows see
//     and sums dQ += dS k / sqrt(D) in registers;
//   * the dK/dV kernel, launched after it on the same stream, one block
//     per (batch, KV head, 64 keys), 16 a warp, walks every query head of
//     its group and every Q/dO tile that sees its keys, recomputes P^T and
//     dS^T on its keys' rows and sums dV += P^T dO and dK += dS^T q /
//     sqrt(D): a group's sum stays in registers.
// bfloat16 runs its products (three a tile in the dQ kernel, four in the
// dK/dV kernel) on mma.sync.m16n8k16 (float32 accumulators, fragments from
// ldmatrix, tiles in shared memory by 16-byte cp.async with the next
// tile's copy in flight), P and dS rounded to bfloat16 as the A operand of
// the next product, as the forward rounds P.
// float32 runs on FMAs from shared memory (rows padded by one float, so
// the dot products read without bank conflicts); no path trains in
// float32 at speed, the instance holds the bfloat16 one to an exact
// reference.  Key blocks run heaviest first under `causal` (the first
// keys are seen by the most queries).
//
// What bounds it (chip_smoke.py's attention bound for the backward: the
// larger of the bytes, q, k, v, o, dO read and dq, dk, dv written once,
// and the five products over the visible pairs at the bf16 tensor-core
// rate).  At OLMo-1B's training shape (8, 512, 16, 128), causal: 134 MB
// (0.040 ms at 3.35 TB/s) against 21.5 GFLOP (0.022 ms at 989 TFLOP/s):
// bytes.  The two-kernel split recomputes S and dP in both (seven
// products, not five) and reads q, k, v, dO twice; mma.sync, not wgmma.

#include <math.h>

#include "mma_tiles.cuh"

#define FB_THREADS 128   // 4 warps
#define FB_ROWS 64       // rows a block of either kernel, 16 a warp
#define FB_TILE 32       // keys (dQ) or queries (dK/dV) a streamed tile
#define FB_LOG2E 1.4426950408889634f

// bf16 tile rows: an odd number of 16-byte chunks (ldmatrix without bank
// conflicts), as the forward's
template <int D>
struct Bf16Tiles {
  static constexpr int PITCH = 16 * ((D / 8) | 1);
  // dQ: Q and dO tiles of FB_ROWS rows, a 2-stage ring of K and V tiles
  static constexpr int SMEM_DQ = PITCH * (2 * FB_ROWS + 2 * 2 * FB_TILE);
  // dK/dV: K and V tiles of FB_ROWS rows, a 2-stage ring of Q and dO tiles
  // and of their rows' lse (base 2) and Delta
  static constexpr int SMEM_DKV =
      PITCH * (2 * FB_ROWS + 2 * 2 * FB_TILE) + 2 * 2 * FB_TILE * 4;
  static_assert(SMEM_DKV <= 232448, "past a block's shared memory");
};

// The warp's 16 rows of acc (16 x D, float32) times `mul` in bfloat16,
// through its own rows of a shared tile at `stage` (pitch PITCH), to rows
// row0 + 16 warp .. of `out` (rows `stride` elements apart) below
// `limit`, 16 bytes at a time.
template <int D, int PITCH>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           float mul, unsigned char* stage,
                                           bf16* out, int row0, int limit,
                                           size_t stride) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  unsigned char* rows = stage + warp * 16 * PITCH;
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      unsigned char* p =
          rows + (g + 8 * h) * PITCH + (n * 8 + 2 * tig) * 2;
      *reinterpret_cast<uint32_t*>(p) =
          pack_bf16(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
    }
  __syncwarp();
  constexpr int CH = D / 8;         // 16-byte chunks a row
#pragma unroll
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i - r * CH;
    const int row = row0 + warp * 16 + r;
    if (row < limit)
      *reinterpret_cast<uint4*>(out + (size_t)row * stride + c * 8) =
          *reinterpret_cast<const uint4*>(rows + r * PITCH + c * 16);
  }
}

template <int D>
__global__ void __launch_bounds__(FB_THREADS, 2) fa_bwd_dq_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ o,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, bf16* __restrict__ dq, int sq, int skv, int hq,
    int hkv, int causal, float scale_log2, float scale) {
  constexpr int PITCH = Bf16Tiles<D>::PITCH;
  constexpr int TILE = FB_TILE * PITCH;
  constexpr int KS = D / 16;        // k-steps over D
  constexpr int NT = FB_TILE / 8;   // 8-key score tiles
  constexpr int DT = D / 8;         // 8-wide dQ tiles
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t s_q = smem_addr(smem);
  const uint32_t s_do = s_q + FB_ROWS * PITCH;
  const uint32_t s_kv = s_do + FB_ROWS * PITCH;
  const int b = blockIdx.x / hq, h = blockIdx.x - b * hq;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, mi = lane >> 3, r8 = lane & 7;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FB_ROWS;   // heaviest first
  const int diag = skv - sq;
  const int n_keys = causal ? min(skv, min(sq, q0 + FB_ROWS) + diag) : skv;
  const int n_tiles = (n_keys + FB_TILE - 1) / FB_TILE;
  const size_t qstride = (size_t)hq * D, kstride = (size_t)hkv * D;
  const size_t qoff = ((size_t)b * sq * hq + h) * D;
  const size_t soff = ((size_t)b * hq + h) * sq;          // lse, delta row 0
  const bf16* kb = k + ((size_t)b * skv * hkv + hk) * D;
  const bf16* vb = v + ((size_t)b * skv * hkv + hk) * D;

  load_tile<bf16, D, PITCH, FB_ROWS, FB_THREADS>(s_q, q + qoff, qstride, q0,
                                                 sq);
  load_tile<bf16, D, PITCH, FB_ROWS, FB_THREADS>(s_do, dout + qoff, qstride,
                                                 q0, sq);
  load_tile<bf16, D, PITCH, FB_TILE, FB_THREADS>(s_kv, kb, kstride, 0, skv);
  load_tile<bf16, D, PITCH, FB_TILE, FB_THREADS>(s_kv + TILE, vb, kstride, 0,
                                                 skv);
  cp_async_commit();

  // Delta of the warp's 16 rows, two lanes a row and half of D each, from
  // o and dO in device memory; stored for the dK/dV kernel.  The lane's
  // fragment rows are r and r + 8; rows past sq get lse = +inf (P = 0).
  const int r = q0 + warp * 16 + g;
  float dl[2], ls[2];
  {
    const int row = q0 + warp * 16 + (lane >> 1);
    float acc = 0.f;
    if (row < sq) {
      const size_t at = qoff + (size_t)row * qstride + (lane & 1) * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + at + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(dout + at + c);
        const bf16* op = reinterpret_cast<const bf16*>(&ov);
        const bf16* dp = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc = fmaf(__bfloat162float(op[e]), __bfloat162float(dp[e]), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((lane & 1) == 0 && row < sq) delta[soff + row] = acc;
    dl[0] = __shfl_sync(0xffffffffu, acc, 2 * g);
    dl[1] = __shfl_sync(0xffffffffu, acc, 2 * g + 16);
    ls[0] = r < sq ? lse[soff + r] * FB_LOG2E : INFINITY;
    ls[1] = r + 8 < sq ? lse[soff + r + 8] * FB_LOG2E : INFINITY;
  }
  const int kend0 = causal ? min(skv, r + diag + 1) : skv;
  const int kend1 = causal ? min(skv, r + 8 + diag + 1) : skv;

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const uint32_t qrow = s_q + warp * 16 * PITCH;
  const uint32_t dorow = s_do + warp * 16 * PITCH;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const uint32_t next = s_kv + ((t + 1) & 1) * 2 * TILE;
      load_tile<bf16, D, PITCH, FB_TILE, FB_THREADS>(next, kb, kstride,
                                                     (t + 1) * FB_TILE, skv);
      load_tile<bf16, D, PITCH, FB_TILE, FB_THREADS>(next + TILE, vb, kstride,
                                                     (t + 1) * FB_TILE, skv);
    }
    cp_async_commit();              // maybe empty: keeps the count uniform
    cp_async_wait<1>();             // tile t (and Q, dO) have landed
    __syncthreads();
    const uint32_t sk = s_kv + (t & 1) * 2 * TILE, sv = sk + TILE;
    // S = Q K^T and dP = dO V^T of the warp's 16 rows and the tile's keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], da[4];
      const int aoff = ((mi & 1) * 8 + r8) * PITCH + (ks * 16 + (mi >> 1) * 8) * 2;
      ldsm_x4(qa, qrow + aoff);
      ldsm_x4(da, dorow + aoff);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t kf[4], vf[4];
        const int boff =
            ((j + (mi >> 1)) * 8 + r8) * PITCH + (ks * 16 + (mi & 1) * 8) * 2;
        ldsm_x4(kf, sk + boff);
        ldsm_x4(vf, sv + boff);
        mma_bf16(s[j], qa, kf[0], kf[1]);
        mma_bf16(s[j + 1], qa, kf[2], kf[3]);
        mma_bf16(dp[j], da, vf[0], vf[1]);
        mma_bf16(dp[j + 1], da, vf[2], vf[3]);
      }
    }
    // P from lse, masked by index; s becomes dS = P (dP - Delta)
    const int c0 = t * FB_TILE + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const bool vis = c0 + j * 8 + (e & 1) < (hh ? kend1 : kend0);
        const float p = vis ? ex2(fmaf(s[j][e], scale_log2, -ls[hh])) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[hh]);
      }
    // dQ += dS K, 16 keys a step (K read transposed)
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s, kk);
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t kf[4];
        ldsm_x4_t(kf, sk + (kk * 16 + (mi & 1) * 8 + r8) * PITCH +
                          (n + (mi >> 1)) * 16);
        mma_bf16(acc[n], a, kf[0], kf[1]);
        mma_bf16(acc[n + 1], a, kf[2], kf[3]);
      }
    }
    __syncthreads();                // stage t & 1 is free for tile t + 2
  }
  cp_async_wait<0>();
  store_rows<D, PITCH>(acc, scale, smem, dq + qoff, q0, sq, qstride);
}

template <int D>
__global__ void __launch_bounds__(FB_THREADS, 2) fa_bwd_dkdv_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int skv, int hq,
    int hkv, int causal, float scale_log2, float scale) {
  constexpr int PITCH = Bf16Tiles<D>::PITCH;
  constexpr int TILE = FB_TILE * PITCH;
  constexpr int KS = D / 16;
  constexpr int NT = FB_TILE / 8;   // 8-query score tiles
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t s_k = smem_addr(smem);
  const uint32_t s_v = s_k + FB_ROWS * PITCH;
  const uint32_t s_ring = s_v + FB_ROWS * PITCH;   // 2 x (Q tile, dO tile)
  float* s_stat = reinterpret_cast<float*>(smem + (2 * FB_ROWS + 4 * FB_TILE) *
                                                      PITCH);   // 2 x (lse2, Delta)
  const int b = blockIdx.x / hkv, hk = blockIdx.x - b * hkv;
  const int group = hq / hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, mi = lane >> 3, r8 = lane & 7;
  const int k0 = blockIdx.y * FB_ROWS;     // heaviest first under causal
  const int diag = skv - sq;
  // the first query tile with a row that sees one of the block's keys
  const int qstart = causal ? max(0, k0 - diag) / FB_TILE * FB_TILE : 0;
  const int n_qt = (sq - qstart + FB_TILE - 1) / FB_TILE;
  const int n_it = group * n_qt;           // (head of the group, query tile)
  const size_t qstride = (size_t)hq * D, kstride = (size_t)hkv * D;
  const size_t koff = ((size_t)b * skv * hkv + hk) * D;

  // the Q and dO tiles of iteration `it` and their rows' lse (base 2;
  // +inf past sq, so P = 0 there) and Delta into ring stage `st`
  auto issue = [&](int it, int st) {
    const int h = hk * group + it / n_qt;
    const int qt0 = qstart + (it % n_qt) * FB_TILE;
    const size_t qoff = ((size_t)b * sq * hq + h) * D;
    const uint32_t dst = s_ring + st * 2 * TILE;
    load_tile<bf16, D, PITCH, FB_TILE, FB_THREADS>(dst, q + qoff, qstride, qt0,
                                                   sq);
    load_tile<bf16, D, PITCH, FB_TILE, FB_THREADS>(dst + TILE, dout + qoff,
                                                   qstride, qt0, sq);
    const size_t soff = ((size_t)b * hq + h) * sq;
    const int i = threadIdx.x & (FB_TILE - 1), row = qt0 + i;
    float* stat = s_stat + st * 2 * FB_TILE;
    if (threadIdx.x < FB_TILE)
      stat[i] = row < sq ? lse[soff + row] * FB_LOG2E : INFINITY;
    else if (threadIdx.x < 2 * FB_TILE)
      stat[FB_TILE + i] = row < sq ? delta[soff + row] : 0.f;
  };

  load_tile<bf16, D, PITCH, FB_ROWS, FB_THREADS>(s_k, k + koff, kstride, k0,
                                                 skv);
  load_tile<bf16, D, PITCH, FB_ROWS, FB_THREADS>(s_v, v + koff, kstride, k0,
                                                 skv);
  issue(0, 0);
  cp_async_commit();

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const uint32_t krow = s_k + warp * 16 * PITCH;
  const uint32_t vrow = s_v + warp * 16 * PITCH;
  const int kr = k0 + warp * 16 + g;       // the lane's keys kr, kr + 8

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) issue(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t sq_t = s_ring + (it & 1) * 2 * TILE, sdo = sq_t + TILE;
    const float* stat = s_stat + (it & 1) * 2 * FB_TILE;
    const int qt0 = qstart + (it % n_qt) * FB_TILE;
    // S^T = K Q^T and dP^T = V dO^T of the warp's 16 keys and the tile's
    // queries
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4], va[4];
      const int aoff = ((mi & 1) * 8 + r8) * PITCH + (ks * 16 + (mi >> 1) * 8) * 2;
      ldsm_x4(ka, krow + aoff);
      ldsm_x4(va, vrow + aoff);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t qf[4], df[4];
        const int boff =
            ((j + (mi >> 1)) * 8 + r8) * PITCH + (ks * 16 + (mi & 1) * 8) * 2;
        ldsm_x4(qf, sq_t + boff);
        ldsm_x4(df, sdo + boff);
        mma_bf16(st[j], ka, qf[0], qf[1]);
        mma_bf16(st[j + 1], ka, qf[2], qf[3]);
        mma_bf16(dpt[j], va, df[0], df[1]);
        mma_bf16(dpt[j + 1], va, df[2], df[3]);
      }
    }
    // P^T from lse (causal: key kr sees query qc when kr <= qc + diag);
    // dpt becomes dS^T = P^T (dP^T - Delta)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * (lane & 3) + (e & 1);
        const bool vis = !causal || kr + 8 * (e >> 1) <= qt0 + qi + diag;
        const float p = vis ? ex2(fmaf(st[j][e], scale_log2, -stat[qi])) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - stat[FB_TILE + qi]);
      }
    // dV += P^T dO and dK += dS^T Q, 16 queries a step (read transposed)
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t ap[4], as[4];
      acc_to_a(ap, st, kk);
      acc_to_a(as, dpt, kk);
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t df[4], qf[4];
        const int toff = (kk * 16 + (mi & 1) * 8 + r8) * PITCH + (n + (mi >> 1)) * 16;
        ldsm_x4_t(df, sdo + toff);
        ldsm_x4_t(qf, sq_t + toff);
        mma_bf16(dva[n], ap, df[0], df[1]);
        mma_bf16(dva[n + 1], ap, df[2], df[3]);
        mma_bf16(dka[n], as, qf[0], qf[1]);
        mma_bf16(dka[n + 1], as, qf[2], qf[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  // each warp read only its own rows of the K and V tiles: they stage its
  // dK and dV rows
  store_rows<D, PITCH>(dka, scale, smem, dk + koff, k0, skv, kstride);
  store_rows<D, PITCH>(dva, 1.f, smem + FB_ROWS * PITCH, dv + koff, k0,
                             skv, kstride);
}

// ---------------------------------------------------------------------------
// float32: FMAs from shared memory, FP_ROWS rows a block, FP_TILE a tile
// ---------------------------------------------------------------------------

#define FP_ROWS 16       // query rows (dQ) or keys (dK/dV) a block
#define FP_TILE 64       // keys (dQ) or queries (dK/dV) a tile
#define FP_PER 8         // 128 threads: 8 a row, FP_TILE / 8 columns each

// rows r0 .. r0 + ROWS - 1 of one head into a shared tile of pitch D + 1
// floats; rows at or past `limit` are zeros
template <int D, int ROWS>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* base,
                                              size_t stride, int r0,
                                              int limit) {
  for (int i = threadIdx.x; i < ROWS * D / 4; i += FB_THREADS) {
    const int r = i / (D / 4), c = (i - r * (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < limit)
      x = *reinterpret_cast<const float4*>(base + (size_t)(r0 + r) * stride + c);
    float* d = dst + r * (D + 1) + c;
    d[0] = x.x, d[1] = x.y, d[2] = x.z, d[3] = x.w;
  }
}

template <int D>
__global__ void __launch_bounds__(FB_THREADS) fa_bwd_dq_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ o,
    const float* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, float* __restrict__ dq, int sq, int skv,
    int hq, int hkv, int causal, float scale_log2, float scale) {
  constexpr int P = D + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_q = reinterpret_cast<float*>(smem);
  float* s_do = s_q + FP_ROWS * P;
  float* s_k = s_do + FP_ROWS * P;
  float* s_v = s_k + FP_TILE * P;
  float* s_ds = s_v + FP_TILE * P;          // FP_ROWS x (FP_TILE + 1)
  const int b = blockIdx.x / hq, h = blockIdx.x - b * hq;
  const int hk = h / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FP_ROWS;
  const int diag = skv - sq;
  const int n_keys = causal ? min(skv, min(sq, q0 + FP_ROWS) + diag) : skv;
  const size_t qstride = (size_t)hq * D, kstride = (size_t)hkv * D;
  const size_t qoff = ((size_t)b * sq * hq + h) * D;
  const size_t soff = ((size_t)b * hq + h) * sq;
  const float* kb = k + ((size_t)b * skv * hkv + hk) * D;
  const float* vb = v + ((size_t)b * skv * hkv + hk) * D;
  const int i = threadIdx.x / FP_PER, c = threadIdx.x % FP_PER;   // row i
  const int row = q0 + i;

  load_rows_f32<D, FP_ROWS>(s_q, q + qoff, qstride, q0, sq);
  load_rows_f32<D, FP_ROWS>(s_do, dout + qoff, qstride, q0, sq);
  // Delta of row i over 8 lanes, each a strided eighth of D
  float dl = 0.f;
  if (row < sq)
    for (int d = c; d < D; d += FP_PER)
      dl = fmaf(o[qoff + (size_t)row * qstride + d],
                dout[qoff + (size_t)row * qstride + d], dl);
  dl += __shfl_xor_sync(0xffffffffu, dl, 1);
  dl += __shfl_xor_sync(0xffffffffu, dl, 2);
  dl += __shfl_xor_sync(0xffffffffu, dl, 4);
  if (c == 0 && row < sq) delta[soff + row] = dl;
  const float ls = row < sq ? lse[soff + row] * FB_LOG2E : INFINITY;
  const int kend = causal ? min(skv, row + diag + 1) : skv;

  float acc[D / FP_PER];
#pragma unroll
  for (int n = 0; n < D / FP_PER; ++n) acc[n] = 0.f;
  for (int t0 = 0; t0 < n_keys; t0 += FP_TILE) {
    __syncthreads();                // the previous tile is consumed
    load_rows_f32<D, FP_TILE>(s_k, kb, kstride, t0, skv);
    load_rows_f32<D, FP_TILE>(s_v, vb, kstride, t0, skv);
    __syncthreads();
    // row i against keys c, c + 8, ...: S and dP, then dS into shared
    float s[FP_TILE / FP_PER], dp[FP_TILE / FP_PER];
#pragma unroll
    for (int m = 0; m < FP_TILE / FP_PER; ++m) s[m] = dp[m] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = s_q[i * P + d], dod = s_do[i * P + d];
#pragma unroll
      for (int m = 0; m < FP_TILE / FP_PER; ++m) {
        const int j = c + m * FP_PER;
        s[m] = fmaf(qd, s_k[j * P + d], s[m]);
        dp[m] = fmaf(dod, s_v[j * P + d], dp[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < FP_TILE / FP_PER; ++m) {
      const int j = c + m * FP_PER;
      const float p = t0 + j < kend ? exp2f(fmaf(s[m], scale_log2, -ls)) : 0.f;
      s_ds[i * (FP_TILE + 1) + j] = p * (dp[m] - dl);
    }
    __syncthreads();
    // dQ[i][d] += dS[i][:] K[:][d] for d = c, c + 8, ...
    for (int j = 0; j < FP_TILE; ++j) {
      const float ds = s_ds[i * (FP_TILE + 1) + j];
#pragma unroll
      for (int n = 0; n < D / FP_PER; ++n)
        acc[n] = fmaf(ds, s_k[j * P + c + n * FP_PER], acc[n]);
    }
  }
  if (row < sq)
#pragma unroll
    for (int n = 0; n < D / FP_PER; ++n)
      dq[qoff + (size_t)row * qstride + c + n * FP_PER] = acc[n] * scale;
}

template <int D>
__global__ void __launch_bounds__(FB_THREADS) fa_bwd_dkdv_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int sq, int skv, int hq,
    int hkv, int causal, float scale_log2, float scale) {
  constexpr int P = D + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_k = reinterpret_cast<float*>(smem);
  float* s_v = s_k + FP_ROWS * P;
  float* s_q = s_v + FP_ROWS * P;
  float* s_do = s_q + FP_TILE * P;
  float* s_p = s_do + FP_TILE * P;          // FP_ROWS x (FP_TILE + 1): P^T
  float* s_ds = s_p + FP_ROWS * (FP_TILE + 1);   // dS^T
  float* s_stat = s_ds + FP_ROWS * (FP_TILE + 1);   // lse2, Delta
  const int b = blockIdx.x / hkv, hk = blockIdx.x - b * hkv;
  const int group = hq / hkv;
  const int k0 = blockIdx.y * FP_ROWS;
  const int diag = skv - sq;
  const int qstart = causal ? max(0, k0 - diag) : 0;
  const size_t qstride = (size_t)hq * D, kstride = (size_t)hkv * D;
  const size_t koff = ((size_t)b * skv * hkv + hk) * D;
  const int i = threadIdx.x / FP_PER, c = threadIdx.x % FP_PER;   // key i
  const int kr = k0 + i;

  load_rows_f32<D, FP_ROWS>(s_k, k + koff, kstride, k0, skv);
  load_rows_f32<D, FP_ROWS>(s_v, v + koff, kstride, k0, skv);
  float dka[D / FP_PER], dva[D / FP_PER];
#pragma unroll
  for (int n = 0; n < D / FP_PER; ++n) dka[n] = dva[n] = 0.f;
  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const size_t qoff = ((size_t)b * sq * hq + h) * D;
    const size_t soff = ((size_t)b * hq + h) * sq;
    for (int t0 = qstart; t0 < sq; t0 += FP_TILE) {
      __syncthreads();
      load_rows_f32<D, FP_TILE>(s_q, q + qoff, qstride, t0, sq);
      load_rows_f32<D, FP_TILE>(s_do, dout + qoff, qstride, t0, sq);
      if (threadIdx.x < FP_TILE) {
        const int row = t0 + threadIdx.x;
        s_stat[threadIdx.x] = row < sq ? lse[soff + row] * FB_LOG2E : INFINITY;
        s_stat[FP_TILE + threadIdx.x] = row < sq ? delta[soff + row] : 0.f;
      }
      __syncthreads();
      // key i against queries c, c + 8, ...: S^T and dP^T
      float s[FP_TILE / FP_PER], dp[FP_TILE / FP_PER];
#pragma unroll
      for (int m = 0; m < FP_TILE / FP_PER; ++m) s[m] = dp[m] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kd = s_k[i * P + d], vd = s_v[i * P + d];
#pragma unroll
        for (int m = 0; m < FP_TILE / FP_PER; ++m) {
          const int j = c + m * FP_PER;
          s[m] = fmaf(kd, s_q[j * P + d], s[m]);
          dp[m] = fmaf(vd, s_do[j * P + d], dp[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < FP_TILE / FP_PER; ++m) {
        const int j = c + m * FP_PER;
        const bool vis = !causal || kr <= t0 + j + diag;
        const float p = vis ? exp2f(fmaf(s[m], scale_log2, -s_stat[j])) : 0.f;
        s_p[i * (FP_TILE + 1) + j] = p;
        s_ds[i * (FP_TILE + 1) + j] = p * (dp[m] - s_stat[FP_TILE + j]);
      }
      __syncthreads();
      // dV[i][d] += P^T[i][:] dO[:][d], dK[i][d] += dS^T[i][:] Q[:][d]
      for (int j = 0; j < FP_TILE; ++j) {
        const float p = s_p[i * (FP_TILE + 1) + j];
        const float ds = s_ds[i * (FP_TILE + 1) + j];
#pragma unroll
        for (int n = 0; n < D / FP_PER; ++n) {
          dva[n] = fmaf(p, s_do[j * P + c + n * FP_PER], dva[n]);
          dka[n] = fmaf(ds, s_q[j * P + c + n * FP_PER], dka[n]);
        }
      }
    }
  }
  if (kr < skv)
#pragma unroll
    for (int n = 0; n < D / FP_PER; ++n) {
      dk[koff + (size_t)kr * kstride + c + n * FP_PER] = dka[n] * scale;
      dv[koff + (size_t)kr * kstride + c + n * FP_PER] = dva[n];
    }
}

template <int D>
static int smem_f32_dq() {
  return 4 * ((2 * FP_ROWS + 2 * FP_TILE) * (D + 1) + FP_ROWS * (FP_TILE + 1));
}
template <int D>
static int smem_f32_dkdv() {
  return 4 * ((2 * FP_ROWS + 2 * FP_TILE) * (D + 1) +
              2 * FP_ROWS * (FP_TILE + 1) + 2 * FP_TILE);
}

// Set a kernel's dynamic shared memory once per instance and launch it;
// returns the launch's error.
template <typename Kernel, typename... Args>
static int launch_one(Kernel kernel, int smem, dim3 grid, cudaStream_t st,
                      Args... args) {
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<grid, FB_THREADS, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                       const bf16* o, const bf16* dout, const float* lse,
                       float* delta, bf16* dq, bf16* dk, bf16* dv, int b,
                       int sq, int skv, int hq, int hkv, int causal,
                       float scale_log2, float scale, cudaStream_t st) {
  using TL = Bf16Tiles<D>;
  int err = launch_one(fa_bwd_dq_bf16<D>, TL::SMEM_DQ,
                       dim3(b * hq, (sq + FB_ROWS - 1) / FB_ROWS), st, q, k, v,
                       o, dout, lse, delta, dq, sq, skv, hq, hkv, causal,
                       scale_log2, scale);
  if (err) return err;
  return launch_one(fa_bwd_dkdv_bf16<D>, TL::SMEM_DKV,
                    dim3(b * hkv, (skv + FB_ROWS - 1) / FB_ROWS), st, q, k, v,
                    dout, lse, (const float*)delta, dk, dv, sq, skv, hq, hkv,
                    causal, scale_log2, scale);
}

template <int D>
static int launch_f32(const float* q, const float* k, const float* v,
                      const float* o, const float* dout, const float* lse,
                      float* delta, float* dq, float* dk, float* dv, int b,
                      int sq, int skv, int hq, int hkv, int causal,
                      float scale_log2, float scale, cudaStream_t st) {
  int err = launch_one(fa_bwd_dq_f32<D>, smem_f32_dq<D>(),
                       dim3(b * hq, (sq + FP_ROWS - 1) / FP_ROWS), st, q, k, v,
                       o, dout, lse, delta, dq, sq, skv, hq, hkv, causal,
                       scale_log2, scale);
  if (err) return err;
  return launch_one(fa_bwd_dkdv_f32<D>, smem_f32_dkdv<D>(),
                    dim3(b * hkv, (skv + FP_ROWS - 1) / FP_ROWS), st, q, k, v,
                    dout, lse, (const float*)delta, dk, dv, sq, skv, hq, hkv,
                    causal, scale_log2, scale);
}

// dtype 0: float32 (FMAs), 1: bfloat16 (mma.sync); d in {64, 128}.  Two
// launches on `stream`, the dQ kernel (which also writes `delta`, (B, Hq,
// Sq) float32 scratch) then the dK/dV kernel; q, o, dout, dq (B, Sq, Hq,
// d), k, v, dk, dv (B, Skv, Hkv, d) contiguous, lse (B, Hq, Sq) float32.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int b, int sq, int skv, int hq, int hkv, int d, int causal,
    int dtype, void* stream) {
  const float scale = (float)(1.0 / sqrt((double)d));
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)d));
  cudaStream_t st = (cudaStream_t)stream;
#define FB_ARGS(T)                                                          \
  (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,       \
      (const float*)lse, (float*)delta, (T*)dq, (T*)dk, (T*)dv, b, sq, skv, \
      hq, hkv, causal, scale_log2, scale, st
  if (dtype == 1 && d == 64) return launch_bf16<64>(FB_ARGS(bf16));
  if (dtype == 1 && d == 128) return launch_bf16<128>(FB_ARGS(bf16));
  if (dtype == 0 && d == 64) return launch_f32<64>(FB_ARGS(float));
  if (dtype == 0 && d == 128) return launch_f32<128>(FB_ARGS(float));
#undef FB_ARGS
  return (int)cudaErrorInvalidValue;
}
