// Blocked online-softmax attention forward for Hopper (sm_90a), on the
// tensor cores.
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (function at :77, pallas_call at
// :120): o = softmax(q k^T / sqrt(D)) v over q (B, Sq, Hq, D) and
// k, v (B, Skv, Hkv, D) in that layout, float32 or bfloat16, GQA groups of
// Hq / Hkv query heads per key/value head, under `causal` the diagonal at
// Skv - Sq, and the output acc / max(l, 1e-30) in q's dtype.  Scores,
// exponentials and sums are float32 in both dtypes.  In bfloat16 the
// probabilities are rounded to bfloat16 for the PV product on the tensor
// cores, where the TPU kernel keeps them in float32 (its v is float32 by
// :64); the outputs differ by about one bfloat16 step, inside the 2e-2
// tolerance.  Its callers are the "attention" policy class (one launch
// scores a whole daemon batch, (B pods, N candidate nodes, 2 heads, D = 8),
// float32) and the LM prefill (one launch per attention layer,
// (B, S, Hq, 64 or 128), bfloat16).  LM training launches it with an `lse`
// pointer: each row's log-sum-exp, m / sqrt(D) + ln(l) in float32, is
// then stored beside the output for the backward (flash_attention_bwd.cu);
// with a null pointer nothing more is stored.
//
// Two designs, by instance (plan(d, dtype) in kernels/flash_attention.py
// says which).
//
// bfloat16 at D in {64, 128}, every LM path's instances (FlashAttention-3's
// forward on wgmma fed by TMA, flash_attention_wgmma below).  A work item
// is one (batch, query head, BM = 128 query rows); a block of three
// warpgroups takes its items in turn.  A producer warpgroup, cut to 24
// registers by setmaxnreg, has one thread load an item's Q tile and then
// stream the K and V tiles of the KV head h / (Hq / Hkv) into a 2-stage
// mbarrier ring, each by TMA (csrc/wgmma_tiles.cuh `head_rows_map`:
// 128-byte swizzle, rows past S read as zeros); K and V have a barrier
// each, so S = Q K^T starts before V has landed.  Two consumer warpgroups
// of 64 query rows each run the math: S = Q K^T on wgmma m64nBNk16 with
// both operands K-major in shared memory; the online softmax on the
// accumulator fragments, whose layout per warp is mma.sync's m16n8 one
// (softmax_tile and mask_tile below serve both designs); P rounded to
// bfloat16 and packed in registers as the A operand (acc_to_afrag), and
// O += P V on wgmma with V MN-major from shared memory (the transpose
// bit), the pattern of the backward's dV.  The consumers release a stage
// once its PV product is done, and the Q tile once the item's last S
// product is: the producer loads the next item's Q and first K/V tiles
// while they finish this one.  The epilogue divides O by l, packs it to
// bf16 into a staging tile (swizzled: the stores are free of bank
// conflicts) and writes rows below Sq with 16-byte stores; the LSE
// instances store each row's lse.
//   D = 128: 128-key tiles, 197,696 shared bytes, one block an SM,
// consumers at 240 registers; the grid is persistent, one block an SM
// over the items in heaviest-first order, dealt forward and backward in
// turn (fwd_deal), so a block's next item loads under its last one's tail
// (at 512 causal keys an item holds 1-4 tiles).  D = 64: 64-key
// tiles, 66,624 bytes, two blocks an SM and a block an item (the two
// overlap each other's prologues, and the hardware deals the items better
// than a fixed order): ptxas holds the whole kernel to the launch bound's
// registers, and two blocks' 80 are too few for a 128-key score tile.
//   Measured and left out (scripts/fwd_steps.py, PERF.md): FlashAttention-
// 3's ping-pong of the two consumer warpgroups by named barriers, and the
// next tile's S product issued with this tile's PV product so that the
// softmax runs under it; neither was faster at the LM paths' shapes.
//
// float32 at every D and bfloat16 at D in {8, 16, 32} (FlashAttention-2's
// structure on mma.sync, flash_attention_f32 and flash_attention_bf16).
// The TPU kernel walks key blocks in the sequential last grid axis and
// carries (m, l, acc) in VMEM scratch.  Here a block of 4 warps holds
// FA_ROWS = 64 query rows of one (batch, query head), 16 a warp, and
// walks the keys itself in tiles of KEYS (32 in bfloat16, 64 in float32;
// Tiles below).  The Q tile and a ring of FA_STAGES = 2 K/V tiles live in
// dynamic shared memory, filled by 16-byte cp.async.cg copies: the next
// tile's copy is in flight while this tile is computed.  A warp computes
// its 16 x KEYS scores S = Q K^T with mma.sync, runs the online softmax
// on the accumulator fragments in registers, and adds P V into its
// 16 x D output fragments with mma.sync, P taken straight from the score
// fragments.  The output is staged through the warp's rows of the Q tile
// and written with 16-byte stores.
//
// Common to both.  The online softmax keeps the row max and row sum
// across the 4 lanes of a quad (__shfl_xor_sync), in base 2 with
// log2(e) / sqrt(D) folded into one FFMA.  Under `causal` a block stops at
// the last tile its rows can see and masks only the tiles that cross the
// diagonal or the ragged end of Skv, by index (the copies zero-fill rows
// past the end, and a zero key row scores 0, not -inf); query blocks run
// heaviest-first (the block index along Sq is reversed), so the causal
// tail of the grid is short.  The running max starts at -1e30, not -inf,
// so a fully masked tile row gives exp2(-inf) = 0 and not NaN; a NaN
// score is dropped by fmaxf but reaches l and acc through exp2(NaN), so a
// NaN input still gives NaN rows.
//
// bfloat16 on mma.sync: m16n8k16 with float32 accumulators.  Q's and K's
// fragments are read with ldmatrix, V's with ldmatrix.trans; Q's again
// each tile.  P is rounded to bfloat16 and packed in registers as the A
// operand of the PV product: the m16n8k16 accumulator layout of two 8-key
// score tiles is the A layout of one 16-key step.  D = 8 is one k-step of
// 16 with the upper 8 dims zero in registers.  Rows of a tile are padded
// to an odd number of 16-byte chunks, so ldmatrix is free of bank
// conflicts.
//
// float32: mma.sync.m16n8k8 in TF32 with 3xTF32 split precision.  Each
// operand x becomes hi (x with the low 13 mantissa bits cleared) and
// lo = x - hi, and a product is lo·hi + hi·lo + hi·hi, which keeps the
// 3e-5 tolerance (TF32 alone gives 4e-5 to 5e-4 at the path's values).
// The split is two full-rate operations: cvt.rna.tf32.f32 runs at a
// quarter of the rate, and at ~4 splits an exponential it set the pace
// (1.86 ms at the policy path).  The m16n8k8 accumulator layout (a lane
// holds keys 2t, 2t + 1 of a row) is not its A layout (keys t, t + 4);
// instead of shuffles, V's rows are read in the matching order (PV
// k-index t is key 2t, t + 4 is key 2t + 1), so P's repack costs no
// shuffle.  Each tile's PV product is summed from zero on the tensor
// cores and added to the output on the CUDA cores: the tensor core's
// float32 sums round toward zero, and over 5,000 keys in one accumulator
// that bias reached 2e-5 of the 3e-5 tolerance.  Rows of a tile are padded
// by 4 floats, so the fragment reads are free of bank conflicts.
//
// What bounds it (chip_smoke.py's attention_bound: the largest of bytes,
// the products, the exponentials and the other softmax operations, each
// at its rate).  At the LM prefill (8, 512, 16, 128), bfloat16, causal:
// 16.8 M visible pairs, 8.6 GFLOP in the two products (0.0087 ms at 989
// TFLOP/s) against 67 MB of q, k, v and o (0.020 ms at 3.35 TB/s): bytes.
// At whisper's encoder (8, 1500, 16, 64), non-causal: 73.7 GFLOP in the
// products (0.0745 ms) against 25 MB: products, with one exponential a
// pair (288 M, 0.069 ms at 16 a clock an SM) close behind.  At the policy
// path (32, 5000, 2, 8), float32: 1.6e9 pairs, one exponential each (0.38
// ms), three TF32 products (0.31 ms at 495 TFLOP/s), 41 MB (0.012 ms):
// the exponentials.

#include <math.h>

#include "launch_status.cuh"
#include "wgmma_tiles.cuh"   // and mma_tiles.cuh

#define FA_THREADS 128   // 4 warps
#define FA_ROWS 64       // query rows a block, 16 a warp
#define FA_STAGES 2      // K/V tiles in the cp.async ring
#define FA_NEG -1e30f    // the running max before any key (finite: no NaN)

// The tiling of an mma.sync instance: KEYS keys a K/V tile (bf16 32,
// float32 64), PITCH bytes a tile row in shared memory (bf16 an odd number
// of 16-byte chunks, float32 D + 4 floats), SMEM the dynamic shared bytes
// of the Q tile and the K/V ring.  plan() in kernels/flash_attention.py
// mirrors it.
template <typename T, int D>
struct Tiles {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int KEYS = BF16 ? 32 : 64;
  static constexpr int PITCH = BF16 ? 16 * ((D / 8) | 1) : 4 * (D + 4);
  static constexpr int SMEM = PITCH * (FA_ROWS + 2 * FA_STAGES * KEYS);
  static_assert(SMEM <= 232448, "past a block's shared memory");
};

// c (16 x 8, float32) += a (16 x 8, tf32) b (8 x 8, tf32)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi is x with the low 13 mantissa bits cleared (a TF32
// value) and lo = x - hi, exact in float32, of which the tensor core reads
// the TF32 part (it ignores the low 13 bits): the product keeps ~2^-20 of
// x.  Two full-rate operations; cvt.rna.tf32.f32 runs at a quarter of
// the rate, and at ~4 splits an exponential it set the pace.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b in 3xTF32: the two small cross terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0,
                                           uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// Mask the scores of keys a row does not see (key >= kend[row]).
template <int NT>
__device__ __forceinline__ void mask_tile(float (&s)[NT][4], int t0,
                                          const int (&kend)[2]) {
  const int c0 = t0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + j * 8 + (e & 1) >= kend[e >> 1]) s[j][e] = -INFINITY;
}

// One tile of the online softmax for the lane's two rows, but for the
// output: s becomes p (float32) in place; m and l (the lane's partial row
// sums) move to the new running max, and corr is the factor by which the
// output must be rescaled to it.
template <int NT>
__device__ __forceinline__ void softmax_scores(float (&s)[NT][4],
                                               float (&m)[2], float (&l)[2],
                                               float (&corr)[2], float scale) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    corr[h] = ex2((m[h] - mx) * scale);   // 0 on the first key
    const float off = -mx * scale;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        const float p = ex2(fmaf(s[j][e], scale, off));   // NaN stays NaN
        s[j][e] = p;
        sum += p;
      }
    l[h] = l[h] * corr[h] + sum;
    m[h] = mx;
  }
}

template <int DT>
__device__ __forceinline__ void rescale(float (&acc)[DT][4],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
}

// One whole tile of the online softmax: the scores, then acc rescaled.
template <int NT, int DT>
__device__ __forceinline__ void softmax_tile(float (&s)[NT][4], float (&m)[2],
                                             float (&l)[2], float (&acc)[DT][4],
                                             float scale) {
  float corr[2];
  softmax_scores(s, m, l, corr, scale);
  rescale(acc, corr);
}

// The block's query rows q0 .. q0 + 63, heaviest first; the K/V tiles any
// of them sees; and the key ends of the lane's two rows.
template <int KEYS>
struct Rows {
  int q0, n_tiles, kend[2];
  __device__ __forceinline__ Rows(int sq, int skv, int causal) {
    q0 = (gridDim.y - 1 - blockIdx.y) * FA_ROWS;
    const int diag = skv - sq;
    const int n_keys =
        causal ? min(skv, min(sq, q0 + FA_ROWS) + diag) : skv;
    n_tiles = (n_keys + KEYS - 1) / KEYS;
    const int r = q0 + (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);
    kend[0] = causal ? min(skv, r + diag + 1) : skv;
    kend[1] = causal ? min(skv, r + 8 + diag + 1) : skv;
  }
};

// acc / max(l, 1e-30) of the warp's 16 rows, through its own rows of the
// Q tile at `stage`, to rows q0 + 16 warp .. of the output, 16 bytes at a
// time.
template <typename T, int D, int PITCH>
__device__ __forceinline__ void store_out(float (&acc)[D / 8][4],
                                          float (&l)[2], unsigned char* stage,
                                          T* o, int q0, int sq,
                                          size_t ostride) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  unsigned char* rows = stage + warp * 16 * PITCH;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float den = l[h];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    den = fmaxf(den, 1e-30f);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = acc[n][2 * h] / den, x1 = acc[n][2 * h + 1] / den;
      unsigned char* p =
          rows + (g + 8 * h) * PITCH + (n * 8 + 2 * tig) * (int)sizeof(T);
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<uint32_t*>(p) = pack_bf16(x0, x1);
      else
        *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
    }
  }
  __syncwarp();
  constexpr int CH = D * (int)sizeof(T) / 16;
  constexpr int VEC = 16 / (int)sizeof(T);
#pragma unroll
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i - r * CH;
    const int row = q0 + warp * 16 + r;
    if (row < sq)
      *reinterpret_cast<uint4*>(o + (size_t)row * ostride + c * VEC) =
          *reinterpret_cast<const uint4*>(rows + r * PITCH + c * 16);
  }
}

// The natural-log log-sum-exp of the lane's two rows, m / sqrt(D) + ln(l)
// (the running max m in raw scores, `scale` = log2(e) / sqrt(D)), to
// lse[row] for rows below sq; lane 0 of each quad writes its rows.
__device__ __forceinline__ void store_lse(const float (&m)[2],
                                          const float (&l)[2], float* lse,
                                          int q0, int sq, float scale) {
  const int lane = threadIdx.x & 31;
  const int r = q0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float den = l[h];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    if ((lane & 3) == 0 && r + 8 * h < sq)
      lse[r + 8 * h] = m[h] * scale * 0.6931471805599453f + logf(den);
  }
}

// The mma.sync bfloat16 instances, D in {8, 16, 32} (the wgmma kernel
// below takes D in {64, 128}), 4 blocks an SM.
template <int D, bool LSE>
__global__ void __launch_bounds__(FA_THREADS, 4) flash_attention_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
    int sq, int skv, int hq, int hkv, int causal, float scale) {
  using TL = Tiles<bf16, D>;
  constexpr int KEYS = TL::KEYS, PITCH = TL::PITCH;
  constexpr int TILE = KEYS * PITCH;
  constexpr int KS = D < 16 ? 1 : D / 16;   // k-steps of Q K^T
  constexpr int NT = KEYS / 8;              // 8-key score tiles
  constexpr int DT = D / 8;                 // 8-wide output tiles
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t s_q = smem_addr(smem);
  const uint32_t s_kv = s_q + FA_ROWS * PITCH;
  const int b = blockIdx.x / hq, h = blockIdx.x - b * hq;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Rows<KEYS> rows(sq, skv, causal);
  const size_t qstride = (size_t)hq * D, kstride = (size_t)hkv * D;
  const bf16* kb = k + ((size_t)b * skv * hkv + hk) * D;
  const bf16* vb = v + ((size_t)b * skv * hkv + hk) * D;

  load_tile<bf16, D, PITCH, FA_ROWS, FA_THREADS>(s_q, q + ((size_t)b * sq * hq + h) * D,
                                     qstride, rows.q0, sq);
  load_tile<bf16, D, PITCH, KEYS, FA_THREADS>(s_kv, kb, kstride, 0, skv);
  load_tile<bf16, D, PITCH, KEYS, FA_THREADS>(s_kv + TILE, vb, kstride, 0, skv);
  cp_async_commit();

  float acc[DT][4], m[2] = {FA_NEG, FA_NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < DT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int mi = lane >> 3, r8 = lane & 7;   // ldmatrix: matrix, its row
  const uint32_t qrow = s_q + warp * 16 * PITCH;

  for (int t = 0; t < rows.n_tiles; ++t) {
    if (t + 1 < rows.n_tiles) {
      const uint32_t next = s_kv + ((t + 1) & 1) * 2 * TILE;
      load_tile<bf16, D, PITCH, KEYS, FA_THREADS>(next, kb, kstride, (t + 1) * KEYS, skv);
      load_tile<bf16, D, PITCH, KEYS, FA_THREADS>(next + TILE, vb, kstride,
                                      (t + 1) * KEYS, skv);
    }
    cp_async_commit();              // maybe empty: keeps the count uniform
    cp_async_wait<1>();             // tile t (and Q) have landed
    __syncthreads();
    const uint32_t sk = s_kv + (t & 1) * 2 * TILE, sv = sk + TILE;
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    // S = Q K^T.  Q's fragments are read again each tile (ldmatrix): held
    // in registers they would cost 4 KS more a lane.
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4];
      if constexpr (D == 8) {       // K rows are one 16-byte chunk; dims
        ldsm_x2(qa[0], qa[1], qrow + (lane & 15) * PITCH);   // 8..15 zero
        qa[2] = qa[3] = 0u;
#pragma unroll
        for (int j = 0; j < NT; j += 4) {
          uint32_t kf[4];
          ldsm_x4(kf, sk + (j * 8 + lane) * PITCH);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_bf16(s[j + i], qa, kf[i], 0u);
        }
      } else {
        ldsm_x4(qa, qrow + ((mi & 1) * 8 + r8) * PITCH +
                        (ks * 16 + (mi >> 1) * 8) * 2);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t kf[4];
          ldsm_x4(kf, sk + ((j + (mi >> 1)) * 8 + r8) * PITCH +
                          (ks * 16 + (mi & 1) * 8) * 2);
          mma_bf16(s[j], qa, kf[0], kf[1]);
          mma_bf16(s[j + 1], qa, kf[2], kf[3]);
        }
      }
    }
    const int t0 = t * KEYS;
    if (t0 + KEYS > rows.kend[0]) mask_tile(s, t0, rows.kend);
    softmax_tile(s, m, l, acc, scale);
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {  // O += P V, 16 keys a step
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      if constexpr (DT == 1) {
        uint32_t v0, v1;
        ldsm_x2_t(v0, v1, sv + (kk * 16 + (lane & 15)) * PITCH);
        mma_bf16(acc[0], a, v0, v1);
      } else {
#pragma unroll
        for (int n = 0; n < DT; n += 2) {
          uint32_t vf[4];
          ldsm_x4_t(vf, sv + (kk * 16 + (mi & 1) * 8 + r8) * PITCH +
                            (n + (mi >> 1)) * 16);
          mma_bf16(acc[n], a, vf[0], vf[1]);
          mma_bf16(acc[n + 1], a, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();                // stage t & 1 is free for tile t + 2
  }
  cp_async_wait<0>();
  store_out<bf16, D, PITCH>(acc, l, smem, o + ((size_t)b * sq * hq + h) * D,
                            rows.q0, sq, qstride);
  if constexpr (LSE)
    store_lse(m, l, lse + ((size_t)b * hq + h) * sq, rows.q0, sq, scale);
}

template <int D, bool LSE>
__global__ void __launch_bounds__(FA_THREADS) flash_attention_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int sq, int skv, int hq, int hkv, int causal,
    float scale) {
  using TL = Tiles<float, D>;
  constexpr int KEYS = TL::KEYS, PITCH = TL::PITCH;
  constexpr int PF = PITCH / 4;             // floats a tile row
  constexpr int TILE = KEYS * PITCH;
  constexpr int KS = D / 8;                 // k-steps of Q K^T
  constexpr int NT = KEYS / 8;
  constexpr int DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t s_q = smem_addr(smem);
  const uint32_t s_kv = s_q + FA_ROWS * PITCH;
  const int b = blockIdx.x / hq, h = blockIdx.x - b * hq;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const Rows<KEYS> rows(sq, skv, causal);
  const size_t qstride = (size_t)hq * D, kstride = (size_t)hkv * D;
  const float* kb = k + ((size_t)b * skv * hkv + hk) * D;
  const float* vb = v + ((size_t)b * skv * hkv + hk) * D;

  load_tile<float, D, PITCH, FA_ROWS, FA_THREADS>(s_q, q + ((size_t)b * sq * hq + h) * D,
                                      qstride, rows.q0, sq);
  load_tile<float, D, PITCH, KEYS, FA_THREADS>(s_kv, kb, kstride, 0, skv);
  load_tile<float, D, PITCH, KEYS, FA_THREADS>(s_kv + TILE, vb, kstride, 0, skv);
  cp_async_commit();

  float acc[DT][4], m[2] = {FA_NEG, FA_NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < DT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float* fs = reinterpret_cast<const float*>(smem);
  // Q's A fragment: rows g, g + 8 of the warp's 16; dims 8 ks + tig, + 4
  const float* qr = fs + (warp * 16 + g) * PF + tig;

  for (int t = 0; t < rows.n_tiles; ++t) {
    if (t + 1 < rows.n_tiles) {
      const uint32_t next = s_kv + ((t + 1) & 1) * 2 * TILE;
      load_tile<float, D, PITCH, KEYS, FA_THREADS>(next, kb, kstride, (t + 1) * KEYS, skv);
      load_tile<float, D, PITCH, KEYS, FA_THREADS>(next + TILE, vb, kstride,
                                       (t + 1) * KEYS, skv);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* sk = fs + (FA_ROWS * PITCH + (t & 1) * 2 * TILE) / 4;
    const float* sv = sk + TILE / 4;
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ah[4], al[4];
      split(qr[ks * 8], ah[0], al[0]);
      split(qr[8 * PF + ks * 8], ah[1], al[1]);
      split(qr[ks * 8 + 4], ah[2], al[2]);
      split(qr[8 * PF + ks * 8 + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {   // B: key 8 j + g, dims 8 ks + tig, + 4
        const float* kr = sk + (j * 8 + g) * PF + ks * 8 + tig;
        uint32_t bh0, bl0, bh1, bl1;
        split(kr[0], bh0, bl0);
        split(kr[4], bh1, bl1);
        mma_3xtf32(s[j], ah, al, bh0, bh1, bl0, bl1);
      }
    }
    const int t0 = t * KEYS;
    if (t0 + KEYS > rows.kend[0]) mask_tile(s, t0, rows.kend);
    softmax_tile(s, m, l, acc, scale);
    // O += P V.  The tile's product is summed apart from acc and added on
    // the CUDA cores: the tensor core's float32 sums round toward zero,
    // which over thousands of keys would bias acc past the tolerance.
    float pv[DT][4];
#pragma unroll
    for (int n = 0; n < DT; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {     // 8 keys a step
      // A: PV k-index tig is key 2 tig, tig + 4 is key 2 tig + 1, which is
      // where the score fragment already holds them
      uint32_t ah[4], al[4];
      split(s[j][0], ah[0], al[0]);
      split(s[j][2], ah[1], al[1]);
      split(s[j][1], ah[2], al[2]);
      split(s[j][3], ah[3], al[3]);
      const float* vr = sv + (j * 8 + 2 * tig) * PF + g;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        uint32_t bh0, bl0, bh1, bl1;
        split(vr[n * 8], bh0, bl0);
        split(vr[PF + n * 8], bh1, bl1);
        mma_3xtf32(pv[n], ah, al, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += pv[n][e];
    __syncthreads();
  }
  cp_async_wait<0>();
  store_out<float, D, PITCH>(acc, l, smem, o + ((size_t)b * sq * hq + h) * D,
                             rows.q0, sq, qstride);
  if constexpr (LSE)
    store_lse(m, l, lse + ((size_t)b * hq + h) * sq, rows.q0, sq, scale);
}

// ---------------------------------------------------------------------------
// bfloat16 at D in {64, 128}: wgmma fed by TMA
// ---------------------------------------------------------------------------

// The tiles at head width D; fwd_plan(d) in kernels/flash_attention.py
// mirrors it, and the launch refuses a plan that disagrees.  Registers:
// a block's pool is 384 threads x the launch bound's count (168 at one
// block an SM, 80 at two); the producer gives back all but 24 and the
// consumers take the rest.  ptxas compiles the whole kernel to the launch
// bound's count, so at two blocks an SM a 128-key score tile (64
// accumulators) does not fit and D = 64 takes 64-key tiles.
template <int D>
struct FwdTiles {
  static constexpr int BM = 128;          // query rows an item, 64 a consumer
  static constexpr int BN = D == 64 ? 64 : 128;   // keys a K/V tile
  static constexpr int STAGES = 2;        // K/V tiles in the TMA ring
  static constexpr int THREADS = 384;     // 2 consumer warpgroups + producer
  static constexpr int BLOCKS = D == 64 ? 2 : 1;   // resident blocks an SM
  static constexpr bool PERSISTENT = D == 128;   // else a block an item
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = D == 64 ? 104 : 240;
  static constexpr int SLABS = D / 64;    // 64-column slabs of a row
  static constexpr int Q_SLAB = BM * 128, KV_SLAB = BN * 128;
  static constexpr int Q_BYTES = BM * D * 2, KV_BYTES = BN * D * 2;
  static constexpr int OFF_Q = 0, OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_O = OFF_V + STAGES * KV_BYTES;   // output staging
  static constexpr int OFF_BAR = OFF_O + Q_BYTES;
  // Q full, Q free, K full[], V full[], stage free[]
  static constexpr int N_BAR = 2 + 3 * STAGES;
  // + 1024: the dynamic base rounded up to a swizzle atom
  static constexpr int SMEM = OFF_BAR + 8 * N_BAR + 1024;
  static constexpr int POOL = THREADS * ((65536 / (THREADS * BLOCKS)) & ~7);
  static_assert(D % 64 == 0 && BM == 128 && BN % 64 == 0, "tile shapes");
  static_assert(BLOCKS * (SMEM + 1024) <= 233472, "past an SM's shared memory");
  static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= POOL,
                "past the block's registers");
};
// fwd_plan(d) in kernels/flash_attention.py (its test reads these lines)
static_assert(FwdTiles<128>::BN == 128 && FwdTiles<128>::SMEM == 197696,
              "fwd_plan(128)");
static_assert(FwdTiles<64>::BN == 64 && FwdTiles<64>::SMEM == 66624,
              "fwd_plan(64)");

// One work item: (batch, query head, BM query rows), in the order of
// fwd_walk: the heaviest query block first, a query block's (batch, head)
// pairs one after another.  n_bh = B Hq, n_qb = query blocks.
template <int BM, int BN>
struct FwdItem {
  int b, h, hk, q0, n_tiles, kmin;
  __device__ __forceinline__ FwdItem(int item, int n_bh, int n_qb, int sq,
                                     int skv, int hq, int hkv, int causal) {
    const int y = item / n_bh, x = item - y * n_bh;
    b = x / hq, h = x - b * hq;
    hk = h / (hq / hkv);
    q0 = (n_qb - 1 - y) * BM;
    const int diag = skv - sq;
    // the tiles any of the item's rows sees; from key `kmin` on (the keys
    // its first row sees) a tile crosses the diagonal or the last key
    const int n_keys = causal ? min(skv, min(sq, q0 + BM) + diag) : skv;
    n_tiles = (n_keys + BN - 1) / BN;
    kmin = causal ? min(skv, q0 + diag + 1) : skv;
  }
};

// Each block takes the items `deal` gives it (fwd_grid and fwd_deal in
// kernels/flash_attention.py); with more than one, the producer loads the
// next item's Q and first K/V tiles while the consumers finish this one.
template <int D, bool LSE>
__global__ void __launch_bounds__(384, FwdTiles<D>::BLOCKS)
    flash_attention_wgmma(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          bf16* __restrict__ o, float* __restrict__ lse,
                          int sq, int skv, int hq, int hkv, int causal,
                          int n_bh, int n_qb, float scale) {
  using T = FwdTiles<D>;
  constexpr int BM = T::BM, BN = T::BN, ST = T::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);
  const uint32_t bar_q = base + T::OFF_BAR, bar_qfree = bar_q + 8;
  const uint32_t bar_k = bar_q + 16, bar_v = bar_k + 8 * ST;
  const uint32_t bar_empty = bar_v + 8 * ST;
  const int n_items = n_bh * n_qb;
  // the block's n-th item: rounds of gridDim.x items, dealt forward in
  // even rounds and backward in odd ones, so that heaviest-first items
  // even out across the blocks
  const auto deal = [&](int n) {
    return n * (int)gridDim.x +
           ((n & 1) ? (int)gridDim.x - 1 - (int)blockIdx.x : (int)blockIdx.x);
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_qfree, 256);            // every consumer thread
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup: one thread issues every copy ----
    setmaxnreg_dec<T::PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      int st = 0;
      uint32_t phase = 1;                // a free stage passes at once
      for (int n = 0, item; (item = deal(n)) < n_items; ++n) {
        const FwdItem<BM, BN> it(item, n_bh, n_qb, sq, skv, hq, hkv,
                                 causal);
        mbar_wait(bar_qfree, (n & 1) ^ 1);   // the last item's Q is read
        mbar_expect_tx(bar_q, T::Q_BYTES);
#pragma unroll
        for (int s = 0; s < T::SLABS; ++s)
          tma_load_4d(base + T::OFF_Q + s * T::Q_SLAB, &tm_q, bar_q, 64 * s,
                      it.h, it.q0, it.b);
        for (int t = 0; t < it.n_tiles; ++t) {
          mbar_wait(bar_empty + 8 * st, phase);
          mbar_expect_tx(bar_k + 8 * st, T::KV_BYTES);
#pragma unroll
          for (int s = 0; s < T::SLABS; ++s)
            tma_load_4d(base + T::OFF_K + st * T::KV_BYTES + s * T::KV_SLAB,
                        &tm_k, bar_k + 8 * st, 64 * s, it.hk, t * BN, it.b);
          mbar_expect_tx(bar_v + 8 * st, T::KV_BYTES);
#pragma unroll
          for (int s = 0; s < T::SLABS; ++s)
            tma_load_4d(base + T::OFF_V + st * T::KV_BYTES + s * T::KV_SLAB,
                        &tm_v, bar_v + 8 * st, 64 * s, it.hk, t * BN, it.b);
          if (++st == ST) st = 0, phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups 0 and 1: query rows q0 + 64 wg .. + 63 ----
    setmaxnreg_inc<T::CONSUMER_REGS>();
    const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
    const int warp = t >> 5, lane = t & 31, g = lane >> 2, q4 = lane & 3;
    const int r0 = 64 * wg + 16 * warp + g;   // the lane's rows r0, r0 + 8
    const uint32_t sQ = base + T::OFF_Q + wg * 64 * 128;
    int st = 0;
    uint32_t phase = 0;
    for (int n = 0, item; (item = deal(n)) < n_items; ++n) {
      const FwdItem<BM, BN> it(item, n_bh, n_qb, sq, skv, hq, hkv, causal);
      const int diag = skv - sq;
      const int kend[2] = {causal ? min(skv, it.q0 + r0 + diag + 1) : skv,
                           causal ? min(skv, it.q0 + r0 + 9 + diag) : skv};
      float oacc[D / 2], m[2] = {FA_NEG, FA_NEG}, l[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
      auto& o4 = *reinterpret_cast<float(*)[D / 8][4]>(&oacc);
      // S = Q K^T of the tile at stage st: 64 rows x BN keys, over D (both
      // operands K-major)
      auto qk = [&](float(&s)[BN / 2], int st) {
        const uint32_t sK = base + T::OFF_K + st * T::KV_BYTES;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BN, 0, 0>(
              s, sw128_desc(sQ + (kk >> 2) * T::Q_SLAB + (kk & 3) * 32, 16),
              sw128_desc(sK + (kk >> 2) * T::KV_SLAB + (kk & 3) * 32, 16),
              kk > 0);
        wgmma_commit();
      };
      // O += P V of the tile at stage st: P rounded to bf16 as the A
      // operand from registers, V MN-major (keys are the rows of its tile)
      auto pv = [&](const uint32_t(&pa)[BN / 4], int st) {
        const uint32_t sV = base + T::OFF_V + st * T::KV_BYTES;
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_rs<D, 1>(oacc, pa + 4 * kk,
                         sw128_desc(sV + kk * 2048, T::KV_SLAB));
        wgmma_commit();
      };
      mbar_wait(bar_q, n & 1);
      for (int kt = 0; kt < it.n_tiles; ++kt) {
        float s[BN / 2];
        mbar_wait(bar_k + 8 * st, phase);
        wgmma_fence();
        qk(s, st);
        wgmma_wait<0>();
        fence_regs(s);
        if (kt + 1 == it.n_tiles)
          mbar_arrive(bar_qfree);   // Q is free for the next item
        auto& s4 = *reinterpret_cast<float(*)[BN / 8][4]>(&s);
        if ((kt + 1) * BN > it.kmin) mask_tile(s4, kt * BN, kend);
        softmax_tile(s4, m, l, o4, scale);
        uint32_t pa[BN / 4];
        acc_to_afrag<BN / 16>(pa, s);
        mbar_wait(bar_v + 8 * st, phase);
        wgmma_fence();
        pv(pa, st);
        wgmma_wait<0>();
        fence_regs(oacc);
        fence_regs(pa);
        mbar_arrive(bar_empty + 8 * st);   // this thread is done with it
        if (++st == ST) st = 0, phase ^= 1;
      }

      // O / max(l, 1e-30) in bf16 into the warpgroup's rows of the output
      // staging tile (128-byte swizzle, as the Q tile), then 16-byte
      // stores of the rows below sq
      float den[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        den[i] = l[i];
        den[i] += __shfl_xor_sync(0xffffffffu, den[i], 1);
        den[i] += __shfl_xor_sync(0xffffffffu, den[i], 2);
        if (LSE && q4 == 0 && it.q0 + r0 + 8 * i < sq)
          lse[((size_t)it.b * hq + it.h) * sq + it.q0 + r0 + 8 * i] =
              m[i] * scale * 0.6931471805599453f + logf(den[i]);
        den[i] = fmaxf(den[i], 1e-30f);
      }
      named_bar_sync(1 + wg, 128);   // the last item's rows are stored
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = r0 + 8 * i;
          st_shared_u32(base + T::OFF_O + (j >> 3) * T::Q_SLAB + r * 128 +
                            (((j & 7) ^ (r & 7)) << 4) + q4 * 4,
                        pack_bf16(oacc[4 * j + 2 * i] / den[i],
                                  oacc[4 * j + 2 * i + 1] / den[i]));
        }
      named_bar_sync(1 + wg, 128);
      constexpr int CH = D / 8;   // 16-byte chunks a row
      bf16* const ob = o + ((size_t)it.b * sq * hq + it.h) * D;
      for (int i = t; i < 64 * CH; i += 128) {
        const int r = 64 * wg + i / CH, c = i % CH;
        if (it.q0 + r < sq)
          *reinterpret_cast<uint4*>(ob + (size_t)(it.q0 + r) * hq * D +
                                    c * 8) =
              *reinterpret_cast<const uint4*>(
                  sbase + T::OFF_O + (c >> 3) * T::Q_SLAB + r * 128 +
                  (((c & 7) ^ (r & 7)) << 4));
      }
    }
  }
}

// One launch of a wgmma instance; `rows` and `smem` are plan(d, bf16)'s,
// refused when they disagree with FwdTiles<D>.  D = 128 is persistent,
// one block an SM (or a work item where there are fewer): a block's next
// item's loads overlap its last item's tail.  D = 64 launches a block a
// work item: two blocks an SM overlap each other's prologues, and the
// hardware's dealing evens out the items better than a fixed one.
template <int D, bool LSE>
static int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                        void* lse, int b, int sq, int skv, int hq, int hkv,
                        int causal, int rows, int smem, float scale,
                        cudaStream_t stream) {
  using T = FwdTiles<D>;
  if (rows != T::BM || smem != T::SMEM)
    return launch_fail((int)cudaErrorInvalidValue,
                       "plan (rows %d, %d shared bytes) disagrees with "
                       "FwdTiles<%d> (%d, %d)", rows, smem, D, T::BM, T::SMEM);
  CUtensorMap tq, tk, tv;
  int err, dev = 0, sms = 0;
  if ((err = bind_primary_context()) ||
      (err = head_rows_map(&tq, "q", q, b, sq, hq, D, T::BM)) ||
      (err = head_rows_map(&tk, "k", k, b, skv, hkv, D, T::BN)) ||
      (err = head_rows_map(&tv, "v", v, b, skv, hkv, D, T::BN)))
    return err;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess)
    return launch_fail((int)e, "SM count: %s", cudaGetErrorString(e));
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_wgmma<D, LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess)
    return launch_fail((int)attr, "%d bytes of shared memory refused: %s",
                       T::SMEM, cudaGetErrorString(attr));
  const int n_bh = b * hq, n_qb = (sq + T::BM - 1) / T::BM;
  const long long n_items = (long long)n_bh * n_qb;
  const int grid = (int)(T::PERSISTENT && n_items > sms ? sms : n_items);
  flash_attention_wgmma<D, LSE><<<grid, T::THREADS, T::SMEM, stream>>>(
      tq, tk, tv, (bf16*)o, (float*)lse, sq, skv, hq, hkv, causal, n_bh,
      n_qb, scale);
  return launch_check("wgmma forward launch");
}

template <typename T, int D, bool LSE, typename Kernel>
static int launch(Kernel kernel, const void* q, const void* k, const void* v,
                  void* o, void* lse, int b, int sq, int skv, int hq, int hkv,
                  int causal, int rows, int smem, float scale,
                  cudaStream_t stream) {
  using TL = Tiles<T, D>;
  if (rows != FA_ROWS || smem != TL::SMEM)
    return launch_fail((int)cudaErrorInvalidValue,
                       "plan (rows %d, %d shared bytes) disagrees with "
                       "Tiles<%d> (%d, %d)", rows, smem, D, FA_ROWS, TL::SMEM);
  // once per instance (and process); the launch needs it above 48 KB
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
  if (attr != cudaSuccess)
    return launch_fail((int)attr, "%d bytes of shared memory refused: %s",
                       TL::SMEM, cudaGetErrorString(attr));
  const dim3 grid(b * hq, (sq + FA_ROWS - 1) / FA_ROWS);
  kernel<<<grid, FA_THREADS, TL::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, sq, skv, hq,
      hkv, causal, scale);
  return launch_check("mma.sync forward launch");
}

#define FA_LAUNCH(T, KERNEL, DIM, LSE)                                      \
  launch<T, DIM, LSE>(KERNEL<DIM, LSE>, q, k, v, o, lse, b, sq, skv, hq,    \
                      hkv, causal, rows, smem, scale, st)
// an instance without the lse store; a launch that asks for it is refused
#define FA_CASE(T, KERNEL, DIM)                                             \
  case DIM:                                                                 \
    return lse ? launch_fail((int)cudaErrorInvalidValue, "no lse store at " \
                             "d = %d", DIM)                                 \
               : FA_LAUNCH(T, KERNEL, DIM, false);
// an instance with and one without
#define FA_CASE_LSE(T, KERNEL, DIM)                                         \
  case DIM:                                                                 \
    return lse ? FA_LAUNCH(T, KERNEL, DIM, true)                            \
               : FA_LAUNCH(T, KERNEL, DIM, false);
// the wgmma instances, with and without the lse store
#define FA_CASE_WGMMA(DIM)                                                  \
  case DIM:                                                                 \
    return lse ? launch_wgmma<DIM, true>(q, k, v, o, lse, b, sq, skv, hq,   \
                                         hkv, causal, rows, smem, scale, st) \
               : launch_wgmma<DIM, false>(q, k, v, o, lse, b, sq, skv, hq,  \
                                          hkv, causal, rows, smem, scale, st);

// dtype 0: float32 (3xTF32 on mma.sync), 1: bfloat16 (wgmma at d in {64,
// 128}, mma.sync below).  `rows` and `smem` are plan(d, dtype)'s query
// rows a block and dynamic shared bytes in kernels/flash_attention.py; a
// launch whose plan disagrees with this file is refused.  `lse` null
// stores no log-sum-exp; else (B, Hq, Sq) float32, each row's natural-log
// log-sum-exp of its scaled scores (the backward's saved statistic), at d
// in {64, 128} only.  Returns 0 or a CUDA error (a refused launch, plan
// or tensor map; `launch_why` says which).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int b, int sq,
                                      int skv, int hq, int hkv, int d,
                                      int causal, int dtype, int rows,
                                      int smem, void* stream) {
  const LaunchScope scope;
  const float scale = (float)(1.4426950408889634 / sqrt((double)d));
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    switch (d) {
      FA_CASE(float, flash_attention_f32, 8)
      FA_CASE(float, flash_attention_f32, 16)
      FA_CASE(float, flash_attention_f32, 32)
      FA_CASE_LSE(float, flash_attention_f32, 64)
      FA_CASE_LSE(float, flash_attention_f32, 128)
    }
  } else if (dtype == 1) {
    switch (d) {
      FA_CASE(bf16, flash_attention_bf16, 8)
      FA_CASE(bf16, flash_attention_bf16, 16)
      FA_CASE(bf16, flash_attention_bf16, 32)
      FA_CASE_WGMMA(64)
      FA_CASE_WGMMA(128)
    }
  }
  return launch_fail((int)cudaErrorInvalidValue, "no instance for dtype %d "
                     "at d = %d", dtype, d);
}
