// Attention backward for Hopper (sm_90a): dQ, dK and dV of kernel 7's
// o = softmax(q k^T / sqrt(D)) v.
//
// Replaces no Pallas kernel: the JAX model trains through XLA's autodiff
// of its attention (src/repro/models/layers.py:124, no custom_vjp), while
// the port runs every training attention through kernel 7
// (flash_attention.cu), whose raw launch carries no gradient.  This is
// the backward of that launch, bound by kernels/flash_attention.py's
// autograd Function.  Layouts as the forward's: q, o, dO (B, Sq, Hq, D),
// k, v (B, Skv, Hkv, D), GQA groups of Hq / Hkv query heads, under
// `causal` the diagonal at Skv - Sq; ragged Sq and Skv; lse (B, Hq, Sq)
// float32, the forward's natural-log log-sum-exp of each row's scaled
// scores; D in {64, 128}; bfloat16 or float32.  P is recomputed from the
// saved lse, P = exp(q k / sqrt(D) - lse); with Delta = rowsum(dO o),
// dS = P (dO v^T - Delta), dV = P^T dO, dK = dS^T q / sqrt(D), dQ = dS k /
// sqrt(D).
//
// What bounds it (chip_smoke.py's attention bound for the backward: the
// larger of the bytes, q, k, v, o, dO read and dq, dk, dv written once,
// and the five products over the visible pairs at the bf16 tensor-core
// rate).  OLMo-1B's training shape (8, 512, 16, 128), causal: 134 MB
// (0.040 ms at 3.35 TB/s) against 21.5 GFLOP (0.022 ms at 989 TFLOP/s),
// bytes.  whisper's encoder (8, 1500, 16, 64), non-causal: 184 GFLOP
// (0.186 ms) against 25 MB, products; its cross-attention (448 queries
// against 1,500 keys) likewise.  So the kernel must run its products on
// the tensor cores near their rate and read each input once.
//
// bfloat16: three launches a call, FlashAttention-3's backward order.
//   * fa_bwd_pre_bf16: lse2 = lse log2(e) (+inf on the pad rows past Sq,
//     so P = 0 there) and Delta of every row, into a float32 scratch of
//     (B, Hq, query tile, 2, BM), a tile's rows contiguous; the float32 dQ
//     accumulator zeroed.
//   * fa_bwd_main_bf16: one block per (batch, KV head, BN = 128 keys),
//     launched in groups of GROUP = 32 (batch, KV head) rows: a group's
//     first key blocks (the heaviest under `causal`) for each of its rows,
//     then its second, and so on, then the next group.  The blocks
//     resident together come from at most 32 rows, whose Q, dO and dQ
//     accumulator rows stay in the L2 (all rows' first key blocks at once,
//     the accumulators outgrow it at whisper's encoder and the reduce-adds
//     go to device memory), and only about 132 / 32 key blocks of a row
//     start together, so few wait on the one before them in dQ's order
//     below (a row's key blocks launched one after another, they all start
//     together and each trails the one before it by an add and its
//     completion).  Every block walks its query tiles in one order, the
//     last first, so the blocks of a row that do run together read the
//     same Q and dO tiles and add to the same accumulator rows at about
//     the same time.  In a producer warpgroup (24 registers a thread
//     after setmaxnreg) one thread loads the block's K and V tiles once
//     and then, for every query head of the GQA group and every BM-row
//     query tile that sees the block's keys, from the last tile down,
//     the Q and dO tiles by TMA (128-byte swizzle, rows past Sq
//     zero-filled) and the rows' lse2 and Delta by one bulk copy, into a
//     2-stage mbarrier ring.  Two consumer warpgroups (240 registers),
//     64 keys each, compute per tile on wgmma: S^T = K Q^T and dP^T = V
//     dO^T (both operands in shared memory); P^T = exp2(S^T scale log2(e)
//     - lse2) and dS^T = P^T (dP^T - Delta) in registers (masked by index
//     on a tile that crosses the diagonal or the last key); dV += P^T dO
//     and dK += dS^T Q with P^T and dS^T rounded to bf16 as the A operand
//     from registers (so a group's sum stays in registers, no atomics);
//     dS^T stored to shared memory (bf16, 128-byte swizzle, two buffers);
//     and the tile's dQ = dS K, each warpgroup a 64 x 64 piece (D = 128:
//     its 64 columns; D = 64: its 64 query rows) over all 128 keys, the
//     transposed operands read through wgmma's transpose bits.  The piece
//     goes to shared memory (an mbarrier says it is in), and another
//     thread of the producer warpgroup, the dQ writer, adds both pieces of
//     a tile to the float32 accumulator with one cp.reduce.async.bulk
//     add.f32 each, in the fixed order below, then frees the staging for
//     the consumers' next tile once they are read (a second mbarrier).
//     Five products a tile pair, not the seven of a split dQ / dK-dV pair
//     of kernels; q, k, v and dO read once from device memory, the Q/dO
//     re-reads of later key blocks from the L2.
//   * fa_bwd_post_bf16: dQ = accumulator / sqrt(D) in bf16, (B, Sq, Hq, D).
// dK and dV are summed in registers in a fixed order.  dQ is summed in a
// fixed order too: each (batch, query head, query tile) takes its key
// blocks' pieces in ascending key-block order (FlashAttention-3's
// deterministic backward: a counter a tile that a block waits on before
// its adds and raises after them, here by a dQ writer thread), so all
// three repeat bit for bit.  The counters, (B, Hq, query tiles) int32,
// are zeroed by fa_bwd_pre_bf16 and count the key blocks that have added
// to their tile; under `causal` the key blocks
// that see a tile are the first ones, so key block x's writer waits until
// the tile's counter reads x (ld.acquire.gpu), adds the two pieces, and
// once both adds have completed (their writes done, not only their source
// read) raises it by one (red.release.gpu); proxy fences order the bulk
// adds (async proxy) with the counter.  The writer frees the staging as
// soon as the adds have read it; the consumers wait for that only a tile
// later, when they stage the next pieces.  Walked from the first tile up
// instead, under `causal` key block x would start at the tile that x - 1
// reaches third, and every block would trail the one before it by two
// tiles.
// LAUNCH ORDER: a block waits only on the key blocks of its own (batch,
// KV head) with a smaller blockIdx.y, in its own group (blockIdx.z) at
// the same blockIdx.x, so with a smaller linear index, and it relies on
// the hardware dispatching blocks in the order of their linear index
// (blockIdx.x fastest, then y, then z), as FlashAttention-3 does: those
// blocks are then resident or done, never unlaunched, so no resident
// block waits forever.
// float32 runs on FMAs from shared memory, a dQ kernel (which also writes
// Delta) then a dK/dV kernel, no atomics: no path trains in float32 at
// speed, it holds the bfloat16 path to an exact reference.

#include <math.h>

#include "launch_status.cuh"
#include "wgmma_tiles.cuh"

#define FB_THREADS 128   // float32 kernels: 4 warps
#define FB_LOG2E 1.4426950408889634f

// The bf16 tiles at head width D; bwd_plan(d) in kernels/flash_attention.py
// mirrors it, and the launch refuses a plan that disagrees.
template <int D>
struct BwdTiles {
  static constexpr int BM = D == 128 ? 64 : 128;   // queries a tile
  static constexpr int BN = 128;        // keys a block, 64 a consumer
  static constexpr int STAGES = 2;      // Q/dO tiles in the ring
  static constexpr int THREADS = 384;   // 2 consumer warpgroups + producer
  static constexpr int GROUP = 32;      // (batch, KV head) rows a group
  static constexpr int SLABS = D / 64;  // 64-column slabs of a row
  static constexpr int KV_SLAB = BN * 128, Q_SLAB = BM * 128;
  static constexpr int KV_BYTES = BN * D * 2, Q_BYTES = BM * D * 2;
  static constexpr int DS_BYTES = BN * BM * 2;   // dS^T, keys x queries
  static constexpr int DS_SLAB = BN * 128;       // 64 queries of it
  static constexpr int DQ_BYTES = 64 * 64 * 4;   // a warpgroup's dQ piece
  static constexpr int STAT_BYTES = 2 * BM * 4;  // lse2, then Delta, of a tile
  static constexpr int OFF_K = 0, OFF_V = KV_BYTES, OFF_Q = 2 * KV_BYTES;
  static constexpr int OFF_DO = OFF_Q + STAGES * Q_BYTES;
  static constexpr int OFF_DS = OFF_DO + STAGES * Q_BYTES;
  static constexpr int OFF_DQ = OFF_DS + 2 * DS_BYTES;
  static constexpr int OFF_STAT = OFF_DQ + 2 * DQ_BYTES;
  static constexpr int OFF_BAR = OFF_STAT + STAGES * STAT_BYTES;
  // K/V, full[], empty[], dQ pieces in (one a warpgroup), dQ staging free
  static constexpr int N_BAR = 1 + 2 * STAGES + 3;
  // + 1024: the dynamic base rounded up to a swizzle atom
  static constexpr int SMEM = OFF_BAR + 8 * N_BAR + 1024;
  // dK and dV of both warpgroups staged for the store, after the loop,
  // over K, V and the ring (rows padded by 16 bytes: no bank conflicts)
  static constexpr int EPI_PITCH = 2 * D + 16;
  static_assert(BM % 64 == 0 && BN == 128 && D % 64 == 0, "tile shapes");
  static_assert(SMEM <= 232448, "past a block's shared memory");
  static_assert(4 * 64 * EPI_PITCH <= OFF_DS, "dK/dV staging");
};
// bwd_plan(d) in kernels/flash_attention.py (its test reads these lines)
static_assert(BwdTiles<128>::BM == 64 && BwdTiles<128>::SMEM == 198720,
              "bwd_plan(128)");
static_assert(BwdTiles<64>::BM == 128 && BwdTiles<64>::SMEM == 199744,
              "bwd_plan(64)");
static_assert(BwdTiles<128>::GROUP == 32 && BwdTiles<64>::GROUP == 32,
              "bwd_plan's group_rows");

template <int D>
__global__ void __launch_bounds__(256) fa_bwd_pre_bf16(
    const bf16* __restrict__ o, const bf16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ stats,
    float* __restrict__ dq_acc, int* __restrict__ dq_sem, int sq, int hq) {
  constexpr int BM = BwdTiles<D>::BM;
  const int bh = blockIdx.x, m = blockIdx.y;
  const int b = bh / hq, h = bh - b * hq;
  const size_t tile = (size_t)bh * gridDim.y + m;   // (b, h, query tile)
  if (threadIdx.x == 0) dq_sem[tile] = 0;           // no piece added yet
  float4* acc = reinterpret_cast<float4*>(dq_acc + tile * BM * D);
  for (int i = threadIdx.x; i < BM * D / 4; i += 256)
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // 8 threads a row, each 16-byte chunks 8 sub, 8 sub + 64, ...
  const int sub = threadIdx.x & 7;
  for (int r = threadIdx.x >> 3; r < BM; r += 32) {
    const int row = m * BM + r;
    float sum = 0.f;
    if (row < sq) {
      const size_t at = (((size_t)b * sq + row) * hq + h) * D;
#pragma unroll
      for (int c = sub * 8; c < D; c += 64) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + at + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(dout + at + c);
        const bf16* op = reinterpret_cast<const bf16*>(&ov);
        const bf16* dp = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          sum = fmaf(__bfloat162float(op[e]), __bfloat162float(dp[e]), sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    if (sub == 0) {   // the tile's lse2 row, then its Delta row
      stats[tile * 2 * BM + r] =
          row < sq ? lse[(size_t)bh * sq + row] * FB_LOG2E : INFINITY;
      stats[tile * 2 * BM + BM + r] = sum;
    }
  }
}

// dQ's order: a tile's counter read with acquire and raised with release
// at the GPU's scope, ordered with the bulk reduce-adds (the async proxy)
// by proxy fences.
__device__ __forceinline__ void dq_wait(const int* cnt, int count) {
  int seen;
  do {
    asm volatile("ld.global.acquire.gpu.b32 %0, [%1];\n"
                 : "=r"(seen) : "l"(cnt) : "memory");
  } while (seen < count);
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
// the issuing thread's reduce-adds complete, then its tile's counter
// raised by one
__device__ __forceinline__ void dq_done(int* cnt) {
  bulk_wait<0>();
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  asm volatile("red.release.gpu.global.add.s32 [%0], 1;\n" ::"l"(cnt)
               : "memory");
}

template <int D>
__global__ void __launch_bounds__(384, 1) fa_bwd_main_bf16(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ stats, float* __restrict__ dq_acc,
    int* __restrict__ dq_sem, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int kv_rows, int sq, int skv, int hq, int hkv, int causal,
    float scale_log2, float scale) {
  using T = BwdTiles<D>;
  constexpr int BM = T::BM, BN = T::BN, ST = T::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);
  const uint32_t bar_kv = base + T::OFF_BAR;
  const uint32_t bar_full = bar_kv + 8, bar_empty = bar_kv + 8 * (1 + ST);
  const uint32_t bar_dq = bar_kv + 8 * (1 + 2 * ST);   // in[2], then free
  const int kv_row = blockIdx.z * gridDim.x + blockIdx.x;  // (batch, KV head)
  if (kv_row >= kv_rows) return;         // past the last group's rows
  const int b = kv_row / hkv, hk = kv_row - b * hkv;
  const int group = hq / hkv;
  const int kb = blockIdx.y, k0 = kb * BN;   // heaviest first under causal
  const int diag = skv - sq;
  const int n_mt = (sq + BM - 1) / BM;
  // the first query tile with a row that sees one of the block's keys
  const int m0 = causal ? max(0, k0 - diag) / BM : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 256);   // every consumer thread
    }
    mbar_init(bar_dq, 128);                // a warpgroup's threads
    mbar_init(bar_dq + 8, 128);
    mbar_init(bar_dq + 16, 1);             // the dQ writer
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup: one thread loads, one writes dQ ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_kv, 2 * T::KV_BYTES);
#pragma unroll
      for (int s = 0; s < T::SLABS; ++s) {
        tma_load_4d(base + T::OFF_K + s * T::KV_SLAB, &tm_k, bar_kv, 64 * s,
                    hk, k0, b);
        tma_load_4d(base + T::OFF_V + s * T::KV_SLAB, &tm_v, bar_kv, 64 * s,
                    hk, k0, b);
      }
      int st = 0;
      uint32_t phase = 1;                // a free stage passes at once
      for (int hh = 0; hh < group; ++hh) {
        const int h = hk * group + hh;
        for (int m = n_mt - 1; m >= m0; --m) {   // the last tile first
          const float* src = stats + ((size_t)(b * hq + h) * n_mt + m) * 2 * BM;
          const uint32_t full = bar_full + 8 * st;
          mbar_wait(bar_empty + 8 * st, phase);
          mbar_expect_tx(full, 2 * T::Q_BYTES + T::STAT_BYTES);
#pragma unroll
          for (int s = 0; s < T::SLABS; ++s) {
            tma_load_4d(base + T::OFF_Q + st * T::Q_BYTES + s * T::Q_SLAB,
                        &tm_q, full, 64 * s, h, m * BM, b);
            tma_load_4d(base + T::OFF_DO + st * T::Q_BYTES + s * T::Q_SLAB,
                        &tm_do, full, 64 * s, h, m * BM, b);
          }
          bulk_load(base + T::OFF_STAT + st * T::STAT_BYTES, src,
                    T::STAT_BYTES, full);
          if (++st == ST) st = 0, phase ^= 1;
        }
      }
    } else if (threadIdx.x == 288) {
      // the dQ writer: each tile's two pieces after every earlier key
      // block's, the staging freed once read, the counter raised once the
      // adds are complete
      uint32_t phase = 0;
      for (int hh = 0; hh < group; ++hh) {
        const int h = hk * group + hh;
        for (int m = n_mt - 1; m >= m0; --m, phase ^= 1) {
          const size_t tile = (size_t)(b * hq + h) * n_mt + m;
          dq_wait(dq_sem + tile, kb);
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            mbar_wait(bar_dq + 8 * w, phase);
            bulk_reduce_add_f32(dq_acc + tile * BM * D + w * 4096,
                                base + T::OFF_DQ + w * T::DQ_BYTES,
                                T::DQ_BYTES);
            bulk_commit();
          }
          bulk_wait_read<0>();       // the staging read: free it
          mbar_arrive(bar_dq + 16);
          dq_done(dq_sem + tile);
        }
      }
    }
  } else {
    // ---- consumer warpgroups 0 and 1: keys k0 + 64 wg .. + 63 ----
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
    const int warp = t >> 5, lane = t & 31, g = lane >> 2, q4 = lane & 3;
    const int key = k0 + 64 * wg + 16 * warp + g;   // and key + 8
    const int dsrow = 64 * wg + 16 * warp + g;      // its row of dS^T
    // dQ piece: D = 128 its 64 columns (A: dS^T's one slab, B: K slab wg);
    // D = 64 its 64 query rows (A: dS^T slab wg, B: K's one slab)
    const int a_slab = BM == 128 ? wg : 0, b_slab = D == 128 ? wg : 0;
    float dva[D / 2], dka[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dva[i] = dka[i] = 0.f;
    mbar_wait(bar_kv, 0);

    int st = 0, it = 0;
    uint32_t phase = 0, dq_phase = 1;   // the staging is free at first
    for (int hh = 0; hh < group; ++hh) {
      for (int m = n_mt - 1; m >= m0; --m, ++it) {
        const int h = hk * group + hh, q0 = m * BM;
        const uint32_t sQ = base + T::OFF_Q + st * T::Q_BYTES;
        const uint32_t sDO = base + T::OFF_DO + st * T::Q_BYTES;
        const uint32_t sDS = base + T::OFF_DS + (it & 1) * T::DS_BYTES;
        const uint32_t stat = base + T::OFF_STAT + st * T::STAT_BYTES;
        mbar_wait(bar_full + 8 * st, phase);

        // S^T = K Q^T and dP^T = V dO^T: 64 keys x BM queries, over D
        float s_acc[BM / 2], dp_acc[BM / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk >> 2) * T::KV_SLAB + (kk & 3) * 32;
          const uint32_t qoff = (kk >> 2) * T::Q_SLAB + (kk & 3) * 32;
          wgmma_ss<BM, 0, 0>(
              s_acc, sw128_desc(base + T::OFF_K + off + wg * 64 * 128, 16),
              sw128_desc(sQ + qoff, 16), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t off = (kk >> 2) * T::KV_SLAB + (kk & 3) * 32;
          const uint32_t qoff = (kk >> 2) * T::Q_SLAB + (kk & 3) * 32;
          wgmma_ss<BM, 0, 0>(
              dp_acc, sw128_desc(base + T::OFF_V + off + wg * 64 * 128, 16),
              sw128_desc(sDO + qoff, 16), kk > 0);
        }
        wgmma_commit();

        // P^T from lse2, masked by index where the tile crosses the causal
        // diagonal or the last key
        const bool edge =
            k0 + BN > skv || (causal && k0 + BN - 1 > q0 + diag);
        wgmma_wait<1>();
        fence_regs(s_acc);
#pragma unroll
        for (int j = 0; j < BM / 8; ++j) {
          const float2 l2 = ld_shared_f2(stat + (8 * j + 2 * q4) * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float l = (e & 1) ? l2.y : l2.x;
            float p = ex2(fmaf(s_acc[4 * j + e], scale_log2, -l));
            if (edge) {
              const int kr = key + 8 * (e >> 1);
              const int qc = q0 + 8 * j + 2 * q4 + (e & 1);
              if (kr >= skv || (causal && kr > qc + diag)) p = 0.f;
            }
            s_acc[4 * j + e] = p;
          }
        }
        wgmma_wait<0>();
        fence_regs(dp_acc);
#pragma unroll
        for (int j = 0; j < BM / 8; ++j) {
          const float2 dl = ld_shared_f2(stat + (BM + 8 * j + 2 * q4) * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp_acc[4 * j + e] = s_acc[4 * j + e] *
                                (dp_acc[4 * j + e] - ((e & 1) ? dl.y : dl.x));
        }
        // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16 as
        // the A operand from registers (B MN-major: queries are the rows
        // of the Q and dO tiles)
        uint32_t pa[BM / 4], dsa[BM / 4];
        acc_to_afrag<BM / 16>(pa, s_acc);
        acc_to_afrag<BM / 16>(dsa, dp_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)
          wgmma_rs<D, 1>(dva, pa + 4 * kk,
                         sw128_desc(sDO + kk * 2048, T::Q_SLAB));
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)
          wgmma_rs<D, 1>(dka, dsa + 4 * kk,
                         sw128_desc(sQ + kk * 2048, T::Q_SLAB));
        wgmma_commit();
        // meanwhile dS^T into shared memory for dQ: row dsrow (+ 8),
        // queries 8 j + 2 q4 (+ 1), 128-byte swizzle
#pragma unroll
        for (int j = 0; j < BM / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = dsrow + 8 * i;
            st_shared_u32(sDS + (j >> 3) * T::DS_SLAB + r * 128 +
                              (((j & 7) ^ (r & 7)) << 4) + q4 * 4,
                          dsa[2 * j + i]);
          }
        fence_proxy_async();
        named_bar_sync(1, 256);   // both halves of dS^T are in

        // dQ = dS K (A and B MN-major), this warpgroup's 64 x 64 piece
        float dqa[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          wgmma_ss<64, 1, 1>(
              dqa,
              sw128_desc(sDS + a_slab * T::DS_SLAB + kk * 2048, T::DS_SLAB),
              sw128_desc(base + T::OFF_K + b_slab * T::KV_SLAB + kk * 2048,
                         T::KV_SLAB),
              kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(dva);
        fence_regs(dka);
        fence_regs(pa);
        fence_regs(dsa);
        mbar_arrive(bar_empty + 8 * st);   // this thread is done with the stage
        if (++st == ST) st = 0, phase ^= 1;
        wgmma_wait<0>();
        fence_regs(dqa);

        // the piece to shared memory once the writer is done with the
        // previous tile's, each thread's 4 values of an 8-column chunk as
        // one float4 (the accumulator's tile layout, which
        // fa_bwd_post_bf16 reads back); the writer adds it
        const uint32_t stage_dq = base + T::OFF_DQ + wg * T::DQ_BYTES;
        mbar_wait(bar_dq + 16, dq_phase);
        dq_phase ^= 1;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          st_shared_f4(stage_dq + (j * 128 + t) * 16, dqa[4 * j],
                       dqa[4 * j + 1], dqa[4 * j + 2], dqa[4 * j + 3]);
        fence_proxy_async();
        mbar_arrive(bar_dq + 8 * wg);
      }
    }

    // dK / sqrt(D) and dV in bf16 through shared memory (K, V and the ring
    // are free once both warpgroups are past their last product)
    named_bar_sync(1, 256);
    unsigned char* epi = sbase + 2 * wg * 64 * T::EPI_PITCH;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int off =
            (16 * warp + g + 8 * i) * T::EPI_PITCH + (8 * j + 2 * q4) * 2;
        *reinterpret_cast<uint32_t*>(epi + off) = pack_bf16(
            dka[4 * j + 2 * i] * scale, dka[4 * j + 2 * i + 1] * scale);
        *reinterpret_cast<uint32_t*>(epi + 64 * T::EPI_PITCH + off) =
            pack_bf16(dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
      }
    named_bar_sync(2 + wg, 128);
    constexpr int CH = D / 8;   // 16-byte chunks a row
    for (int i = t; i < 2 * 64 * CH; i += 128) {
      const int which = i / (64 * CH), r = (i / CH) % 64, c = i % CH;
      const int kr = k0 + 64 * wg + r;
      if (kr < skv) {
        bf16* out = which ? dv : dk;
        const size_t at = (((size_t)b * skv + kr) * hkv + hk) * D + c * 8;
        *reinterpret_cast<uint4*>(out + at) = *reinterpret_cast<const uint4*>(
            epi + (which * 64 + r) * T::EPI_PITCH + c * 16);
      }
    }
  }
}

// dQ = accumulator / sqrt(D) in bf16: the tile's pieces back to (row,
// column) through shared memory, then 16-byte stores of rows below sq.
template <int D>
__global__ void __launch_bounds__(256) fa_bwd_post_bf16(
    const float* __restrict__ dq_acc, bf16* __restrict__ dq, int sq, int hq,
    float scale) {
  constexpr int BM = BwdTiles<D>::BM, P = D + 4;
  __shared__ float tile[BM * P];
  const int bh = blockIdx.x, m = blockIdx.y;
  const int b = bh / hq, h = bh - b * hq;
  const float4* src = reinterpret_cast<const float4*>(
      dq_acc + ((size_t)bh * gridDim.y + m) * BM * D);
  for (int i = threadIdx.x; i < BM * D / 4; i += 256) {
    // piece w, chunk j, consumer thread t (fa_bwd_main_bf16's layout)
    const int w = i >> 10, j = (i >> 7) & 7, t = i & 127;
    const int row = (BM == 128 ? 64 * w : 0) + 16 * (t >> 5) + ((t & 31) >> 2);
    const int col = (D == 128 ? 64 * w : 0) + 8 * j + 2 * (t & 3);
    const float4 x = src[i];
    tile[row * P + col] = x.x;
    tile[row * P + col + 1] = x.y;
    tile[(row + 8) * P + col] = x.z;
    tile[(row + 8) * P + col + 1] = x.w;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * D / 8; i += 256) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int row = m * BM + r;
    if (row < sq) {
      const float* x = tile + r * P + c;
      uint4 out;
      out.x = pack_bf16(x[0] * scale, x[1] * scale);
      out.y = pack_bf16(x[2] * scale, x[3] * scale);
      out.z = pack_bf16(x[4] * scale, x[5] * scale);
      out.w = pack_bf16(x[6] * scale, x[7] * scale);
      *reinterpret_cast<uint4*>(dq + (((size_t)b * sq + row) * hq + h) * D +
                                c) = out;
    }
  }
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
  if (attr != cudaSuccess)
    return launch_fail((int)attr, "float32 backward: %d bytes of shared "
                       "memory refused: %s", smem, cudaGetErrorString(attr));
  kernel<<<grid, FB_THREADS, smem, st>>>(args...);
  return launch_check("float32 backward launch");
}

// bf16: the preprocess, main and postprocess launches; `block_m` and
// `smem` are bwd_plan(d)'s, refused when they disagree with BwdTiles<D>.
template <int D>
static int launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                       const bf16* o, const bf16* dout, const float* lse,
                       float* stats, float* dq_acc, int* dq_sem, bf16* dq,
                       bf16* dk, bf16* dv, int b, int sq, int skv, int hq,
                       int hkv, int causal, int block_m, int smem,
                       cudaStream_t st) {
  using T = BwdTiles<D>;
  if (block_m != T::BM || smem != T::SMEM)
    return launch_fail((int)cudaErrorInvalidValue,
                       "plan (block_m %d, %d shared bytes) disagrees with "
                       "BwdTiles<%d> (%d, %d)", block_m, smem, D, T::BM,
                       T::SMEM);
  const float scale = (float)(1.0 / sqrt((double)D));
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  CUtensorMap tq, tk, tv, tdo;
  int err;
  if ((err = bind_primary_context()) ||
      (err = head_rows_map(&tq, "q", q, b, sq, hq, D, T::BM)) ||
      (err = head_rows_map(&tdo, "do", dout, b, sq, hq, D, T::BM)) ||
      (err = head_rows_map(&tk, "k", k, b, skv, hkv, D, T::BN)) ||
      (err = head_rows_map(&tv, "v", v, b, skv, hkv, D, T::BN)))
    return err;
  const dim3 rows(b * hq, (sq + T::BM - 1) / T::BM);
  fa_bwd_pre_bf16<D><<<rows, 256, 0, st>>>(o, dout, lse, stats, dq_acc,
                                           dq_sem, sq, hq);
  if ((err = launch_check("preprocess launch"))) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fa_bwd_main_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (attr != cudaSuccess)
    return launch_fail((int)attr, "main pass: %d bytes of shared memory "
                       "refused: %s", T::SMEM, cudaGetErrorString(attr));
  // a group's rows fastest, then its key blocks, then the groups
  const int kv_rows = b * hkv;
  const int per_group = kv_rows < T::GROUP ? kv_rows : T::GROUP;
  fa_bwd_main_bf16<D><<<dim3(per_group, (skv + T::BN - 1) / T::BN,
                             (kv_rows + per_group - 1) / per_group),
                        T::THREADS, T::SMEM, st>>>(
      tq, tk, tv, tdo, stats, dq_acc, dq_sem, dk, dv, kv_rows, sq, skv, hq,
      hkv, causal, scale_log2, scale);
  if ((err = launch_check("main pass launch"))) return err;
  fa_bwd_post_bf16<D><<<rows, 256, 0, st>>>(dq_acc, dq, sq, hq, scale);
  return launch_check("dQ cast launch");
}

template <int D>
static int launch_f32(const float* q, const float* k, const float* v,
                      const float* o, const float* dout, const float* lse,
                      float* delta, float* dq, float* dk, float* dv, int b,
                      int sq, int skv, int hq, int hkv, int causal,
                      cudaStream_t st) {
  const float scale = (float)(1.0 / sqrt((double)D));
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
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

// dtype 0: float32 (two launches: the dQ kernel, which also writes
// `delta`, (B, Hq, Sq) float32 scratch, then the dK/dV kernel), 1:
// bfloat16 (three launches; `delta` is the (B, Hq, Sq_pad / block_m, 2,
// block_m) lse2 / Delta scratch, `dq_acc` the (B, Hq, Sq_pad, d) float32
// accumulator and `dq_sem` the (B, Hq, Sq_pad / block_m) int32 counters
// of its tiles, Sq_pad = Sq rounded up to `block_m`; float32 takes no
// `dq_acc` or `dq_sem`); d in {64, 128}.  q, o, dout, dq (B, Sq, Hq,
// d), k, v, dk, dv (B, Skv, Hkv, d) contiguous and 16-byte aligned, lse
// (B, Hq, Sq) float32.  All on `stream`; returns 0 or a CUDA error (a
// refused launch, a tensor map cuTensorMapEncodeTiled refuses, a plan
// that disagrees; `launch_why` says which).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq_acc,
    void* dq_sem, void* dq, void* dk, void* dv, int b, int sq, int skv,
    int hq, int hkv,
    int d, int causal, int dtype, int block_m, int smem, void* stream) {
  const LaunchScope scope;
  cudaStream_t st = (cudaStream_t)stream;
#define FB_BF16                                                              \
  (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,            \
      (const bf16*)dout, (const float*)lse, (float*)delta, (float*)dq_acc,   \
      (int*)dq_sem, (bf16*)dq, (bf16*)dk, (bf16*)dv, b, sq, skv, hq, hkv,    \
      causal, block_m, smem, st
#define FB_F32                                                               \
  (const float*)q, (const float*)k, (const float*)v, (const float*)o,        \
      (const float*)dout, (const float*)lse, (float*)delta, (float*)dq,      \
      (float*)dk, (float*)dv, b, sq, skv, hq, hkv, causal, st
  if (dtype == 1 && d == 64) return launch_bf16<64>(FB_BF16);
  if (dtype == 1 && d == 128) return launch_bf16<128>(FB_BF16);
  if (dtype == 0 && d == 64) return launch_f32<64>(FB_F32);
  if (dtype == 0 && d == 128) return launch_f32<128>(FB_F32);
#undef FB_BF16
#undef FB_F32
  return launch_fail((int)cudaErrorInvalidValue, "no instance for dtype %d "
                     "at d = %d", dtype, d);
}
