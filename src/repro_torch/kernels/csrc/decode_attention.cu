// Decode attention for Hopper (sm_90a): one query token per head against a
// KV cache, one device kernel a call.
//
// Replaces the Pallas TPU kernel `decode_attention` of
// src/repro/kernels/decode_attention.py (function at :69, pallas_call at
// :103): for batch row b and query head h, o = softmax(q k^T / sqrt(D)) v
// over keys 0 .. kv_len[b] - 1 of key/value head h / (Hq / Hkv), with
// q (B, Hq, D) in float32 or bfloat16 and k, v (B, Hkv, S, D) in q's dtype
// or in float8_e4m3fn (the reference's `cache_dtype="float8_e4m3fn"`,
// which it casts to q's dtype, exactly, before attending); scores,
// exponentials and sums in float32, the output in q's dtype, and
// acc / max(l, 1e-30) at the end, so a row with kv_len = 0 comes out as
// zeros (the TPU kernel's value; the reference's oracle gives the mean of
// V there).  Its callers are the LM decode step (one launch per attention
// layer per generated token) and one-token cross-attention.
//
// What bounds it: the cache.  2·B·Hkv·kv_len·D elements are read once
// (3.35 TB/s on the H100 SXM) against 4·G·D operations per (KV head,
// key) for a group of G query heads: 16 flops a byte at G = 16 in
// bfloat16, 32 in float8, more than the float32 pipes give (~20 a byte),
// so the products run on the tensor cores.
//
// Design.  The TPU kernel walks key blocks in the sequential last grid
// axis for each (batch, query head) and carries (m, l, acc) in VMEM.  Here
// a block serves one (batch, KV head), ALL of its G query heads (a chunk
// of up to 16, the rows of one mma tile; G > 16 takes several chunks) and
// one key range, so the cache is read once per KV head:
//
// * Keys.  The key range is cut into steps of 16 keys; warp w of the
//   block's WARPS takes steps w, w + WARPS, ... and streams them through
//   its own ring of STAGES slots in shared memory with 16-byte cp.async
//   copies (L2::128B prefetch; zero-filled past the range), STAGES - 1
//   steps in flight.  A warp waits only for its own copies
//   (cp.async.wait_group + __syncwarp): no block barrier in the loop.  The
//   first steps are in flight before the query rows are staged.  k and v
//   are strided views (element strides of the batch, head and sequence
//   axes), so the model's (B, S, Hkv, D) cache is read in place.  TMA is
//   not used: a tensor map for the strided view would be built on the
//   host each call (cuTensorMapEncode), and one-row bulk copies
//   (cp.async.bulk, no tensor map) were slower than cp.async when tried.
// * bfloat16 q (tensor cores, 8 warps, one block an SM at D = 128).  The
//   group's rows, padded to 16 with zeros, are the A operand of
//   mma.sync.m16n8k16 (fragments read once by ldmatrix); S = Q K^T for 16
//   keys is two 16 x 8 products per 16 dims (even and odd dims in two
//   accumulators), K's fragments read by ldmatrix, and the online softmax
//   runs on the accumulator fragments (base 2, log2(e) / sqrt(D) folded
//   in).  P stays float32 as in the TPU kernel and the reference's
//   oracle: it is split into a 16-bit hi and lo = p - hi, and O += P V is
//   two products (V by ldmatrix.trans), which the bytes bound hides.  A
//   float8_e4m3fn cache is converted in shared memory, 16 elements a lane
//   at a time (cvt.rn.f16x2.e4m3x2, exact), into float16 tiles, and the
//   products run in float16.  Each query row is first scaled by the power
//   of two that brings its largest magnitude into [2^14, 2^15), so its
//   bfloat16 values round to float16 exactly (every element within 2^31
//   of the row's largest; none overflows), and its scores are scaled back
//   in float32; P carries an offset of 2^10 (l and acc alike, so their
//   ratio is unchanged) so that its float16 hi + lo keep float32's
//   precision down to 2^-34.
// * float32 q (FMA, 4 warps).  Lane (key j, half h) computes the scores
//   of key j for query rows h, h + 2, ... from the shared tiles; the row
//   maxima meet by shuffles, the probabilities go through a 16 x 16
//   shared tile, and each lane adds P V for its own D / 32 dims: float32
//   throughout, as the 3e-5 tolerance asks.  A float8 cache is converted
//   on the fly.
// * Splits, merged in the launch.  The key range of one (batch, KV head,
//   chunk) is split into `splits` <= 8 ranges whose blocks form one
//   thread-block cluster.  Each block merges its warps' (m, l, acc)
//   through shared memory (per row the weights once, then 4 floats at a
//   time); a block that is its own cluster writes the output.  Otherwise,
//   after cluster.sync(), the blocks merge the cluster's rows from
//   distributed shared memory (cluster_group::map_shared_rank, as
//   topk_cluster.cuh), each its share of the (row, 4 dims) chunks with
//   every remote load issued before it is used, and write the output; a
//   second cluster.sync() keeps every block's shared memory alive until
//   then.  A split past a row's kv_len takes part with l = 0.  No
//   scratch, no second kernel.  The split count comes from the host's
//   plan (kernels/decode_attention.py: `plan`), which reads the clusters
//   of each size the card holds at once from decode_attention_clusters
//   below: a merge costs two cluster barriers and the remote reads, so a
//   plan splits only while SMs would otherwise sit idle.
//
// The running max starts at -1e30, not -inf, so a fully masked tile gives
// exp2(-inf) = 0 and not NaN; a NaN score is dropped by fmaxf but reaches
// l and acc through exp2(NaN), so a NaN in q still gives a NaN row.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define DA_ROWS 16              // query heads a block: one mma tile's rows
#define DA_KW 16                // keys a warp step
#define DA_CLUSTER_MAX 8        // splits a cluster: the portable size
#define DA_NEG -1e30f           // the running max before any key

typedef __nv_bfloat16 bf16;
struct fp8e4m3 {                // a float8_e4m3fn cache element
  unsigned char bits;
};

// The shared-memory layout of an instance (bytes).  Per warp: a ring of
// STAGES slots of 16 K rows and 16 V rows at PITCH bytes a row; with a
// float8 cache and bfloat16 q, the float16 tiles it is converted into
// (P16 a row); with float32 q, the 16 x 16 probability tile.  In front, the
// query rows (16-bit at P16 a row for the tensor cores, else float32),
// with a float8 cache and bfloat16 q followed by the rows' score scales.
// After the loop the same memory holds the merge: every warp's and the
// block's (acc, m, l) of the 16 rows.
template <typename TQ, typename TC, int D>
struct Geo {
  static constexpr bool MMA = sizeof(TQ) == 2;
  static constexpr bool F8 = sizeof(TC) == 1;
  // warps a block: 8 on the tensor cores (one block an SM streams the
  // cache with 8 warps' steps in flight), 4 for float32 q (its larger
  // tiles)
  static constexpr int WARPS = MMA ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int TILE = WARPS * DA_KW;        // keys a block step
  // ring slots a warp: two (a third was slower at the LM paths' 544-key
  // rows and no faster at 32k); a float8 slot is half the bytes
  static constexpr int STAGES = F8 ? 4 : 2;
  static constexpr int ROW = D * (int)sizeof(TC);   // bytes of a cache row
  static constexpr int CH = ROW / 16;               // its 16-byte chunks
  // an odd number of 16-byte chunks: ldmatrix reads free of bank conflicts
  static constexpr int P16 = 16 * ((D / 8) | 1);
  static constexpr int PITCH = MMA ? (F8 ? ROW : P16) : ROW + 16;
  static constexpr int SLOT = 2 * DA_KW * PITCH;
  static constexpr int CONV = MMA && F8 ? 2 * DA_KW * P16 : 0;
  static constexpr int PROBS = MMA ? 0 : DA_ROWS * (DA_KW + 1) * 4;
  static constexpr int WARP = STAGES * SLOT + CONV + PROBS;
  static constexpr int QSCALE = MMA && F8 ? DA_ROWS * P16 : 0;
  static constexpr int QBYTES =
      MMA ? DA_ROWS * P16 + (F8 ? DA_ROWS * 4 : 0) : DA_ROWS * D * 4;
  static constexpr int LOOP = QBYTES + WARPS * WARP;
  static constexpr int MP = D + 4;                  // floats a merge row
  static constexpr int MERGE =
      4 * DA_ROWS * ((WARPS + 1) * (MP + 2) + WARPS + 1);
  static constexpr int SMEM = LOOP > MERGE ? LOOP : MERGE;
  static_assert(SMEM <= 232448, "past a block's shared memory");
  static_assert(CH >= 1 && ROW % 16 == 0, "unsupported head width");
};

// The merge area: warp w's rows at acc[w], the block's at acc[warps],
// their running max (base-2 units) and sums; per row the merge weights of
// the warps and 1 / max(l, 1e-30).
struct Merge {
  float* acc;   // [warps + 1][16][mp]
  float* m;     // [warps + 1][16]
  float* l;     // [warps + 1][16]
  float* f;     // [warps][16]
  float* inv;   // [16]
  int mp;
  __device__ __forceinline__ Merge(unsigned char* smem, int warps, int mp_)
      : mp(mp_) {
    acc = reinterpret_cast<float*>(smem);
    m = acc + (warps + 1) * DA_ROWS * mp;
    l = m + (warps + 1) * DA_ROWS;
    f = l + (warps + 1) * DA_ROWS;
    inv = f + warps * DA_ROWS;
  }
  __device__ __forceinline__ float* row(int w, int r) const {
    return acc + (w * DA_ROWS + r) * mp;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-filled (nothing read) when !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile(
      "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(dst),
      "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, float32) += a (16 x 16) b (16 x 8), in float16 or bfloat16
template <bool F16>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if constexpr (F16) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// (lo, hi) rounded to nearest into one 32-bit pair, and back (in
// registers: cvt.rn.{f16x2,bf16x2}.f32 puts its first source in the upper
// half)
template <bool F16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  if constexpr (F16)
    asm("cvt.rn.f16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  else
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
template <bool F16>
__device__ __forceinline__ float2 unpack2(uint32_t x) {
  float2 r;
  if constexpr (F16) {
    asm("{.reg .f16 a, b;\n mov.b32 {a, b}, %2;\n cvt.f32.f16 %0, a;\n"
        " cvt.f32.f16 %1, b;}\n"
        : "=f"(r.x), "=f"(r.y)
        : "r"(x));
  } else {
    r.x = __uint_as_float(x << 16);
    r.y = __uint_as_float(x & 0xffff0000u);
  }
  return r;
}

// (x0, x1) = hi + lo: hi rounded to 16 bits, lo the remainder rounded
// likewise, so hi + lo keeps ~16 (bfloat16) or ~22 (float16) bits
template <bool F16>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack2<F16>(x0, x1);
  const float2 h = unpack2<F16>(hi);
  lo = pack2<F16>(x0 - h.x, x1 - h.y);
}

// two float8_e4m3fn (the low 16 bits, the lower byte first) -> float16x2,
// exact (Hopper's cvt; NaN stays NaN)
__device__ __forceinline__ uint32_t e4m3x2_to_f16x2(uint32_t two) {
  uint32_t h;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n"
      : "=r"(h)
      : "h"((unsigned short)(two & 0xffffu)));
  return h;
}

__device__ __forceinline__ float ex2(float x) {   // ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void axpy4(float4& a, float f, const float4& x) {
  a.x = fmaf(f, x.x, a.x);
  a.y = fmaf(f, x.y, a.y);
  a.z = fmaf(f, x.z, a.z);
  a.w = fmaf(f, x.w, a.w);
}

// 4 output elements a * s, 16 (float32) or 8 (bfloat16) bytes at once
__device__ __forceinline__ void store4(float* p, const float4& a, float s) {
  *reinterpret_cast<float4*>(p) = make_float4(a.x * s, a.y * s, a.z * s,
                                              a.w * s);
}
__device__ __forceinline__ void store4(bf16* p, const float4& a, float s) {
  uint2 u;
  u.x = pack2<false>(a.x * s, a.y * s);
  u.y = pack2<false>(a.z * s, a.w * s);
  *reinterpret_cast<uint2*>(p) = u;
}

// Four consecutive cache elements from shared memory as float32.
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x;
  x[1] = t.y;
  x[2] = t.z;
  x[3] = t.w;
}
__device__ __forceinline__ void load4(const fp8e4m3* p, float (&x)[4]) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  const float2 a = unpack2<true>(e4m3x2_to_f16x2(w));
  const float2 b = unpack2<true>(e4m3x2_to_f16x2(w >> 16));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const fp8e4m3* p) {
  return unpack2<true>(e4m3x2_to_f16x2(p->bits)).x;
}

// Step `step` of this warp (16 keys from t0) into the ring slot at `dst`:
// K rows, then V rows; rows at or past t_end are zero-filled.
template <int PITCH, int CH>
__device__ __forceinline__ void issue_step(uint32_t dst,
                                           const unsigned char* kb,
                                           const unsigned char* vb,
                                           long long k_row, long long v_row,
                                           int t0, int t_end, int lane) {
#pragma unroll 4
  for (int i = lane; i < DA_KW * CH; i += 32) {
    const int r = i / CH, c = i - r * CH;
    const bool ok = t0 + r < t_end;
    const long long t = ok ? t0 + r : t0;   // a row inside the cache
    cp_async16(dst + r * PITCH + c * 16, kb + t * k_row + c * 16, ok);
    cp_async16(dst + (DA_KW + r) * PITCH + c * 16, vb + t * v_row + c * 16,
               ok);
  }
}

// A warp's ring of STAGES slots (each 16 K rows then 16 V rows, PITCH
// bytes apart), filled by cp.async and waited for by the warp alone.
template <typename G>
struct Ring {
  uint32_t base;
  const unsigned char *kb, *vb;
  long long k_row, v_row;
  int t_end, lane;

  // step i (16 keys from t0) into slot i % STAGES; `real` false copies
  // nothing but still commits a group, to keep the count uniform
  __device__ __forceinline__ void issue(int i, int t0, bool real) {
    if (real)
      issue_step<G::PITCH, G::CH>(base + (i % G::STAGES) * G::SLOT, kb, vb,
                                  k_row, v_row, t0, t_end, lane);
    cp_async_commit();
  }
  // the oldest step in flight has landed, and every lane of the warp sees it
  __device__ __forceinline__ void wait() {
    cp_async_wait<G::STAGES - 1>();   // this lane's copies
    __syncwarp();                     // ... and every lane's
  }
};

// A slot's 32 float8 rows (K then V, PITCH bytes apart) into float16
// rows P16 bytes apart: 16 elements a lane at a time.
template <int D, int PITCH, int P16>
__device__ __forceinline__ void convert_slot(const unsigned char* src,
                                             unsigned char* dst, int lane) {
  constexpr int CH = D / 16;
#pragma unroll 4
  for (int i = lane; i < 2 * DA_KW * CH; i += 32) {
    const int r = i / CH, c = i - r * CH;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * PITCH + c * 16);
    uint4 lo, hi;
    lo.x = e4m3x2_to_f16x2(raw.x);
    lo.y = e4m3x2_to_f16x2(raw.x >> 16);
    lo.z = e4m3x2_to_f16x2(raw.y);
    lo.w = e4m3x2_to_f16x2(raw.y >> 16);
    hi.x = e4m3x2_to_f16x2(raw.z);
    hi.y = e4m3x2_to_f16x2(raw.z >> 16);
    hi.z = e4m3x2_to_f16x2(raw.w);
    hi.w = e4m3x2_to_f16x2(raw.w >> 16);
    uint4* out = reinterpret_cast<uint4*>(dst + r * P16 + c * 32);
    out[0] = lo;
    out[1] = hi;
  }
}

// Fragment rows of a lane: g = lane / 4 and g + 8; the accumulator element
// e of an 8-column tile is row g + 8 (e / 2), column 2 (lane % 4) + e % 2.
// One step of the online softmax for the lane's two rows: s becomes p
// (float32) in place; m (raw scores), l (the lane's partial row sums) and
// acc are rescaled to the new running max.
// P comes out 2^bias times the probabilities (l and acc alike).
template <int DT>
__device__ __forceinline__ void softmax_step(float (&s)[2][4], float (&m)[2],
                                             float (&l)[2],
                                             float (&acc)[DT][4],
                                             float scale, float bias) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = fmaxf(m[h], fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                                 fmaxf(s[1][2 * h], s[1][2 * h + 1])));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = ex2((m[h] - mx) * scale);   // 0 on the first key
    const float off = bias - mx * scale;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        const float p = ex2(fmaf(s[j][e], scale, off));   // NaN stays NaN
        s[j][e] = p;
        sum += p;
      }
    l[h] = l[h] * corr + sum;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][2 * h] *= corr;
      acc[n][2 * h + 1] *= corr;
    }
    m[h] = mx;
  }
}

// The tensor-core loop of one warp (bfloat16 q; TC bfloat16 or float8):
// every step's 16 keys against the block's 16 query rows, then the warp's
// (acc, m, l) of the first `rows` rows into the merge area.
template <typename TC, int D>
__device__ __forceinline__ void mma_warp(unsigned char* smem,
                                         Ring<Geo<bf16, TC, D>>& ring,
                                         int first, int steps, int t_end,
                                         int rows, float scale) {
  using G = Geo<bf16, TC, D>;
  constexpr bool F16 = G::F8;   // a float8 cache: products in float16
  constexpr int KS = D / 16, DT = D / 8, P16 = G::P16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mi = lane >> 3, r8 = lane & 7;   // ldmatrix: matrix, its row
  unsigned char* wbase = smem + G::QBYTES + warp * G::WARP;
  const uint32_t s_ring = smem_addr(wbase);
  const uint32_t s_conv = s_ring + G::STAGES * G::SLOT;

  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm_x4(qa[ks], smem_addr(smem) + ((mi & 1) * 8 + r8) * P16 +
                        (ks * 16 + (mi >> 1) * 8) * 2);
  float acc[DT][4], m[2] = {DA_NEG, DA_NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < DT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // float16 products: the lane's two rows' score scales 2^e, P offset 2^10
  float qs[2] = {1.f, 1.f};
  if constexpr (F16) {
    const float* rs = reinterpret_cast<const float*>(smem + G::QSCALE);
    qs[0] = rs[lane >> 2];
    qs[1] = rs[(lane >> 2) + 8];
  }
  constexpr float bias = F16 ? 10.f : 0.f;

  for (int i = 0; i < steps; ++i) {
    const int ahead = i + G::STAGES - 1;   // into the slot freed last step
    ring.issue(ahead, first + ahead * G::TILE, ahead < steps);
    ring.wait();
    const int slot = i % G::STAGES;
    uint32_t sk = s_ring + slot * G::SLOT, sv = sk + DA_KW * G::PITCH;
    if constexpr (G::F8) {
      convert_slot<D, G::PITCH, P16>(wbase + slot * G::SLOT,
                                     wbase + G::STAGES * G::SLOT, lane);
      __syncwarp();
      sk = s_conv;
      sv = s_conv + DA_KW * P16;
    }
    // S = Q K^T: keys 0-7 and 8-15 of the step, the even and the odd
    // 16-dim steps in two accumulators (two chains of KS / 2 products)
    float s[2][4], s2[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s2[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t kf[4];
      ldsm_x4(kf, sk + ((mi >> 1) * 8 + r8) * P16 +
                      (ks * 16 + (mi & 1) * 8) * 2);
      float (&acc_s)[2][4] = ks & 1 ? s2 : s;
      mma16<F16>(acc_s[0], qa[ks], kf[0], kf[1]);
      mma16<F16>(acc_s[1], qa[ks], kf[2], kf[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = (s[j][e] + s2[j][e]) * qs[e >> 1];
    const int t0 = first + i * G::TILE;
    if (t0 + DA_KW > t_end) {       // the range's ragged end
      const int c0 = t0 + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + j * 8 + (e & 1) >= t_end) s[j][e] = -INFINITY;
    }
    softmax_step<DT>(s, m, l, acc, scale, bias);
    // O += P V with P = hi + lo: the accumulator layout of the two 8-key
    // score tiles is the A layout of one 16-key step
    uint32_t ph[4], pl[4];
    split2<F16>(s[0][0], s[0][1], ph[0], pl[0]);
    split2<F16>(s[0][2], s[0][3], ph[1], pl[1]);
    split2<F16>(s[1][0], s[1][1], ph[2], pl[2]);
    split2<F16>(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int n = 0; n < DT; n += 2) {
      uint32_t vf[4];
      ldsm_x4_t(vf, sv + ((mi & 1) * 8 + r8) * P16 + (n + (mi >> 1)) * 16);
      mma16<F16>(acc[n], pl, vf[0], vf[1]);
      mma16<F16>(acc[n + 1], pl, vf[2], vf[3]);
      mma16<F16>(acc[n], ph, vf[0], vf[1]);
      mma16<F16>(acc[n + 1], ph, vf[2], vf[3]);
    }
    __syncwarp();                   // the slot is free for step i + STAGES
  }
  cp_async_wait<0>();
  __syncthreads();                  // every warp is out of the ring

  const Merge mg(smem, G::WARPS, G::MP);
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lsum = l[h];
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    const int r = g + 8 * h;
    if (r < rows) {
      float* out = mg.row(warp, r);
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        out[n * 8 + 2 * tig] = acc[n][2 * h];
        out[n * 8 + 2 * tig + 1] = acc[n][2 * h + 1];
      }
      if (tig == 0) {
        mg.m[warp * DA_ROWS + r] = m[h] * scale;
        mg.l[warp * DA_ROWS + r] = lsum;
      }
    }
  }
}

// The float32 loop of one warp (float32 q; TC float32 or float8): lane
// (key j = lane % 16, half hh = lane / 16) scores key j for rows hh,
// hh + 2, ...; the running (m, l) of every row are kept by every lane, and
// lane x accumulates dims x·DPL .. x·DPL + DPL - 1 of every row.
template <typename TC, int D>
__device__ __forceinline__ void fma_warp(unsigned char* smem,
                                         Ring<Geo<float, TC, D>>& ring,
                                         int first, int steps, int t_end,
                                         int rows, float scale) {
  using G = Geo<float, TC, D>;
  constexpr int DPL = D >= 32 ? D / 32 : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = lane & 15, hh = lane >> 4;
  const bool owns = lane * DPL < D;
  unsigned char* wbase = smem + G::QBYTES + warp * G::WARP;
  float* probs = reinterpret_cast<float*>(wbase + G::STAGES * G::SLOT);
  const float* sq = reinterpret_cast<const float*>(smem);

  float m[DA_ROWS], l[DA_ROWS], acc[DA_ROWS][DPL];
#pragma unroll
  for (int g = 0; g < DA_ROWS; ++g) {
    m[g] = DA_NEG;
    l[g] = 0.f;
#pragma unroll
    for (int u = 0; u < DPL; ++u) acc[g][u] = 0.f;
  }
  for (int i = 0; i < steps; ++i) {
    const int ahead = i + G::STAGES - 1;   // into the slot freed last step
    ring.issue(ahead, first + ahead * G::TILE, ahead < steps);
    ring.wait();
    const unsigned char* kt = wbase + (i % G::STAGES) * G::SLOT;
    const unsigned char* vt = kt + DA_KW * G::PITCH;
    const int t0 = first + i * G::TILE;

    float sc[DA_ROWS / 2];
#pragma unroll
    for (int r = 0; r < DA_ROWS / 2; ++r) sc[r] = 0.f;
    const TC* krow = reinterpret_cast<const TC*>(kt + j * G::PITCH);
    // the float8 D = 64 instance spills at two dims steps in flight
    constexpr int DU = sizeof(TC) == 1 && D == 64 ? 1 : 2;
#pragma unroll DU
    for (int d = 0; d < D; d += 4) {
      float kx[4];
      load4(krow + d, kx);
#pragma unroll
      for (int r = 0; r < DA_ROWS / 2; ++r) {
        if (hh + 2 * r < rows) {
          const float4 qv =
              *reinterpret_cast<const float4*>(sq + (hh + 2 * r) * D + d);
          sc[r] = fmaf(qv.x, kx[0], sc[r]);
          sc[r] = fmaf(qv.y, kx[1], sc[r]);
          sc[r] = fmaf(qv.z, kx[2], sc[r]);
          sc[r] = fmaf(qv.w, kx[3], sc[r]);
        }
      }
    }
    // each row's new running max, met across the 16 key lanes and the two
    // halves; (l, acc) rescaled to it at once
    const bool valid = t0 + j < t_end;
#pragma unroll
    for (int r = 0; r < DA_ROWS / 2; ++r) {
      if (!valid || hh + 2 * r >= rows) sc[r] = -INFINITY;
      float x = sc[r];
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
      const float y = __shfl_xor_sync(0xffffffffu, x, 16);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int g = 2 * r + e;
        const float mx = fmaxf(m[g], (hh == e) ? x : y);
        const float corr = ex2((m[g] - mx) * scale);
        l[g] *= corr;
#pragma unroll
        for (int u = 0; u < DPL; ++u) acc[g][u] *= corr;
        m[g] = mx;
      }
      const float mr = hh ? m[2 * r + 1] : m[2 * r];
      probs[(hh + 2 * r) * (DA_KW + 1) + j] = ex2((sc[r] - mr) * scale);
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < DA_ROWS; ++g) {
      if (g < rows) {
        float ps = 0.f;
#pragma unroll
        for (int jj = 0; jj < DA_KW; ++jj) ps += probs[g * (DA_KW + 1) + jj];
        l[g] += ps;
      }
    }
    if (owns) {
#pragma unroll 4
      for (int jj = 0; jj < DA_KW; ++jj) {
        const TC* vrow =
            reinterpret_cast<const TC*>(vt + jj * G::PITCH) + lane * DPL;
        float vx[DPL];
#pragma unroll
        for (int u = 0; u < DPL; ++u) vx[u] = load1(vrow + u);
#pragma unroll
        for (int g = 0; g < DA_ROWS; ++g) {
          if (g < rows) {
            const float p = probs[g * (DA_KW + 1) + jj];
#pragma unroll
            for (int u = 0; u < DPL; ++u) acc[g][u] = fmaf(p, vx[u], acc[g][u]);
          }
        }
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();
  __syncthreads();

  const Merge mg(smem, G::WARPS, G::MP);
#pragma unroll
  for (int g = 0; g < DA_ROWS; ++g) {
    if (g < rows) {
      if (owns) {
#pragma unroll
        for (int u = 0; u < DPL; ++u) mg.row(warp, g)[lane * DPL + u] = acc[g][u];
      }
      if (lane == 0) {
        mg.m[warp * DA_ROWS + g] = m[g] * scale;
        mg.l[warp * DA_ROWS + g] = l[g];
      }
    }
  }
}

// Grid: one block per (batch, KV head, chunk of 16 query heads, split),
// the splits of one (batch, KV head, chunk) a cluster along x.  Split r
// covers keys [r·span / splits, (r + 1)·span / splits) of the row's first
// kv_len.
template <typename TQ, typename TC, int D>
__global__ void __launch_bounds__(Geo<TQ, TC, D>::THREADS)
    decode_attention_kernel(
    const TQ* __restrict__ q, const TC* __restrict__ k,
    const TC* __restrict__ v, TQ* __restrict__ o, const int* __restrict__ lens,
    int kv_scalar, int hq, int hkv, int s, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    int chunks, int span, float scale) {
  using G = Geo<TQ, TC, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  int pair = blockIdx.x / splits;
  const int c = pair % chunks;
  pair /= chunks;
  const int hk = pair % hkv, b = pair / hkv;
  const int group = hq / hkv;
  const int h0 = hk * group + c * DA_ROWS;
  const int rows = min(DA_ROWS, group - c * DA_ROWS);
  int len = lens != nullptr ? lens[b] : kv_scalar;
  len = max(0, min(len, s));
  const int t_begin = (int)((long long)rank * span / splits);
  const int t_end = min(len, (int)((long long)(rank + 1) * span / splits));

  // every warp's first STAGES - 1 key steps in flight before the query
  // rows are staged, so that their latencies overlap
  const long long sz = (long long)sizeof(TC);
  const unsigned char* kb =
      reinterpret_cast<const unsigned char*>(k) + (b * k_sb + hk * k_sh) * sz;
  const unsigned char* vb =
      reinterpret_cast<const unsigned char*>(v) + (b * v_sb + hk * v_sh) * sz;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first = t_begin + warp * DA_KW;      // the warp's first key
  const int steps =
      first < t_end ? (t_end - first + G::TILE - 1) / G::TILE : 0;
  const uint32_t s_ring = smem_addr(smem + G::QBYTES + warp * G::WARP);
  Ring<G> ring{s_ring, kb, vb, k_ss * sz, v_ss * sz, t_end, lane};
#pragma unroll
  for (int i = 0; i < G::STAGES - 1; ++i)
    ring.issue(i, first + i * G::TILE, i < steps);

  // the chunk's query rows, zeros past `rows`
  const TQ* qb = q + ((size_t)b * hq + h0) * D;
  if constexpr (G::MMA && G::F8) {
    // bfloat16 -> float16, a warp a row: the row times 2^-e, e from its
    // largest finite magnitude (fmaxf skips NaN; a row of zeros, NaN or
    // infinities keeps e = 0), and 2^e kept for its scores
    float* rs = reinterpret_cast<float*>(smem + G::QSCALE);
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(qb);
    for (int r = warp; r < DA_ROWS; r += G::WARPS) {
      float mx = 0.f;
      for (int c = lane; c < D / 2 && r < rows; c += 32) {
        const float2 f = unpack2<false>(__ldg(qw + r * (D / 2) + c));
        mx = fmaxf(mx, fmaxf(fabsf(f.x), fabsf(f.y)));
      }
#pragma unroll
      for (int off = 16; off; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const int e = mx > 0.f && mx <= 3.4e38f ? max(ilogbf(mx) - 14, -110)
                                              : 0;
      const float down = ldexpf(1.f, -e);
      for (int c = lane; c < D / 2; c += 32) {
        uint32_t w = 0u;
        if (r < rows) {
          const float2 f = unpack2<false>(__ldg(qw + r * (D / 2) + c));
          w = pack2<true>(f.x * down, f.y * down);
        }
        *reinterpret_cast<uint32_t*>(smem + r * G::P16 + c * 4) = w;
      }
      if (lane == 0) rs[r] = ldexpf(1.f, e);
    }
  } else if constexpr (G::MMA) {
    constexpr int QC = D / 8;       // 16-byte chunks of a bfloat16 row
    for (int i = threadIdx.x; i < DA_ROWS * QC; i += G::THREADS) {
      const int r = i / QC, cc = i - r * QC;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows) x = __ldg(reinterpret_cast<const uint4*>(qb + r * D) + cc);
      *reinterpret_cast<uint4*>(smem + r * G::P16 + cc * 16) = x;
    }
  } else {
    constexpr int QC = D / 4;
    for (int i = threadIdx.x; i < DA_ROWS * QC; i += G::THREADS) {
      const int r = i / QC, cc = i - r * QC;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows) x = __ldg(reinterpret_cast<const float4*>(qb + r * D) + cc);
      *reinterpret_cast<float4*>(smem + (r * D + cc * 4) * 4) = x;
    }
  }
  __syncthreads();

  if constexpr (G::MMA)
    mma_warp<TC, D>(smem, ring, first, steps, t_end, rows, scale);
  else
    fma_warp<TC, D>(smem, ring, first, steps, t_end, rows, scale);
  __syncthreads();

  // the block's rows: its 4 warps merged (per row: weights once, then the
  // rows 4 floats at a time), written out when the block is its cluster
  const Merge mg(smem, G::WARPS, G::MP);
  constexpr int D4 = D / 4;
  float* bm = mg.m + G::WARPS * DA_ROWS;
  float* bl = mg.l + G::WARPS * DA_ROWS;
  if (threadIdx.x < rows) {
    const int g = threadIdx.x;
    float mx = DA_NEG * scale;
#pragma unroll
    for (int w = 0; w < G::WARPS; ++w) mx = fmaxf(mx, mg.m[w * DA_ROWS + g]);
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < G::WARPS; ++w) {
      const float f = exp2f(mg.m[w * DA_ROWS + g] - mx);
      mg.f[w * DA_ROWS + g] = f;
      lsum = fmaf(mg.l[w * DA_ROWS + g], f, lsum);
    }
    bm[g] = mx;
    bl[g] = lsum;
    mg.inv[g] = 1.f / fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  TQ* ob = o + ((size_t)b * hq + h0) * D;
  for (int idx = threadIdx.x; idx < rows * D4; idx += G::THREADS) {
    const int g = idx / D4, c = idx - g * D4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < G::WARPS; ++w)
      axpy4(a, mg.f[w * DA_ROWS + g],
            *reinterpret_cast<const float4*>(mg.row(w, g) + 4 * c));
    if (splits == 1)
      store4(ob + g * D + 4 * c, a, mg.inv[g]);
    else
      *reinterpret_cast<float4*>(mg.row(G::WARPS, g) + 4 * c) = a;
  }
  if (splits == 1) return;
  cluster.sync();     // every block's rows are in its shared memory

  // the cluster's splits merged from distributed shared memory: the (row,
  // 4 dims) chunks dealt over the cluster's blocks, each thread issuing
  // every remote load it needs (each rank's m, l and chunk) before it uses
  // one
  for (int idx = rank * G::THREADS + threadIdx.x; idx < rows * D4;
       idx += splits * G::THREADS) {
    const int g = idx / D4, c = idx - g * D4;
    const float* src = mg.row(G::WARPS, g) + 4 * c;
    float rm[DA_CLUSTER_MAX], rl[DA_CLUSTER_MAX];
    float4 x[DA_CLUSTER_MAX];
#pragma unroll
    for (int r = 0; r < DA_CLUSTER_MAX; ++r) {
      if (r < splits) {
        rm[r] = *cluster.map_shared_rank(bm + g, r);
        rl[r] = *cluster.map_shared_rank(bl + g, r);
        x[r] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(src, r));
      }
    }
    float mx = DA_NEG * scale;
#pragma unroll
    for (int r = 0; r < DA_CLUSTER_MAX; ++r)
      if (r < splits) mx = fmaxf(mx, rm[r]);
    float lsum = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < DA_CLUSTER_MAX; ++r) {
      if (r < splits) {
        const float f = exp2f(rm[r] - mx);
        lsum = fmaf(rl[r], f, lsum);
        axpy4(a, f, x[r]);
      }
    }
    store4(ob + g * D + 4 * c, a, 1.f / fmaxf(lsum, 1e-30f));
  }
  cluster.sync();     // no block leaves while another reads its rows
}

template <typename TQ, typename TC, int D>
struct Instance {
  // once per instance (and process): the launch needs it above 48 KB
  static cudaError_t attribute() {
    static const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<TQ, TC, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<TQ, TC, D>::SMEM);
    return e;
  }

  // clusters of `splits` blocks the card holds at once
  static int clusters(int splits) {
    const cudaError_t e = attribute();
    if (e != cudaSuccess) return -(int)e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(splits, 1, 1);
    cfg.blockDim = dim3(Geo<TQ, TC, D>::THREADS, 1, 1);
    cfg.dynamicSmemBytes = Geo<TQ, TC, D>::SMEM;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = splits;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int n = 0;
    const cudaError_t o = cudaOccupancyMaxActiveClusters(
        &n, decode_attention_kernel<TQ, TC, D>, &cfg);
    return o != cudaSuccess ? -(int)o : n;
  }

  static int launch(const void* q, const void* k, const void* v, void* o,
                    const int* lens, int kv_scalar, int b, int hq, int hkv,
                    int s, const long long* st, int chunks, int splits,
                    int span, float scale, cudaStream_t stream) {
    const cudaError_t e = attribute();
    if (e != cudaSuccess) return (int)e;
    const long long blocks = (long long)b * hkv * chunks * splits;
    const int group = hq / hkv;     // chunks of 16 query heads cover it
    if (splits < 1 || splits > DA_CLUSTER_MAX || chunks < 1 ||
        (chunks - 1) * DA_ROWS >= group || chunks * DA_ROWS < group ||
        span < 0 || span > s || blocks < 1 || blocks >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks, 1, 1);
    cfg.blockDim = dim3(Geo<TQ, TC, D>::THREADS, 1, 1);
    cfg.dynamicSmemBytes = Geo<TQ, TC, D>::SMEM;
    cfg.stream = stream;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = splits;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = splits > 1 ? 1 : 0;   // one block: no cluster to form
    const cudaError_t r = cudaLaunchKernelEx(
        &cfg, decode_attention_kernel<TQ, TC, D>, (const TQ*)q, (const TC*)k,
        (const TC*)v, (TQ*)o, lens, kv_scalar, hq, hkv, s, st[0], st[1],
        st[2], st[3], st[4], st[5], chunks, span, scale);
    return r != cudaSuccess ? (int)r : (int)cudaGetLastError();
  }
};

// qtype 0: float32, 1: bfloat16; ctype 0: float32, 1: bfloat16, 2:
// float8_e4m3fn; the cache in q's dtype or in float8.
#define DA_BY_DIM(TQ, TC, CALL)                      \
  switch (d) {                                       \
    case 16: return Instance<TQ, TC, 16>::CALL;      \
    case 32: return Instance<TQ, TC, 32>::CALL;      \
    case 64: return Instance<TQ, TC, 64>::CALL;      \
    case 128: return Instance<TQ, TC, 128>::CALL;    \
  }
#define DA_BY_TYPE(CALL)                                          \
  if (qtype == 0 && ctype == 0) { DA_BY_DIM(float, float, CALL) } \
  if (qtype == 1 && ctype == 1) { DA_BY_DIM(bf16, bf16, CALL) }   \
  if (qtype == 1 && ctype == 2) { DA_BY_DIM(bf16, fp8e4m3, CALL) } \
  if (qtype == 0 && ctype == 2) { DA_BY_DIM(float, fp8e4m3, CALL) }

// Clusters of `splits` blocks of the instance the card holds at once, or
// minus a CUDA error code; the host's plan reads it.
extern "C" int decode_attention_clusters(int qtype, int ctype, int d,
                                         int splits) {
  if (splits < 1 || splits > DA_CLUSTER_MAX)
    return -(int)cudaErrorInvalidValue;
  DA_BY_TYPE(clusters(splits))
  return -(int)cudaErrorInvalidValue;
}

// `lens` is a (B,) int32 device array or null, and then every row attends
// to `kv_scalar` keys.  Strides are in elements: k_sb, k_sh, k_ss of k's
// batch, head and sequence axes (its last axis is contiguous, rows 16-byte
// aligned), likewise for v.  `chunks`, `splits` and `span` are the host's
// plan (kernels/decode_attention.py).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* o, const void* lens,
    int kv_scalar, int b, int hq, int hkv, int s, int d, int qtype,
    int ctype, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, int chunks, int splits, int span,
    void* stream) {
  const float scale = (float)(1.4426950408889634 / sqrt((double)d));
  const long long st[6] = {k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  const int* ln = (const int*)lens;
  cudaStream_t cs = (cudaStream_t)stream;
  DA_BY_TYPE(launch(q, k, v, o, ln, kv_scalar, b, hq, hkv, s, st, chunks,
                    splits, span, scale, cs))
  return (int)cudaErrorInvalidValue;
}
