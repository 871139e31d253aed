// Decode attention for Hopper (sm_90a): one query token per head against a
// KV cache.
//
// Replaces the Pallas TPU kernel `decode_attention` of
// src/repro/kernels/decode_attention.py (function at :69, pallas_call at
// :103): for batch row b and query head h, o = softmax(q k^T / sqrt(D)) v
// over keys 0 .. kv_len[b] - 1 of key/value head h / (Hq / Hkv), with
// q (B, Hq, D) and k, v (B, Hkv, S, D) in float32 or bfloat16, scores,
// exponentials and sums in float32, the output in q's dtype, and
// acc / max(l, 1e-30) at the end, so a row with kv_len = 0 comes out as
// zeros (the TPU kernel's value; the reference's oracle gives the mean of
// V there).  Its caller is the LM decode step: one launch per attention
// layer per generated token.
//
// Design.  The TPU kernel walks key blocks in the sequential last grid axis
// for each (batch, query head) and carries (m, l, acc) in VMEM scratch.
// Here a block of four warps serves one (batch, key/value head) and a chunk
// of GC query heads of its group, so the cache is read once per chunk and
// not once per query head.  A key row of D elements is read by D / V lanes
// with 16-byte loads (V = 4 floats or 8 bfloat16), so a warp takes 32·V / D
// keys per step, and each lane loads DA_UNROLL keys of k and v before it
// uses them, to keep loads in flight.  The partial dot products are summed
// across a key's lanes with __shfl_xor_sync; every key slot of a warp keeps
// its own running (m, l, acc), and the block merges them at the end, across
// the warp's key slots by shuffles and across warps through shared memory.
// k and v are strided views (element strides of the batch, head and
// sequence axes), so the model's (B, S, Hkv, D) cache is read in place.
//
// Filling the card.  At B·Hkv = 128 blocks the 132 SMs would hold one
// block each, too few loads in flight to stream the cache.  So the keys
// are split into `splits` ranges (split-KV flash-decoding, the CUDA form
// the TPU kernel's docstring names): each block writes its range's
// (m, l, acc) to a float32 scratch and a second small kernel merges the
// ranges.  With splits = 1 the first kernel writes the output itself.
//
// What bounds it.  Bytes: 2·B·Hkv·kv_len·D·itemsize of cache read once,
// against ~4·D operations per (query head, key); at GQA groups below ~70
// the cache read sets the pace (3.35 TB/s on the H100 SXM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define DA_WARPS 4      // warps per block
#define DA_UNROLL 4     // keys per lane loaded ahead of their use
#define DA_NEG -1e30f   // the running max before any key (finite: no NaN)

__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = t.x;
  x[1] = t.y;
  x[2] = t.z;
  x[3] = t.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D, int GC>
__global__ void __launch_bounds__(DA_WARPS * 32) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ part_acc,
    float* __restrict__ part_ml, const int* __restrict__ lens, int kv_scalar,
    int hq, int hkv, int s, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, int splits, int split_len,
    float scale_log2) {
  constexpr int V = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int L = D / V;            // lanes per key row
  constexpr int KW = 32 / L;          // keys per warp step
  static_assert(L >= 1 && L <= 32 && 32 % L == 0, "unsupported head width");
  __shared__ float s_m[DA_WARPS][GC], s_l[DA_WARPS][GC];
  __shared__ float s_acc[DA_WARPS][GC][D];

  const int group = hq / hkv;
  const int chunks = group / GC;
  int bx = blockIdx.x;
  const int c = bx % chunks;
  bx /= chunks;
  const int hk = bx % hkv;
  const int b = bx / hkv;
  const int h0 = hk * group + c * GC;   // the chunk's first query head
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane % L;             // the lane's 16-byte slice of a row
  const int slot = lane / L;            // the lane's key within a warp step

  int len = lens != nullptr ? lens[b] : kv_scalar;
  len = max(0, min(len, s));
  const int t_begin = blockIdx.y * split_len;
  const int t_end = min(len, t_begin + split_len);

  float qr[GC][V], acc[GC][V], m[GC], l[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    load16(q + ((size_t)b * hq + h0 + g) * D + sub * V, qr[g]);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[g][i] = 0.f;
    m[g] = DA_NEG;
    l[g] = 0.f;
  }
  const T* kb = k + b * k_sb + hk * k_sh + sub * V;
  const T* vb = v + b * v_sb + hk * v_sh + sub * V;

  // warp-uniform loop: every lane of a warp runs the same iterations, so
  // the shuffles below see the whole warp
  for (int t0 = t_begin + warp * KW * DA_UNROLL; t0 < t_end;
       t0 += DA_WARPS * KW * DA_UNROLL) {
    float kk[DA_UNROLL][V], vv[DA_UNROLL][V];
    bool ok[DA_UNROLL];
#pragma unroll
    for (int u = 0; u < DA_UNROLL; ++u) {
      const int t = t0 + u * KW + slot;
      ok[u] = t < t_end;
      const long long tt = ok[u] ? t : t_begin;   // a valid row to read
      load16(kb + tt * k_ss, kk[u]);
      load16(vb + tt * v_ss, vv[u]);
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float sc[DA_UNROLL];
      float cmax = -INFINITY;
#pragma unroll
      for (int u = 0; u < DA_UNROLL; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < V; ++i) dot = fmaf(qr[g][i], kk[u][i], dot);
#pragma unroll
        for (int off = L / 2; off >= 1; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        sc[u] = ok[u] ? dot * scale_log2 : -INFINITY;
        cmax = fmaxf(cmax, sc[u]);
      }
      const float m_new = fmaxf(m[g], cmax);
      const float corr = exp2f(m[g] - m_new);
      l[g] *= corr;
#pragma unroll
      for (int i = 0; i < V; ++i) acc[g][i] *= corr;
#pragma unroll
      for (int u = 0; u < DA_UNROLL; ++u) {
        const float p = exp2f(sc[u] - m_new);    // 0 for a masked slot
        l[g] += p;
#pragma unroll
        for (int i = 0; i < V; ++i) acc[g][i] = fmaf(p, vv[u][i], acc[g][i]);
      }
      m[g] = m_new;
    }
  }

  // merge the warp's key slots (lanes L apart hold the same dims)
#pragma unroll
  for (int off = L; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float m_n = fmaxf(m[g], m_o);
      const float a = exp2f(m[g] - m_n), bo = exp2f(m_o - m_n);
      l[g] = l[g] * a + l_o * bo;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][i], off);
        acc[g][i] = acc[g][i] * a + acc_o * bo;
      }
      m[g] = m_n;
    }
  }
  if (slot == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
#pragma unroll
      for (int i = 0; i < V; ++i) s_acc[warp][g][sub * V + i] = acc[g][i];
      if (sub == 0) {
        s_m[warp][g] = m[g];
        s_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // merge the warps: one thread per (query head, dim)
  for (int idx = threadIdx.x; idx < GC * D; idx += DA_WARPS * 32) {
    const int g = idx / D, d = idx - g * D;
    float mx = DA_NEG;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) mx = fmaxf(mx, s_m[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) {
      const float f = exp2f(s_m[w][g] - mx);
      lsum = fmaf(s_l[w][g], f, lsum);
      a = fmaf(s_acc[w][g][d], f, a);
    }
    const size_t row = (size_t)b * hq + h0 + g;
    if (splits == 1) {
      store(o + row * D + d, a / fmaxf(lsum, 1e-30f));
    } else {
      const size_t pr = row * splits + blockIdx.y;
      part_acc[pr * D + d] = a;
      if (d == 0) {
        part_ml[2 * pr] = mx;
        part_ml[2 * pr + 1] = lsum;
      }
    }
  }
}

// Merge the key ranges of every (batch, query head): one block of D threads.
template <typename T>
__global__ void decode_attention_combine(const float* __restrict__ part_acc,
                                         const float* __restrict__ part_ml,
                                         T* __restrict__ o, int d_head,
                                         int splits) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  float mx = DA_NEG;
  for (int j = 0; j < splits; ++j) mx = fmaxf(mx, part_ml[2 * (row * splits + j)]);
  float lsum = 0.f, a = 0.f;
  for (int j = 0; j < splits; ++j) {
    const size_t pr = row * splits + j;
    const float f = exp2f(part_ml[2 * pr] - mx);
    lsum = fmaf(part_ml[2 * pr + 1], f, lsum);
    a = fmaf(part_acc[pr * d_head + d], f, a);
  }
  store(o + row * d_head + d, a / fmaxf(lsum, 1e-30f));
}

template <typename T, int D, int GC>
static int launch(const void* q, const void* k, const void* v, void* o,
                  float* part_acc, float* part_ml, const int* lens,
                  int kv_scalar, int b, int hq, int hkv, int s,
                  const long long* st, int splits, int split_len,
                  float scale_log2, cudaStream_t stream) {
  const dim3 grid(b * hkv * (hq / hkv / GC), splits);
  decode_attention_kernel<T, D, GC><<<grid, DA_WARPS * 32, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, part_acc, part_ml, lens,
      kv_scalar, hq, hkv, s, st[0], st[1], st[2], st[3], st[4], st[5], splits,
      split_len, scale_log2);
  if (splits > 1) {
    decode_attention_combine<T><<<b * hq, D, 0, stream>>>(part_acc, part_ml,
                                                          (T*)o, D, splits);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int by_chunk(int gc, const void* q, const void* k, const void* v,
                    void* o, float* pa, float* pm, const int* lens, int kv,
                    int b, int hq, int hkv, int s, const long long* st,
                    int splits, int split_len, float sl, cudaStream_t stream) {
  switch (gc) {
    case 1: return launch<T, D, 1>(q, k, v, o, pa, pm, lens, kv, b, hq, hkv, s, st, splits, split_len, sl, stream);
    case 2: return launch<T, D, 2>(q, k, v, o, pa, pm, lens, kv, b, hq, hkv, s, st, splits, split_len, sl, stream);
    case 4: return launch<T, D, 4>(q, k, v, o, pa, pm, lens, kv, b, hq, hkv, s, st, splits, split_len, sl, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int by_dim(int d, int gc, const void* q, const void* k, const void* v,
                  void* o, float* pa, float* pm, const int* lens, int kv,
                  int b, int hq, int hkv, int s, const long long* st,
                  int splits, int split_len, float sl, cudaStream_t stream) {
  switch (d) {
    case 16: return by_chunk<T, 16>(gc, q, k, v, o, pa, pm, lens, kv, b, hq, hkv, s, st, splits, split_len, sl, stream);
    case 32: return by_chunk<T, 32>(gc, q, k, v, o, pa, pm, lens, kv, b, hq, hkv, s, st, splits, split_len, sl, stream);
    case 64: return by_chunk<T, 64>(gc, q, k, v, o, pa, pm, lens, kv, b, hq, hkv, s, st, splits, split_len, sl, stream);
    case 128: return by_chunk<T, 128>(gc, q, k, v, o, pa, pm, lens, kv, b, hq, hkv, s, st, splits, split_len, sl, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype 0: float32, 1: bfloat16.  `lens` is a (B,) int32 device array or
// null, and then every row attends to `kv_scalar` keys.  Strides are in
// elements: k_sb, k_sh, k_ss of k's batch, head and sequence axes (its
// last axis is contiguous), likewise for v.  `gc` query heads share a
// block; part_acc (B·Hq·splits·D) and part_ml (B·Hq·splits·2) are float32
// scratch, read only when splits > 1.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* part_acc,
    void* part_ml, const void* lens, int kv_scalar, int b, int hq, int hkv,
    int s, int d, int dtype, int gc, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    int splits, int split_len, void* stream) {
  const float sl = (float)(1.4426950408889634 / sqrt((double)d));
  const long long st[6] = {k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  float* pa = (float*)part_acc;
  float* pm = (float*)part_ml;
  const int* ln = (const int*)lens;
  cudaStream_t cs = (cudaStream_t)stream;
  if (dtype == 0)
    return by_dim<float>(d, gc, q, k, v, o, pa, pm, ln, kv_scalar, b, hq, hkv, s, st, splits, split_len, sl, cs);
  if (dtype == 1)
    return by_dim<__nv_bfloat16>(d, gc, q, k, v, o, pa, pm, ln, kv_scalar, b, hq, hkv, s, st, splits, split_len, sl, cs);
  return (int)cudaErrorInvalidValue;
}
