// Device helpers shared by the SDQN scoring kernels for Hopper (sm_90a):
// the Table-4 Q-net 6 -> 32 -> ReLU -> 1 over weights staged in shared
// memory (for one row, or for P rows that share each weight load), the
// Table-2 afterstate features, the launch plan of kernels 1 and 3, and the
// top-k kernels' packed candidates with their register lists and
// warp-level selection.
//
// Exactness.  The kernels repeat the reference's order of operations (its
// `*_xla` twins in src/repro/kernels/sdqn_score.py) and keep IEEE division.
// ReLU, max and min are written as compares so that a NaN propagates as it
// does through jnp.maximum / torch.clamp: a diverged net must reach the
// daemon's NaN guard, not be masked to 0 by fmaxf.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define SDQN_HIDDEN 32
#define SDQN_BLOCK 256
// the top-k kernels keep at most TOPK_MAX candidates per shard (k)
#define TOPK_MAX 8

__device__ __forceinline__ float max0(float x) { return x < 0.0f ? 0.0f : x; }
__device__ __forceinline__ float minv(float x, float hi) { return x > hi ? hi : x; }

// Per hidden unit j, two float4: (b1[j], w1[0..2][j] / scale[0..2]) and
// (w1[3..5][j] / scale[3..5], w2[j]), so the 8 weights of a unit arrive in
// two 16-byte broadcast loads.  `scale` folds the feature normalization
// into w1 as the reference's `w1 / scale[:, None]` does (NULL: no fold).
// Called by every thread of the block; ends with a barrier.
__device__ __forceinline__ void stage_weights(
    float4 (*s_w)[2], float* s_b2, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* scale) {
  if (threadIdx.x < SDQN_HIDDEN) {
    const int j = threadIdx.x;
    float w[6];
#pragma unroll
    for (int f = 0; f < 6; ++f)
      w[f] = scale ? w1[f * SDQN_HIDDEN + j] / scale[f] : w1[f * SDQN_HIDDEN + j];
    s_w[j][0] = make_float4(b1[j], w[0], w[1], w[2]);
    s_w[j][1] = make_float4(w[3], w[4], w[5], w2[j]);
  }
  if (threadIdx.x == 0) *s_b2 = b2[0];
  __syncthreads();
}

// Q of one afterstate row, the bias added first: hid = b1 + sum_f x_f w1[f]
// (the order of the reference's `*_xla` twins), then sum_j relu(hid) w2[j] + b2.
__device__ __forceinline__ float mlp_q(const float4 (*s_w)[2], float b2,
                                       float x0, float x1, float x2, float x3,
                                       float x4, float x5) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < SDQN_HIDDEN; ++j) {
    const float4 a = s_w[j][0], c = s_w[j][1];
    float h = a.x;
    h = h + x0 * a.y;
    h = h + x1 * a.z;
    h = h + x2 * a.w;
    h = h + x3 * c.x;
    h = h + x4 * c.y;
    h = h + x5 * c.z;
    acc = acc + max0(h) * c.w;
  }
  return acc + b2;
}

// The reference's `_afterstate_norm_features` for one (pod, node): the six
// normalized Table-2 features of the node as if the pod were placed on it.
struct AfterstateScalars {
  float pull, warm, overhead, crowd_knee, crowd_coeff, cont_knee, cont_coeff,
      uptime_scale, exp_scale;
};

__device__ __forceinline__ void afterstate_features(
    const AfterstateScalars& s, float base_cpu, float pods_cpu,
    float startup_cpu, int32_t num_pods, int32_t exp_pods, float mem_used,
    bool cached, bool healthy, float uptime, float cap, float mem_cap,
    int32_t max_pods, float cpu_demand, float mem_demand, float* f) {
  const float start_cost = cached ? s.warm : s.pull;
  const float np1 = (float)num_pods + 1.0f;
  const float ep1 = (float)exp_pods + 1.0f;
  const float crowd = max0(np1 - s.crowd_knee);
  // the placed node is always active: the overhead term is unconditional
  float raw = base_cpu + s.overhead;
  raw = raw + pods_cpu;
  raw = raw + cpu_demand;
  raw = raw + startup_cpu;
  raw = raw + start_cost;
  // the multiply-add the compiler contracts `raw + cc * crowd * crowd` to
  // with one use of the product, written out: scoring several pods of a
  // node shares the pod-independent product, and with five uses or more
  // it would no longer be contracted (kernel 4 holds it at two)
  raw = __fmaf_rn(s.crowd_coeff * crowd, crowd, raw);
  const float util = raw / cap;
  const float over = max0(util - s.cont_knee);
  const float used = minv(raw + s.cont_coeff * over * over * cap, cap);
  f[0] = used / cap;
  f[1] = (mem_used + mem_demand) / mem_cap;
  f[2] = np1 / (float)max_pods;
  f[3] = healthy ? 1.0f : 0.0f;
  f[4] = uptime / s.uptime_scale;
  f[5] = ep1 / s.exp_scale;
}

// A float4 from shared memory, as a volatile load: in a loop over nodes
// the compiler would otherwise hoist all 64 weight vectors of the Q-net
// into registers (256 of them) and spill.
__device__ __forceinline__ float4 ld_shared_f4(const float4* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"((uint32_t)__cvta_generic_to_shared(p)));
  return v;
}

// ReLU in one instruction that keeps a NaN (max.NaN, sm_80 on).  It may
// differ from max0 only in the sign of a zero, which the FMA into the
// output sum (from +0) cannot show.
__device__ __forceinline__ float relu_nan(float x) {
  float r;
  asm("max.NaN.f32 %0, %1, 0f00000000;" : "=f"(r) : "f"(x));
  return r;
}

// The same Q-net for P rows at once, each in mlp_q's order of operations
// (so each q[p] is bit for bit mlp_q's): the two float4 of a hidden unit
// are read from shared memory once and applied to all P rows.
template <int P>
__device__ __forceinline__ void mlp_q_rows(const float4 (*s_w)[2], float b2,
                                           const float (&x)[6][P],
                                           float (&q)[P]) {
  float acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.0f;
#pragma unroll
  for (int j = 0; j < SDQN_HIDDEN; ++j) {
    const float4 a = ld_shared_f4(&s_w[j][0]), c = ld_shared_f4(&s_w[j][1]);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float h = a.x;
      h = h + x[0][p] * a.y;
      h = h + x[1][p] * a.z;
      h = h + x[2][p] * a.w;
      h = h + x[3][p] * c.x;
      h = h + x[4][p] * c.y;
      h = h + x[5][p] * c.z;
      acc[p] = acc[p] + relu_nan(h) * c.w;
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) q[p] = acc[p] + b2;
}

// ---------------------------------------------------------------------------
// The launch plan of the scoring kernels 1 and 3 (sdqn_score.score_plan
// picks it).  Each thread scores R rows, (pod, node) pairs, with one read
// of each hidden unit's weights for all of them (mlp_q_rows).  Thread t of
// block (x, y):
//   pod rows   (B >= R): node x * 256 + t, pods y * R + r;
//              grid (ceil(N / 256), ceil(B / R)), the last group ragged;
//   node rows  (B < R):  nodes x * 256 R + r * 256 + t (so a warp's loads
//              coalesce), pod y; grid (ceil(N / (256 R)), B).
// A row past N or B is clamped to a real one for its loads and writes
// nothing.
// ---------------------------------------------------------------------------

// Blocks an SM that ptxas keeps room for (its register cap is 65536 /
// (256 x that)): 3 (80 registers) for a node's 8 pods, which ran faster
// than 2 or 4 on kernel 3 at N = 131,072, B = 32; 2 (128) elsewhere, where
// 3 or 4 spilled (8 node rows) or ran no faster.
#define SCORE_MIN_BLOCKS(R, POD_ROWS) ((POD_ROWS) && (R) == 8 ? 3 : 2)

template <int R, bool POD_ROWS>
struct ScoreRows {
  int node[R], pod[R];
  bool write[R];

  __device__ __forceinline__ void init(int n, int b) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int g = POD_ROWS ? blockIdx.x * SDQN_BLOCK + threadIdx.x
                             : (blockIdx.x * R + r) * SDQN_BLOCK + threadIdx.x;
      const int p = POD_ROWS ? blockIdx.y * R + r : blockIdx.y;
      write[r] = g < n && p < b;
      node[r] = g < n ? g : n - 1;
      pod[r] = p < b ? p : b - 1;
    }
  }
};

// Launch `k.template run<R, POD_ROWS>(grid, stream)` for the plan's
// (rows, pod_rows, grid), after checking that the grid covers every
// (pod, node) pair; returns a CUDA error code (0 = launched).
template <typename K>
int launch_score_plan(const K& k, int n, int b, int rows, int pod_rows,
                      int grid_x, int grid_y, void* stream) {
  const long long reach = (long long)grid_x * SDQN_BLOCK * (pod_rows ? 1 : rows);
  const bool ok = n >= 1 && b >= 1 && grid_x >= 1 && grid_y >= 1 &&
                  grid_y <= 65535 && reach >= n && reach < (1ll << 31) &&
                  (pod_rows ? (long long)grid_y * rows >= b : grid_y == b);
  if (!ok) return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x, grid_y);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (rows * 2 + (pod_rows || rows == 1 ? 1 : 0)) {
    case 1 * 2 + 1: k.template run<1, true>(grid, s); break;
    case 2 * 2 + 1: k.template run<2, true>(grid, s); break;
    case 4 * 2 + 1: k.template run<4, true>(grid, s); break;
    case 8 * 2 + 1: k.template run<8, true>(grid, s); break;
    case 2 * 2: k.template run<2, false>(grid, s); break;
    case 4 * 2: k.template run<4, false>(grid, s); break;
    case 8 * 2: k.template run<8, false>(grid, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// top-k candidates: (value desc, index asc), NaN above every number
// (torch.sort's order), packed into one 64-bit integer so that the order
// is the integers' order: the high word is the value's order key, the low
// word ~index.  Every NaN gets the top key, so NaNs rank by index; -0.0
// takes +0.0's key, as the two compare equal.  0 is an empty slot, below
// every real candidate (the key of -inf is 0x007fffff).
// ---------------------------------------------------------------------------

typedef unsigned long long cand_t;

__device__ __forceinline__ cand_t cand_pack(float x, int idx) {
  uint32_t u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0u;
  const uint32_t key = x != x ? 0xffffffffu
                              : (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((cand_t)key << 32) | (uint32_t)~idx;
}

__device__ __forceinline__ float cand_value(cand_t c) {
  const uint32_t key = (uint32_t)(c >> 32);
  if (key == 0xffffffffu) return CUDART_NAN_F;
  if (key & 0x80000000u) return __uint_as_float(key & 0x7fffffffu);
  return key <= 0x007fffffu ? -CUDART_INF_F : __uint_as_float(~key);
}

// a slot whose value is not finite (-inf: infeasible or empty; NaN; +inf)
// carries index -1
__device__ __forceinline__ int cand_index(cand_t c) {
  return isfinite(cand_value(c)) ? (int)~(uint32_t)c : -1;
}

// A sorted (descending) list of the best J candidates in registers: every
// index is a compile-time constant after unrolling, so nothing spills to
// local memory.  An insertion is one pass of max / min down the list.
template <int J>
struct CandList {
  cand_t c[J];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < J; ++r) c[r] = 0ull;
  }

  __device__ __forceinline__ void push(cand_t x) {
    if (x <= c[J - 1]) return;
#pragma unroll
    for (int r = 0; r < J; ++r) {
      const cand_t hi = c[r] > x ? c[r] : x;
      x = c[r] > x ? x : c[r];
      c[r] = hi;
    }
  }

  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int r = 0; r < J - 1; ++r) c[r] = c[r + 1];
    c[J - 1] = 0ull;
  }
};

// The warp's best k of its 32 lanes' lists, in k rounds: the largest head
// by its key word, then by its index word, each a warp reduction; the lane
// that holds the winner pops it (indices are unique, so one lane does, or
// every lane when all heads are empty).  Lane r < k returns winner r.  All
// 32 lanes must call it.
template <int J>
__device__ __forceinline__ cand_t warp_select(CandList<J>& l, int k) {
  const int lane = threadIdx.x & 31;
  cand_t mine = 0ull;
  for (int r = 0; r < k; ++r) {
    const cand_t head = l.c[0];
    const uint32_t hi = (uint32_t)(head >> 32);
    const uint32_t top = __reduce_max_sync(0xffffffffu, hi);
    const uint32_t lo = __reduce_max_sync(0xffffffffu,
                                          hi == top ? (uint32_t)head : 0u);
    const cand_t win = ((cand_t)top << 32) | lo;
    if (head == win) l.pop();
    if (lane == r) mine = win;
  }
  return mine;
}

// A warp's running best k candidates, spread over its lanes: lane r < k
// holds slot r of the sorted list (lanes from k on hold 0), and every lane
// the bar, slot k - 1, that a candidate must beat.  `fill` starts the list
// from one candidate a lane (k rounds of warp_select), `offer` takes one
// more from every lane (0: none).  A step in which no lane beats the bar
// costs one compare and one ballot; each candidate that does is inserted
// by the whole warp (its position a ballot and a popcount, the shift one
// shuffle), after which the other lanes' offers meet the new bar.  All 32
// lanes must call them.
struct WarpList {
  cand_t slot, bar;

  __device__ __forceinline__ void init() {
    slot = 0ull;
    bar = 0ull;
  }

  __device__ __forceinline__ void fill(cand_t x, int k) {
    CandList<1> l;
    l.c[0] = x;
    slot = warp_select(l, k);
    bar = __shfl_sync(0xffffffffu, slot, k - 1);
  }

  __device__ __forceinline__ void offer(cand_t x, int k) {
    const int lane = threadIdx.x & 31;
    unsigned m = __ballot_sync(0xffffffffu, x > bar);
    while (m) {
      const int src = __ffs(m) - 1;
      const cand_t c = __shfl_sync(0xffffffffu, x, src);
      const int pos = __popc(__ballot_sync(0xffffffffu, slot > c));
      const cand_t up = __shfl_up_sync(0xffffffffu, slot, 1);
      if (lane < k && lane >= pos) slot = lane == pos ? c : up;
      bar = __shfl_sync(0xffffffffu, slot, k - 1);
      m &= __ballot_sync(0xffffffffu, x > bar) & ~(1u << src);
    }
  }
};
