// Device helpers shared by the SDQN scoring kernels for Hopper (sm_90a):
// the Table-4 Q-net 6 -> 32 -> ReLU -> 1 over weights staged in shared
// memory, the Table-2 afterstate features, and the running top-k with its
// block-level merge.
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
// the top-k kernels: each thread keeps its best TOPK_MAX candidates, a
// block reduces a tile of TOPK_TILE nodes (TOPK_TILE / SDQN_BLOCK per thread)
#define TOPK_MAX 8
#define TOPK_TILE 1024
#define IDX_NONE 0x7fffffff

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
  raw = raw + s.crowd_coeff * crowd * crowd;
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

// ---------------------------------------------------------------------------
// top-k: (value desc, index asc), NaN above every number (torch.sort's order)
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  const bool an = a != a, bn = b != b;
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

// A thread's running top-TOPK_MAX as a sorted list in registers: every
// index below is a compile-time constant after unrolling, so nothing
// spills to local memory.  Empty slots hold (-inf, IDX_NONE), which any
// real node (even an infeasible one at -inf) beats.
struct TopK {
  float v[TOPK_MAX];
  int i[TOPK_MAX];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < TOPK_MAX; ++r) { v[r] = -CUDART_INF_F; i[r] = IDX_NONE; }
  }

  // insertion; a thread pushes its nodes in ascending index order
  __device__ __forceinline__ void push(float x, int ix) {
    if (!beats(x, ix, v[TOPK_MAX - 1], i[TOPK_MAX - 1])) return;
    v[TOPK_MAX - 1] = x;
    i[TOPK_MAX - 1] = ix;
#pragma unroll
    for (int r = TOPK_MAX - 1; r > 0; --r) {
      if (beats(v[r], i[r], v[r - 1], i[r - 1])) {
        const float tv = v[r]; v[r] = v[r - 1]; v[r - 1] = tv;
        const int ti = i[r]; i[r] = i[r - 1]; i[r - 1] = ti;
      }
    }
  }

  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int r = 0; r < TOPK_MAX - 1; ++r) { v[r] = v[r + 1]; i[r] = i[r + 1]; }
    v[TOPK_MAX - 1] = -CUDART_INF_F;
    i[TOPK_MAX - 1] = IDX_NONE;
  }
};

// The block's top-k of all threads' lists, written to out_v / out_i[0..k):
// k rounds of a block-wide argmax over the list heads (warp shuffles, then
// one warp over the per-warp winners); the winning thread pops its head.
// Node indices are unique, so exactly one thread pops a real winner.  A
// slot whose value is not finite gets index -1.  All threads must call it.
__device__ __forceinline__ void block_topk(TopK& t, int k, float* out_v,
                                           int* out_i) {
  __shared__ float s_v[SDQN_BLOCK / 32];
  __shared__ int s_i[SDQN_BLOCK / 32];
  __shared__ int s_win;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = 0; r < k; ++r) {
    float v = t.v[0];
    int ix = t.i[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, ix, off);
      if (beats(ov, oi, v, ix)) { v = ov; ix = oi; }
    }
    if (lane == 0) { s_v[warp] = v; s_i[warp] = ix; }
    __syncthreads();
    if (warp == 0) {
      v = lane < SDQN_BLOCK / 32 ? s_v[lane] : -CUDART_INF_F;
      ix = lane < SDQN_BLOCK / 32 ? s_i[lane] : IDX_NONE;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, ix, off);
        if (beats(ov, oi, v, ix)) { v = ov; ix = oi; }
      }
      if (lane == 0) {
        out_v[r] = v;
        out_i[r] = isfinite(v) ? ix : -1;
        s_win = ix;
      }
    }
    __syncthreads();
    if (t.i[0] == s_win) t.pop();
    __syncthreads();   // s_v / s_win are rewritten by the next round
  }
}
