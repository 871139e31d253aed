// Fused SDQN afterstate scorer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `sdqn_score_afterstate` of
// src/repro/kernels/sdqn_score.py (function at :171, pallas_call at :193).
// For each of B pods and each of N nodes it builds the six normalized
// Table-2 afterstate features from the node's raw ClusterState columns (the
// arithmetic of `_afterstate_norm_features`, sdqn_score.py:102-129) and runs
// the Table-4 Q-net 6 -> 32 -> ReLU -> 1 on them in registers, writing one
// float32 Q-value per (pod, node).  The (B, N, 6) features and the
// (B, N, 32) hidden layer never reach device memory.
//
// Design.  One thread per (node, pod): blockIdx.y is the pod of the batch,
// blockIdx.x * 256 + threadIdx.x the node.  The thread loads its node's 12
// columns (in their native dtypes: f32, int32 and bool bytes, so the caller
// needs no cast launches; a node's columns are re-read by the B pods from
// L2).  The 257 weights sit in shared memory, packed so that each hidden
// unit's 8 weights arrive in two 16-byte broadcast loads: with one 4-byte
// load per weight the shared-memory pipe, not the FMA pipe, set the pace at
// N = 131,072.  A first version looped each node's thread over the B pods:
// the compiler then held 256 weights in registers across the loop (255
// registers, spills, one block per SM) and N = 5000 filled only 20 blocks.  The TPU grid ran blocks
// of 1024 lanes in order and padded capacities with 1; here blocks run in
// parallel and the ragged edge is masked by `n < N`.
//
// What bounds it.  Per (pod, node) it does ~500 fp32 operations (19 for the
// features, 6x32 multiply-adds, 32 ReLUs, 32 multiply-adds for the output)
// against 42 bytes per node read once and 4 bytes per (pod, node) written,
// so at B = 32 it is bound by fp32 CUDA-core operations, not by bytes.  The
// 6 -> 32 layer is too thin for tensor cores.  At the serving size (N =
// 5000, B = 32) the whole launch is ~1 us of work, so launch latency
// dominates.
//
// ReLU, max and min are written as compares so a NaN propagates as it does
// through jnp.maximum / torch.clamp: a diverged net must reach the daemon's
// NaN guard, not be masked to 0 by fmaxf.

#include <cuda_runtime.h>
#include <stdint.h>

#define HIDDEN 32
#define BLOCK 256

__device__ __forceinline__ float max0(float x) { return x < 0.0f ? 0.0f : x; }
__device__ __forceinline__ float minv(float x, float hi) { return x > hi ? hi : x; }

__global__ void __launch_bounds__(BLOCK) sdqn_score_afterstate_kernel(
    const float* __restrict__ base_cpu, const float* __restrict__ pods_cpu,
    const float* __restrict__ startup_cpu, const int32_t* __restrict__ num_pods,
    const int32_t* __restrict__ exp_pods, const float* __restrict__ mem_used,
    const uint8_t* __restrict__ image_cached, const uint8_t* __restrict__ healthy,
    const float* __restrict__ uptime, const float* __restrict__ cpu_cap,
    const float* __restrict__ mem_cap, const int32_t* __restrict__ max_pods,
    const float* __restrict__ cpu_demand, const float* __restrict__ mem_demand,
    float pull, float warm, float overhead, float crowd_knee, float crowd_coeff,
    float cont_knee, float cont_coeff, float uptime_scale, float exp_scale,
    const float* __restrict__ w1,   // (6, 32) row-major, the reference layout
    const float* __restrict__ b1,   // (32,)
    const float* __restrict__ w2,   // (32,) = (32, 1)
    const float* __restrict__ b2,   // (1,)
    float* __restrict__ q,          // (B, N)
    int n, int b) {
  // per hidden unit j, two float4: (b1, w1[0..2][j]) and (w1[3..5][j], w2[j]),
  // so the 8 weights of a unit arrive in two 16-byte broadcast loads
  __shared__ float4 s_w[HIDDEN][2];
  __shared__ float s_b2;
  if (threadIdx.x < HIDDEN) {
    const int j = threadIdx.x;
    s_w[j][0] = make_float4(b1[j], w1[0 * HIDDEN + j], w1[1 * HIDDEN + j],
                            w1[2 * HIDDEN + j]);
    s_w[j][1] = make_float4(w1[3 * HIDDEN + j], w1[4 * HIDDEN + j],
                            w1[5 * HIDDEN + j], w2[j]);
  }
  if (threadIdx.x == 0) s_b2 = b2[0];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int p = blockIdx.y;
  if (i >= n) return;

  const float cap = cpu_cap[i];
  const float start_cost = image_cached[i] ? warm : pull;
  const float np1 = (float)num_pods[i] + 1.0f;
  const float ep1 = (float)exp_pods[i] + 1.0f;
  const float crowd = max0(np1 - crowd_knee);
  // the placed node is always active: the overhead term is unconditional
  float raw = base_cpu[i] + overhead;
  raw = raw + pods_cpu[i];
  raw = raw + cpu_demand[p];
  raw = raw + startup_cpu[i];
  raw = raw + start_cost;
  raw = raw + crowd_coeff * crowd * crowd;
  const float util = raw / cap;
  const float over = max0(util - cont_knee);
  const float used = minv(raw + cont_coeff * over * over * cap, cap);
  const float f0 = used / cap;
  const float f1 = (mem_used[i] + mem_demand[p]) / mem_cap[i];
  const float f2 = np1 / (float)max_pods[i];
  const float f3 = healthy[i] ? 1.0f : 0.0f;
  const float f4 = uptime[i] / uptime_scale;
  const float f5 = ep1 / exp_scale;

  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < HIDDEN; ++j) {
    const float4 a = s_w[j][0], c = s_w[j][1];
    float h = a.x;
    h = h + f0 * a.y;
    h = h + f1 * a.z;
    h = h + f2 * a.w;
    h = h + f3 * c.x;
    h = h + f4 * c.y;
    h = h + f5 * c.z;
    acc = acc + max0(h) * c.w;
  }
  q[(size_t)p * n + i] = acc + s_b2;
}

extern "C" int sdqn_score_afterstate_launch(
    const void* base_cpu, const void* pods_cpu, const void* startup_cpu,
    const void* num_pods, const void* exp_pods, const void* mem_used,
    const void* image_cached, const void* healthy, const void* uptime,
    const void* cpu_cap, const void* mem_cap, const void* max_pods,
    const void* cpu_demand, const void* mem_demand,
    float pull, float warm, float overhead, float crowd_knee, float crowd_coeff,
    float cont_knee, float cont_coeff, float uptime_scale, float exp_scale,
    const void* w1, const void* b1, const void* w2, const void* b2, void* q,
    int n, int b, void* stream) {
  const dim3 grid((n + BLOCK - 1) / BLOCK, b);
  sdqn_score_afterstate_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)base_cpu, (const float*)pods_cpu, (const float*)startup_cpu,
      (const int32_t*)num_pods, (const int32_t*)exp_pods, (const float*)mem_used,
      (const uint8_t*)image_cached, (const uint8_t*)healthy, (const float*)uptime,
      (const float*)cpu_cap, (const float*)mem_cap, (const int32_t*)max_pods,
      (const float*)cpu_demand, (const float*)mem_demand, pull, warm, overhead,
      crowd_knee, crowd_coeff, cont_knee, cont_coeff, uptime_scale, exp_scale,
      (const float*)w1, (const float*)b1, (const float*)w2, (const float*)b2,
      (float*)q, n, b);
  return (int)cudaGetLastError();
}
