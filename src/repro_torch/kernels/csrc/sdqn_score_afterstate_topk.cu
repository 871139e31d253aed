// Fused SDQN afterstate scoring + k8s filter + per-shard top-k for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `sdqn_score_afterstate_topk` of
// src/repro/kernels/sdqn_score.py (function at :386, pallas_call at :416,
// with `_iter_topk` :317 inside the kernel and `_merge_topk` :339 after
// it).  For each of B pods and each node of a `ClusterState` it builds the
// pod's Table-2 afterstate features from the node's 12 raw columns, runs
// the Table-4 Q-net on them (sdqn_common.cuh, the arithmetic of kernel 1,
// sdqn_score_afterstate.cu), applies the k8s filtering phase of
// `env.feasible` (Ready, cpu and mem requests within capacity, a free pod
// slot), and keeps only each shard's best k nodes: the (B, N) score
// matrix never reaches device memory.
//
// Design.  The node axis is split into `shards` contiguous slices of
// `shard_size` (the two-stage sharded path of sched/shard.py); one block
// per (tile of 1024 nodes, shard, pod).  Each thread scores 4 nodes of the
// tile in ascending order (node = tile base + m * 256 + thread, so loads
// coalesce), keeps its best 8 as a sorted (value desc, index asc, NaN
// first) list in registers, and the block merges the 256 lists in k rounds
// of a block-wide argmax, writing (B, shards, tiles, k).  The wrapper then
// merges each shard's tiles with one stable sort, as `_merge_topk` runs
// after the pallas_call.  The ragged last shard is masked by index
// (node >= N) instead of padded.  Infeasible nodes are never pushed, so
// their slots stay -inf / -1.  Ties break to the lowest node index at every
// stage, so the merged winner is the flat first-occurrence masked argmax.
//
// What bounds it.  Per (pod, node) ~510 fp32 operations (kernel 1's ~500,
// 6 for the filter, the select and a compare for the list) against 50
// bytes per node read once: at B = 32 the fp32 pipe is the limit.  Each
// node's columns are re-read by the 32 pods' blocks from L2.

#include "sdqn_common.cuh"

__global__ void __launch_bounds__(SDQN_BLOCK) sdqn_score_afterstate_topk_kernel(
    const float* __restrict__ base_cpu, const float* __restrict__ pods_cpu,
    const float* __restrict__ startup_cpu, const int32_t* __restrict__ num_pods,
    const int32_t* __restrict__ exp_pods, const float* __restrict__ mem_used,
    const uint8_t* __restrict__ image_cached, const uint8_t* __restrict__ healthy,
    const float* __restrict__ uptime, const float* __restrict__ cpu_cap,
    const float* __restrict__ mem_cap, const int32_t* __restrict__ max_pods,
    const float* __restrict__ cpu_requested,
    const float* __restrict__ mem_requested,
    const float* __restrict__ cpu_demand, const float* __restrict__ mem_demand,
    const float* __restrict__ cpu_request, const float* __restrict__ mem_request,
    AfterstateScalars sc,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    float* __restrict__ out_v, int* __restrict__ out_i,  // (B, S, tiles, k)
    int n, int k, int shard_size, int tiles) {
  __shared__ float4 s_w[SDQN_HIDDEN][2];
  __shared__ float s_b2;
  stage_weights(s_w, &s_b2, w1, b1, w2, b2, nullptr);
  const int tile = blockIdx.x, s = blockIdx.y, p = blockIdx.z;
  const float cd = cpu_demand[p], md = mem_demand[p];
  const float creq = cpu_request[p], mreq = mem_request[p];
  TopK t;
  t.init();
#pragma unroll
  for (int m = 0; m < TOPK_TILE / SDQN_BLOCK; ++m) {
    const int local = tile * TOPK_TILE + m * SDQN_BLOCK + threadIdx.x;
    const int g = s * shard_size + local;
    if (local >= shard_size || g >= n) break;
    const bool health = healthy[g] != 0;
    const float cap = cpu_cap[g], mcap = mem_cap[g];
    const int32_t np = num_pods[g], mp = max_pods[g];
    const bool ok = health && cpu_requested[g] + creq <= cap &&
                    mem_requested[g] + mreq <= mcap && np < mp;
    if (ok) {
      float f[6];
      afterstate_features(sc, base_cpu[g], pods_cpu[g], startup_cpu[g], np,
                          exp_pods[g], mem_used[g], image_cached[g] != 0,
                          health, uptime[g], cap, mcap, mp, cd, md, f);
      t.push(mlp_q(s_w, s_b2, f[0], f[1], f[2], f[3], f[4], f[5]), g);
    }
  }
  const size_t o = (((size_t)p * gridDim.y + s) * tiles + tile) * k;
  block_topk(t, k, out_v + o, out_i + o);
}

extern "C" int sdqn_score_afterstate_topk_launch(
    const void* base_cpu, const void* pods_cpu, const void* startup_cpu,
    const void* num_pods, const void* exp_pods, const void* mem_used,
    const void* image_cached, const void* healthy, const void* uptime,
    const void* cpu_cap, const void* mem_cap, const void* max_pods,
    const void* cpu_requested, const void* mem_requested,
    const void* cpu_demand, const void* mem_demand, const void* cpu_request,
    const void* mem_request, float pull, float warm, float overhead,
    float crowd_knee, float crowd_coeff, float cont_knee, float cont_coeff,
    float uptime_scale, float exp_scale, const void* w1, const void* b1,
    const void* w2, const void* b2, void* out_v, void* out_i, int n, int b,
    int k, int shards, int shard_size, int tiles, void* stream) {
  const AfterstateScalars sc = {pull, warm, overhead, crowd_knee, crowd_coeff,
                                cont_knee, cont_coeff, uptime_scale, exp_scale};
  const dim3 grid(tiles, shards, b);
  sdqn_score_afterstate_topk_kernel<<<grid, SDQN_BLOCK, 0,
                                      (cudaStream_t)stream>>>(
      (const float*)base_cpu, (const float*)pods_cpu, (const float*)startup_cpu,
      (const int32_t*)num_pods, (const int32_t*)exp_pods, (const float*)mem_used,
      (const uint8_t*)image_cached, (const uint8_t*)healthy, (const float*)uptime,
      (const float*)cpu_cap, (const float*)mem_cap, (const int32_t*)max_pods,
      (const float*)cpu_requested, (const float*)mem_requested,
      (const float*)cpu_demand, (const float*)mem_demand,
      (const float*)cpu_request, (const float*)mem_request, sc,
      (const float*)w1, (const float*)b1, (const float*)w2, (const float*)b2,
      (float*)out_v, (int*)out_i, n, k, shard_size, tiles);
  return (int)cudaGetLastError();
}
