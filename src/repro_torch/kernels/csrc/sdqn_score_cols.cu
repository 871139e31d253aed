// SDQN column scorers for job->host fleets, for Hopper (sm_90a).
//
// Two kernels over the six raw Table-2 columns of a `FleetState`
// (cpu %, mem %, job-util %, healthy, uptime h, jobs) and B afterstate
// deltas (one (6,) row per job):
//
// * `sdqn_score_cols` replaces the Pallas TPU kernel `sdqn_score_cols` of
//   src/repro/kernels/sdqn_score.py (function at :249, pallas_call at
//   :276): Q((cols + delta) / scale) for every (job, host), (B, N).
// * `sdqn_score_cols_topk` replaces `sdqn_score_cols_topk` (function at
//   :486, pallas_call at :511): the same scores masked by
//   `PlacementEngine.feasible` (healthy, and the post-delta cpu / mem /
//   job-util ceilings compared in float32) and reduced to each shard's
//   top-k, so only (B, shards, tiles, k) candidates reach device memory.
//
// Design.  The normalization folds into w1 (w1[f] / scale[f], IEEE
// division, as the reference's `w1 / scale[:, None]`), staged per block in
// shared memory (sdqn_common.cuh).  `sdqn_score_cols`: one thread per
// (host, job), grid (ceil(N / 256), B).  `sdqn_score_cols_topk`: one block
// per (tile of 1024 hosts, shard, job); each thread scores 4 hosts of the
// tile in ascending order (coalesced: host = tile base + m * 256 + thread),
// keeps its best 8 in registers, and the block merges the 256 lists in k
// rounds of a block-wide argmax.  The ragged last shard is masked by index
// (host >= N), so no padded copy of the columns is made.  Infeasible hosts
// are never pushed: their slots stay -inf / -1.
//
// What bounds it.  Per (job, host) ~490 fp32 operations against 24 bytes
// per host read once: at B = 32 the fp32 pipe, not memory, is the limit.

#include "sdqn_common.cuh"

__global__ void __launch_bounds__(SDQN_BLOCK) sdqn_score_cols_kernel(
    const float* __restrict__ c0, const float* __restrict__ c1,
    const float* __restrict__ c2, const float* __restrict__ c3,
    const float* __restrict__ c4, const float* __restrict__ c5,
    const float* __restrict__ deltas,  // (B, 6)
    float sc0, float sc1, float sc2, float sc3, float sc4, float sc5,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    float* __restrict__ q, int n) {
  __shared__ float4 s_w[SDQN_HIDDEN][2];
  __shared__ float s_b2;
  const float scale[6] = {sc0, sc1, sc2, sc3, sc4, sc5};
  stage_weights(s_w, &s_b2, w1, b1, w2, b2, scale);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int p = blockIdx.y;
  if (i >= n) return;
  const float* d = deltas + p * 6;
  q[(size_t)p * n + i] = mlp_q(s_w, s_b2, c0[i] + d[0], c1[i] + d[1],
                               c2[i] + d[2], c3[i] + d[3], c4[i] + d[4],
                               c5[i] + d[5]);
}

__global__ void __launch_bounds__(SDQN_BLOCK) sdqn_score_cols_topk_kernel(
    const float* __restrict__ c0, const float* __restrict__ c1,
    const float* __restrict__ c2, const float* __restrict__ c3,
    const float* __restrict__ c4, const float* __restrict__ c5,
    const float* __restrict__ deltas,  // (B, 6)
    float sc0, float sc1, float sc2, float sc3, float sc4, float sc5,
    float max_cpu, float max_mem, float max_util,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    float* __restrict__ out_v, int* __restrict__ out_i,  // (B, S, tiles, k)
    int n, int k, int shard_size, int tiles) {
  __shared__ float4 s_w[SDQN_HIDDEN][2];
  __shared__ float s_b2;
  const float scale[6] = {sc0, sc1, sc2, sc3, sc4, sc5};
  stage_weights(s_w, &s_b2, w1, b1, w2, b2, scale);
  const int tile = blockIdx.x, s = blockIdx.y, p = blockIdx.z;
  const float* dp = deltas + p * 6;
  const float d0 = dp[0], d1 = dp[1], d2 = dp[2], d3 = dp[3], d4 = dp[4],
              d5 = dp[5];
  TopK t;
  t.init();
#pragma unroll
  for (int m = 0; m < TOPK_TILE / SDQN_BLOCK; ++m) {
    const int local = tile * TOPK_TILE + m * SDQN_BLOCK + threadIdx.x;
    const int g = s * shard_size + local;
    if (local >= shard_size || g >= n) break;
    const float x0 = c0[g] + d0, x1 = c1[g] + d1, x2 = c2[g] + d2;
    const float health = c3[g];
    const bool ok = health > 0.5f && x0 <= max_cpu && x1 <= max_mem &&
                    x2 <= max_util;
    if (ok) {
      t.push(mlp_q(s_w, s_b2, x0, x1, x2, health + d3, c4[g] + d4,
                   c5[g] + d5), g);
    }
  }
  const size_t o = (((size_t)p * gridDim.y + s) * tiles + tile) * k;
  block_topk(t, k, out_v + o, out_i + o);
}

extern "C" int sdqn_score_cols_launch(
    const void* c0, const void* c1, const void* c2, const void* c3,
    const void* c4, const void* c5, const void* deltas, float sc0, float sc1,
    float sc2, float sc3, float sc4, float sc5, const void* w1,
    const void* b1, const void* w2, const void* b2, void* q, int n, int b,
    void* stream) {
  const dim3 grid((n + SDQN_BLOCK - 1) / SDQN_BLOCK, b);
  sdqn_score_cols_kernel<<<grid, SDQN_BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)c0, (const float*)c1, (const float*)c2, (const float*)c3,
      (const float*)c4, (const float*)c5, (const float*)deltas, sc0, sc1, sc2,
      sc3, sc4, sc5, (const float*)w1, (const float*)b1, (const float*)w2,
      (const float*)b2, (float*)q, n);
  return (int)cudaGetLastError();
}

extern "C" int sdqn_score_cols_topk_launch(
    const void* c0, const void* c1, const void* c2, const void* c3,
    const void* c4, const void* c5, const void* deltas, float sc0, float sc1,
    float sc2, float sc3, float sc4, float sc5, float max_cpu, float max_mem,
    float max_util, const void* w1, const void* b1, const void* w2,
    const void* b2, void* out_v, void* out_i, int n, int b, int k, int shards,
    int shard_size, int tiles, void* stream) {
  const dim3 grid(tiles, shards, b);
  sdqn_score_cols_topk_kernel<<<grid, SDQN_BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)c0, (const float*)c1, (const float*)c2, (const float*)c3,
      (const float*)c4, (const float*)c5, (const float*)deltas, sc0, sc1, sc2,
      sc3, sc4, sc5, max_cpu, max_mem, max_util, (const float*)w1,
      (const float*)b1, (const float*)w2, (const float*)b2, (float*)out_v,
      (int*)out_i, n, k, shard_size, tiles);
  return (int)cudaGetLastError();
}
