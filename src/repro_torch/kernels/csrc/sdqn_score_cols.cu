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
//   :486, pallas_call at :511, with `_iter_topk` :317 inside the kernel and
//   `_merge_topk` :339 after it): the same scores masked by
//   `PlacementEngine.feasible` (healthy, and the post-delta cpu / mem /
//   job-util ceilings compared in float32) and reduced to each shard's
//   top-k in this one launch, so only (B, shards, k) candidates reach
//   device memory.
//
// Design.  The normalization folds into w1 (w1[f] / scale[f], IEEE
// division, as the reference's `w1 / scale[:, None]`), staged per block in
// shared memory (sdqn_common.cuh).  `sdqn_score_cols`: one thread per
// (host, job), grid (ceil(N / 256), B).  `sdqn_score_cols_topk`: the
// geometry and reduction of topk_cluster.cuh (a cluster of blocks per
// (shard, group of P jobs), each block an ascending chunk of the shard,
// each warp its best k per job in a WarpList, the merge inside the
// launch).  A thread loads a host's six columns once for its P jobs and
// reads each hidden unit's weights once for them (mlp_q_rows: kernel 3's
// order of operations, so every score is kernel 3's bit for bit).  All
// the features depend on the delta, so P saves the column loads and the
// shared-memory weight reads only.  The ragged last shard is masked by
// index (host >= N), so no padded copy of the columns is made.
// Infeasible hosts are never offered: their slots stay -inf / -1.
//
// What bounds it.  Per (job, host) ~490 fp32 operations against 24 bytes
// per host read once: at B = 32 the fp32 pipe, not memory, is the limit,
// and in practice instruction issue (the Q-net's ~290 instructions a
// pair).

#include "topk_cluster.cuh"

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

// one host's six raw columns
struct HostCols {
  float c0, c1, c2, c3, c4, c5;
};

struct FleetCols {
  const float *c0, *c1, *c2, *c3, *c4, *c5;

  __device__ __forceinline__ HostCols load(int g) const {
    return {c0[g], c1[g], c2[g], c3[g], c4[g], c5[g]};
  }
};

// The deltas of P jobs (job `job0 + p`; `valid[p]` false past B) and the
// scoring of one host for them: kernel 3's arithmetic, the feasibility of
// `PlacementEngine.feasible`.
template <int P>
struct ColsJobs {
  float d[6][P];
  bool valid[P];
  float max_cpu, max_mem, max_util;

  // out[p]: host g's candidate for job p, 0 where it is infeasible (or
  // the lane has no host, !active)
  __device__ __forceinline__ void score(const float4 (*s_w)[2], float b2,
                                        const HostCols& c, int g, bool active,
                                        cand_t (&out)[P]) const {
    float x[6][P], q[P];
    bool ok[P];
    bool any = false;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      x[0][p] = c.c0 + d[0][p];
      x[1][p] = c.c1 + d[1][p];
      x[2][p] = c.c2 + d[2][p];
      ok[p] = active && valid[p] && c.c3 > 0.5f && x[0][p] <= max_cpu &&
              x[1][p] <= max_mem && x[2][p] <= max_util;
      any = any || ok[p];
      out[p] = 0ull;
    }
    if (!any) return;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      x[3][p] = c.c3 + d[3][p];
      x[4][p] = c.c4 + d[4][p];
      x[5][p] = c.c5 + d[5][p];
    }
    mlp_q_rows<P>(s_w, b2, x, q);
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (ok[p]) out[p] = cand_pack(q[p], g);
  }
};

// 2 blocks an SM (registers capped at 128): the plan's TOPK_FILL_BLOCKS
template <int P>
__global__ void __launch_bounds__(SDQN_BLOCK, 2) sdqn_score_cols_topk_kernel(
    FleetCols cols, const float* __restrict__ deltas,  // (B, 6)
    float sc0, float sc1, float sc2, float sc3, float sc4, float sc5,
    float max_cpu, float max_mem, float max_util,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    float* __restrict__ out_v, int* __restrict__ out_i,  // (B, shards, k)
    int n, int b, int k, int shard_size, int chunk) {
  __shared__ float4 s_w[SDQN_HIDDEN][2];
  __shared__ float s_b2;
  __shared__ TopkShared<P> s_topk;
  const float scale[6] = {sc0, sc1, sc2, sc3, sc4, sc5};
  stage_weights(s_w, &s_b2, w1, b1, w2, b2, scale);
  ColsJobs<P> jobs;
  jobs.max_cpu = max_cpu;
  jobs.max_mem = max_mem;
  jobs.max_util = max_util;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int job = blockIdx.y * P + p;
    jobs.valid[p] = job < b;
    const float* dp = deltas + (job < b ? job : b - 1) * 6;
#pragma unroll
    for (int f = 0; f < 6; ++f) jobs.d[f][p] = dp[f];
  }
  const TopkChunk ch = topk_chunk(n, shard_size, chunk);
  WarpList lists[P];
#pragma unroll
  for (int p = 0; p < P; ++p) lists[p].init();
  // warp-uniform steps: lane l of warp w takes host base + l, base =
  // start + 32 w, start + 32 w + 256, ...
  const int lane = threadIdx.x & 31;
  const int first = ch.start + (threadIdx.x - lane);
  HostCols cur;
  if (first + lane < ch.end) cur = cols.load(first + lane);
  for (int base = first; base < ch.end; base += SDQN_BLOCK) {
    const int g = base + lane, next = g + SDQN_BLOCK;
    HostCols nxt;     // the next host's loads are in flight while g scores
    if (next < ch.end) nxt = cols.load(next);
    cand_t x[P];
    jobs.score(s_w, s_b2, cur, g, g < ch.end, x);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (base == first)
        lists[p].fill(x[p], k);
      else
        lists[p].offer(x[p], k);
    }
    cur = nxt;
  }
  cluster_reduce<P>(s_topk, ch, lists, b, k, out_v, out_i);
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
    int shard_size, int cluster, int pods, int chunk, void* stream) {
  const FleetCols cols = {(const float*)c0, (const float*)c1, (const float*)c2,
                          (const float*)c3, (const float*)c4, (const float*)c5};
#define SDQN_COLS_TOPK_LAUNCH(P_)                                           \
  launch_cluster_topk(sdqn_score_cols_topk_kernel<P_>, P_, b, k, shards,    \
                      shard_size, cluster, chunk, stream, cols,             \
                      (const float*)deltas, sc0, sc1, sc2, sc3, sc4, sc5,   \
                      max_cpu, max_mem, max_util, (const float*)w1,         \
                      (const float*)b1, (const float*)w2, (const float*)b2, \
                      (float*)out_v, (int*)out_i, n, b, k, shard_size, chunk)
  if (pods == 1) return SDQN_COLS_TOPK_LAUNCH(1);
  if (pods == 2) return SDQN_COLS_TOPK_LAUNCH(2);
#undef SDQN_COLS_TOPK_LAUNCH
  return (int)cudaErrorInvalidValue;
}
