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
// shared memory (sdqn_common.cuh).  `sdqn_score_cols`: the launch plan
// `sdqn_score.score_plan` (sdqn_common.cuh, `ScoreRows`) gives each thread
// R rows, a host's R jobs where B >= R (one load of its six columns) or R
// hosts for one job (B = 1 over 131,072 hosts: R = 2), with one read of
// each hidden unit's two float4 of weights for the R rows (mlp_q_rows);
// the column loads are in flight while the block stages its weights.
// `sdqn_score_cols_topk`: the geometry and reduction of topk_cluster.cuh
// (a cluster of blocks per (shard, group of P jobs), each block an
// ascending chunk of the shard, each warp its best k per job in a
// WarpList, the merge inside the launch), with the next host's columns
// loaded while the current one scores.  Both keep mlp_q's order of
// operations, so every candidate of kernel 5 is kernel 3's score bit for
// bit.  All the features depend on the delta, so R and P save the column
// loads and the shared-memory weight reads only.  The ragged last shard is
// masked by index (host >= N), so no padded copy of the columns is made.
// Infeasible hosts are never offered: their slots stay -inf / -1.
//
// What bounds it.  Per (job, host) ~490 fp32 operations against 24 bytes
// per host read once: at B = 32 the fp32 pipe, not memory, is the limit,
// and in practice instruction issue (the Q-net's ~290 instructions a
// pair: 7 multiply-adds, a ReLU and a multiply-add per hidden unit).  One
// weight read per thread and hidden unit for R = 8 rows leaves the
// shared-memory pipe idle most of the time; the tensor cores' TF32
// products would change the bits.

#include "topk_cluster.cuh"

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

// Kernel 3's arguments, and its launch for one plan (R, POD_ROWS).
struct ColsScore {
  FleetCols cols;
  const float* deltas;  // (B, 6)
  float sc[6];
  const float *w1, *b1, *w2, *b2;
  float* q;             // (B, N)
  int n, b;

  template <int R, bool POD_ROWS>
  void run(dim3 grid, cudaStream_t stream) const;
};

template <int R, bool POD_ROWS>
__global__ void __launch_bounds__(SDQN_BLOCK, SCORE_MIN_BLOCKS(R, POD_ROWS))
    sdqn_score_cols_kernel(const ColsScore a) {
  __shared__ float4 s_w[SDQN_HIDDEN][2];
  __shared__ float s_b2;
  ScoreRows<R, POD_ROWS> m;
  m.init(a.n, a.b);
  // a host's columns, loaded once for its R jobs, or R hosts' for one job;
  // the loads are in flight while the weights are staged
  constexpr int H = POD_ROWS ? 1 : R;
  HostCols c[H];
#pragma unroll
  for (int h = 0; h < H; ++h) c[h] = a.cols.load(m.node[h]);
  float d[6][R];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int f = 0; f < 6; ++f) d[f][r] = a.deltas[m.pod[r] * 6 + f];
  stage_weights(s_w, &s_b2, a.w1, a.b1, a.w2, a.b2, a.sc);
  float x[6][R], q[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const HostCols& hc = c[POD_ROWS ? 0 : r];
    x[0][r] = hc.c0 + d[0][r];
    x[1][r] = hc.c1 + d[1][r];
    x[2][r] = hc.c2 + d[2][r];
    x[3][r] = hc.c3 + d[3][r];
    x[4][r] = hc.c4 + d[4][r];
    x[5][r] = hc.c5 + d[5][r];
  }
  mlp_q_rows<R>(s_w, s_b2, x, q);
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (m.write[r]) a.q[(size_t)m.pod[r] * a.n + m.node[r]] = q[r];
}

template <int R, bool POD_ROWS>
void ColsScore::run(dim3 grid, cudaStream_t stream) const {
  sdqn_score_cols_kernel<R, POD_ROWS><<<grid, SDQN_BLOCK, 0, stream>>>(
      *this);
}

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
    int rows, int pod_rows, int grid_x, int grid_y,
    void* stream) {
  const ColsScore a = {
      {(const float*)c0, (const float*)c1, (const float*)c2, (const float*)c3,
       (const float*)c4, (const float*)c5},
      (const float*)deltas, {sc0, sc1, sc2, sc3, sc4, sc5},
      (const float*)w1, (const float*)b1, (const float*)w2, (const float*)b2,
      (float*)q, n, b};
  return launch_score_plan(a, n, b, rows, pod_rows, grid_x, grid_y, stream);
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
