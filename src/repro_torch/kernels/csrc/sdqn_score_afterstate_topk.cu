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
// slot), and writes only each shard's best k nodes, (B, shards, k), in
// this one launch: the (B, N) score matrix never reaches device memory and
// nothing runs after the kernel.
//
// Design (topk_cluster.cuh holds the geometry and the reduction shared
// with kernel 5).  The node axis is split into `shards` contiguous slices
// of `shard_size` (the two-stage sharded path of sched/shard.py).  A
// thread block cluster of C blocks takes one (shard, group of P pods); its
// blocks split the shard into C ascending chunks.  Each warp sweeps its
// block's chunk 32 consecutive nodes a step, strided by the block so loads
// coalesce, with the next node's columns loaded before the current one is
// scored.  Per node a thread loads the 14 columns and computes the
// pod-independent features once, then scores the P pods with one read of
// each hidden unit's weights (mlp_q_rows, in kernel 1's order of
// operations, so every score is kernel 1's bit for bit).  Each warp keeps
// its best k per pod spread over its lanes (WarpList), so a step whose
// candidates all fall below the warp's k-th costs one compare and one
// ballot.  The ragged last shard is masked by index (node >= N), never
// padded.  Infeasible nodes are never offered, so their slots stay
// -inf / -1.
//
// What bounds it.  Per (pod, node) ~510 fp32 operations against 50 bytes
// per node read once: at B = 32 the fp32 pipe is the limit, and in
// practice instruction issue: the Q-net's 32 units of 7 FMAs, a ReLU
// (max.NaN) and an FMA are ~290 instructions a pair, the features with
// their three IEEE divisions, the filter and the candidate ~80 more.  So
// the design does the work that is not per pair once per node (loads,
// pod-independent features, weight reads for P pods), rejects most
// candidates with one ballot a warp, and reduces once per block, with no
// second pass.

#include "topk_cluster.cuh"

// one node's 14 raw columns
struct NodeCols {
  float base_cpu, pods_cpu, startup_cpu, mem_used, uptime, cap, mem_cap,
      cpu_requested, mem_requested;
  int32_t num_pods, exp_pods, max_pods;
  bool cached, healthy;
};

struct ClusterCols {
  const float *base_cpu, *pods_cpu, *startup_cpu;
  const int32_t *num_pods, *exp_pods;
  const float* mem_used;
  const uint8_t *image_cached, *healthy;
  const float *uptime, *cpu_cap, *mem_cap;
  const int32_t* max_pods;
  const float *cpu_requested, *mem_requested;

  __device__ __forceinline__ NodeCols load(int g) const {
    NodeCols c;
    c.base_cpu = base_cpu[g];
    c.pods_cpu = pods_cpu[g];
    c.startup_cpu = startup_cpu[g];
    c.num_pods = num_pods[g];
    c.exp_pods = exp_pods[g];
    c.mem_used = mem_used[g];
    c.cached = image_cached[g] != 0;
    c.healthy = healthy[g] != 0;
    c.uptime = uptime[g];
    c.cap = cpu_cap[g];
    c.mem_cap = mem_cap[g];
    c.max_pods = max_pods[g];
    c.cpu_requested = cpu_requested[g];
    c.mem_requested = mem_requested[g];
    return c;
  }
};

// The per-pod inputs of P pods (pod `pod0 + p`; `valid[p]` false past B)
// and the scoring of one node for them: afterstate_features's arithmetic
// with its pod-independent half computed once.
template <int P>
struct AfterstatePods {
  AfterstateScalars sc;
  float cd[P], md[P], creq[P], mreq[P];
  bool valid[P];

  // x[p]: node g's candidate for pod p, 0 where it is infeasible (or the
  // lane has no node, !active)
  __device__ __forceinline__ void score(const float4 (*s_w)[2], float b2,
                                        const NodeCols& c, int g, bool active,
                                        cand_t (&x)[P]) const {
    const bool slot = active && c.healthy && c.num_pods < c.max_pods;
    bool ok[P];
    bool any = false;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      ok[p] = valid[p] && slot && c.cpu_requested + creq[p] <= c.cap &&
              c.mem_requested + mreq[p] <= c.mem_cap;
      any = any || ok[p];
      x[p] = 0ull;
    }
    if (!any) return;
    const float start_cost = c.cached ? sc.warm : sc.pull;
    const float np1 = (float)c.num_pods + 1.0f;
    const float ep1 = (float)c.exp_pods + 1.0f;
    const float crowd = max0(np1 - sc.crowd_knee);
    float raw0 = c.base_cpu + sc.overhead;
    raw0 = raw0 + c.pods_cpu;
    float f[6][P], q[P];
    const float n2 = np1 / (float)c.max_pods;
    const float n3 = c.healthy ? 1.0f : 0.0f;
    const float n4 = c.uptime / sc.uptime_scale;
    const float n5 = ep1 / sc.exp_scale;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float raw = raw0 + cd[p];
      raw = raw + c.startup_cpu;
      raw = raw + start_cost;
      raw = raw + sc.crowd_coeff * crowd * crowd;
      const float util = raw / c.cap;
      const float over = max0(util - sc.cont_knee);
      const float used = minv(raw + sc.cont_coeff * over * over * c.cap, c.cap);
      f[0][p] = used / c.cap;
      f[1][p] = (c.mem_used + md[p]) / c.mem_cap;
      f[2][p] = n2;
      f[3][p] = n3;
      f[4][p] = n4;
      f[5][p] = n5;
    }
    mlp_q_rows<P>(s_w, b2, f, q);
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (ok[p]) x[p] = cand_pack(q[p], g);
  }
};

// 2 blocks an SM (registers capped at 128): the plan's TOPK_FILL_BLOCKS
template <int P>
__global__ void __launch_bounds__(SDQN_BLOCK, 2)
    sdqn_score_afterstate_topk_kernel(
    ClusterCols cols, const float* __restrict__ cpu_demand,
    const float* __restrict__ mem_demand,
    const float* __restrict__ cpu_request,
    const float* __restrict__ mem_request, AfterstateScalars sc,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    float* __restrict__ out_v, int* __restrict__ out_i,  // (B, shards, k)
    int n, int b, int k, int shard_size, int chunk) {
  __shared__ float4 s_w[SDQN_HIDDEN][2];
  __shared__ float s_b2;
  __shared__ TopkShared<P> s_topk;
  stage_weights(s_w, &s_b2, w1, b1, w2, b2, nullptr);
  AfterstatePods<P> pods;
  pods.sc = sc;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int pod = blockIdx.y * P + p;
    pods.valid[p] = pod < b;
    const int at = pod < b ? pod : b - 1;
    pods.cd[p] = cpu_demand[at];
    pods.md[p] = mem_demand[at];
    pods.creq[p] = cpu_request[at];
    pods.mreq[p] = mem_request[at];
  }
  const TopkChunk ch = topk_chunk(n, shard_size, chunk);
  WarpList lists[P];
#pragma unroll
  for (int p = 0; p < P; ++p) lists[p].init();
  // warp-uniform steps: lane l of warp w takes node base + l, base =
  // start + 32 w, start + 32 w + 256, ...
  const int lane = threadIdx.x & 31;
  const int first = ch.start + (threadIdx.x - lane);
  NodeCols cur;
  if (first + lane < ch.end) cur = cols.load(first + lane);
  for (int base = first; base < ch.end; base += SDQN_BLOCK) {
    const int g = base + lane, next = g + SDQN_BLOCK;
    NodeCols nxt;     // the next node's loads are in flight while g scores
    if (next < ch.end) nxt = cols.load(next);
    cand_t x[P];
    pods.score(s_w, s_b2, cur, g, g < ch.end, x);
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
    int k, int shards, int shard_size, int cluster, int pods, int chunk,
    void* stream) {
  const AfterstateScalars sc = {pull, warm, overhead, crowd_knee, crowd_coeff,
                                cont_knee, cont_coeff, uptime_scale, exp_scale};
  const ClusterCols cols = {
      (const float*)base_cpu, (const float*)pods_cpu,
      (const float*)startup_cpu, (const int32_t*)num_pods,
      (const int32_t*)exp_pods, (const float*)mem_used,
      (const uint8_t*)image_cached, (const uint8_t*)healthy,
      (const float*)uptime, (const float*)cpu_cap, (const float*)mem_cap,
      (const int32_t*)max_pods, (const float*)cpu_requested,
      (const float*)mem_requested};
#define SDQN_AFTERSTATE_TOPK_LAUNCH(P_)                                      \
  launch_cluster_topk(sdqn_score_afterstate_topk_kernel<P_>, P_, b, k,       \
                      shards, shard_size, cluster, chunk, stream, cols,      \
                      (const float*)cpu_demand, (const float*)mem_demand,    \
                      (const float*)cpu_request, (const float*)mem_request,  \
                      sc, (const float*)w1, (const float*)b1,                \
                      (const float*)w2, (const float*)b2, (float*)out_v,     \
                      (int*)out_i, n, b, k, shard_size, chunk)
  if (pods == 1) return SDQN_AFTERSTATE_TOPK_LAUNCH(1);
  if (pods == 2) return SDQN_AFTERSTATE_TOPK_LAUNCH(2);
#undef SDQN_AFTERSTATE_TOPK_LAUNCH
  return (int)cudaErrorInvalidValue;
}
