// Fused SDQN afterstate scorer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `sdqn_score_afterstate` of
// src/repro/kernels/sdqn_score.py (function at :171, pallas_call at :193).
// For each of B pods and each of N nodes it builds the six normalized
// Table-2 afterstate features from the node's raw ClusterState columns (the
// arithmetic of `_afterstate_norm_features`, sdqn_score.py:102-129, in
// sdqn_common.cuh's `afterstate_features`) and runs the Table-4 Q-net
// 6 -> 32 -> ReLU -> 1 on them in registers, writing one float32 Q-value
// per (pod, node).  The (B, N, 6) features and the (B, N, 32) hidden layer
// never reach device memory.
//
// Design.  The launch plan `sdqn_score.score_plan` (sdqn_common.cuh,
// `ScoreRows`) gives each thread R rows.  Where B allows they are one
// node's R pods: the thread loads the node's 12 columns (in their native
// dtypes: f32, int32 and bool bytes, so the caller needs no cast launches)
// once, computes the pod-independent features once (the compiler shares
// them between the R calls of `afterstate_features`) and reads each hidden
// unit's two float4 of weights once for the R pods (`mlp_q_rows`).  Where
// B < R they are R nodes for one pod.  The column loads are issued before
// the block stages its weights, so the two latencies overlap: at the
// 5,000-node cluster's small grids the kernel is a chain of such waits.  R is the largest whose grid still
// keeps 256 blocks (about 2 an SM); the 5,000-node cluster at small B gets
// R = 1 and leaves most SMs idle (splitting a row's hidden units over
// lanes to fill them measured slower, PERF.md section 6).  The weights sit
// in shared memory, two 16-byte broadcast loads per hidden unit.  Every
// score keeps mlp_q's order of operations, so kernel 4's candidates carry
// kernel 1's scores bit for bit.  The TPU grid ran blocks of 1024 lanes in
// order and padded capacities with 1; here blocks run in parallel and the
// ragged edges are masked by index.
//
// What bounds it.  Per (pod, node) ~500 fp32 operations (19 for the
// pod-dependent features, 6x32 multiply-adds, 32 ReLUs, 32 multiply-adds
// for the output) against 42 bytes per node read once and 4 bytes per
// (pod, node) written, so at B = 32 it is bound by fp32 CUDA-core
// operations, not by bytes, and in practice by instruction issue (~290
// instructions a pair for the Q-net).  The 6 -> 32 layer is too thin for
// the tensor cores, whose TF32 products would also change the bits.  At
// the serving size (N = 5000, B ~ 1) the whole launch is well under a
// microsecond of work, so the launch's own latency dominates.

#include "sdqn_common.cuh"

// one node's 12 raw columns, as loaded (the bool bytes are tested where
// they are used, so no instruction waits on a load before it must)
struct NodeCols {
  float base_cpu, pods_cpu, startup_cpu, mem_used, uptime, cap, mem_cap;
  int32_t num_pods, exp_pods, max_pods;
  uint8_t cached, healthy;
};

struct ClusterCols {
  const float *base_cpu, *pods_cpu, *startup_cpu;
  const int32_t *num_pods, *exp_pods;
  const float* mem_used;
  const uint8_t *image_cached, *healthy;
  const float *uptime, *cpu_cap, *mem_cap;
  const int32_t* max_pods;

  __device__ __forceinline__ NodeCols load(int g) const {
    NodeCols c;
    c.base_cpu = base_cpu[g];
    c.pods_cpu = pods_cpu[g];
    c.startup_cpu = startup_cpu[g];
    c.num_pods = num_pods[g];
    c.exp_pods = exp_pods[g];
    c.mem_used = mem_used[g];
    c.cached = image_cached[g];
    c.healthy = healthy[g];
    c.uptime = uptime[g];
    c.cap = cpu_cap[g];
    c.mem_cap = mem_cap[g];
    c.max_pods = max_pods[g];
    return c;
  }
};

// row r of x: node c's features as if the pod were placed on it
template <int R>
__device__ __forceinline__ void node_features(const AfterstateScalars& sc,
                                              const NodeCols& c, float cd,
                                              float md, float (&x)[6][R],
                                              int r) {
  float f[6];
  afterstate_features(sc, c.base_cpu, c.pods_cpu, c.startup_cpu, c.num_pods,
                      c.exp_pods, c.mem_used, c.cached != 0, c.healthy != 0,
                      c.uptime,
                      c.cap, c.mem_cap, c.max_pods, cd, md, f);
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i][r] = f[i];
}

// Kernel 1's arguments, and its launch for one plan (R, POD_ROWS).
struct AfterstateScore {
  ClusterCols cols;
  const float *cpu_demand, *mem_demand;  // (B,)
  AfterstateScalars sc;
  const float* w1;  // (6, 32) row-major, the reference layout
  const float* b1;  // (32,)
  const float* w2;  // (32,) = (32, 1)
  const float* b2;  // (1,)
  float* q;         // (B, N)
  int n, b;

  template <int R, bool POD_ROWS>
  void run(dim3 grid, cudaStream_t stream) const;
};

template <int R, bool POD_ROWS>
__global__ void __launch_bounds__(SDQN_BLOCK, SCORE_MIN_BLOCKS(R, POD_ROWS))
    sdqn_score_afterstate_kernel(const AfterstateScore a) {
  __shared__ float4 s_w[SDQN_HIDDEN][2];
  __shared__ float s_b2;
  ScoreRows<R, POD_ROWS> m;
  m.init(a.n, a.b);
  // a node's columns, loaded once for its R pods, or R nodes' for one pod;
  // the loads are in flight while the weights are staged
  constexpr int H = POD_ROWS ? 1 : R;
  NodeCols c[H];
#pragma unroll
  for (int h = 0; h < H; ++h) c[h] = a.cols.load(m.node[h]);
  float cd[R], md[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    cd[r] = a.cpu_demand[m.pod[r]];
    md[r] = a.mem_demand[m.pod[r]];
  }
  stage_weights(s_w, &s_b2, a.w1, a.b1, a.w2, a.b2, nullptr);
  float x[6][R], q[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    node_features<R>(a.sc, c[POD_ROWS ? 0 : r], cd[r], md[r], x, r);
  mlp_q_rows<R>(s_w, s_b2, x, q);
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (m.write[r]) a.q[(size_t)m.pod[r] * a.n + m.node[r]] = q[r];
}

template <int R, bool POD_ROWS>
void AfterstateScore::run(dim3 grid, cudaStream_t stream) const {
  sdqn_score_afterstate_kernel<R, POD_ROWS>
      <<<grid, SDQN_BLOCK, 0, stream>>>(*this);
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
    int n, int b, int rows, int pod_rows, int grid_x, int grid_y,
    void* stream) {
  const AfterstateScore a = {
      {(const float*)base_cpu, (const float*)pods_cpu,
       (const float*)startup_cpu, (const int32_t*)num_pods,
       (const int32_t*)exp_pods, (const float*)mem_used,
       (const uint8_t*)image_cached, (const uint8_t*)healthy,
       (const float*)uptime, (const float*)cpu_cap, (const float*)mem_cap,
       (const int32_t*)max_pods},
      (const float*)cpu_demand, (const float*)mem_demand,
      {pull, warm, overhead, crowd_knee, crowd_coeff, cont_knee, cont_coeff,
       uptime_scale, exp_scale},
      (const float*)w1, (const float*)b1, (const float*)w2, (const float*)b2,
      (float*)q, n, b};
  return launch_score_plan(a, n, b, rows, pod_rows, grid_x, grid_y, stream);
}
