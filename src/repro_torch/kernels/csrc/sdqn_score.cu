// SDQN Q-net on built feature rows for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `sdqn_score` of
// src/repro/kernels/sdqn_score.py (function at :51, pallas_call at :70):
// Q (N,) of N normalized (N, 6) float32 Table-2 rows through the Table-4
// Q-net 6 -> 32 -> ReLU -> 1, with the (N, 32) hidden layer kept in
// registers.  Its caller is `PlacementEngine._score`.
//
// Design.  The launch plan of kernels 1 and 3 (`sdqn_score.score_plan` at
// B = 1, sdqn_common.cuh `ScoreRows`): a thread scores R rows, nodes
// x * 256 R + r * 256 + t (so a warp's loads coalesce), and reads each
// hidden unit's two float4 of weights from shared memory once for all R
// (mlp_q_rows, the order of operations of mlp_q).  A row's 24 bytes arrive
// as three float2 loads, issued before the block stages its weights, so
// they are in flight meanwhile.  R is the largest whose grid keeps 256
// blocks: 2 at N = 131,072, 1 at N = 5,000.
//
// The TPU kernel puts both products on the matrix unit.  Its counterpart
// here, the hidden layer as mma.sync.m16n8k8 in TF32 with the 3xTF32
// split (12 products a 16-row tile), was timed beside this design on an
// H100 and was slower at both N: the TF32 products of mma.sync set its
// pace (PERF.md section 6); it is not built.
//
// What bounds it.  28 bytes a row moved (24 read, 4 written): 3.7 MB at
// N = 131,072, 1.1 us at 3.35 TB/s; its ~513 float32 operations a row
// take as long at 67 TFLOP/s.  A kernel that only moves those bytes takes
// ~2 us on the H100 (launch, one load round trip, the grid's tail); the
// Q-net's ~290 instructions a row add the rest.

#include "sdqn_common.cuh"

// The kernel's arguments, and its launch for one plan (R, POD_ROWS).
struct RowScore {
  const float* feats;  // (N, 6) row-major, 8-byte aligned
  const float *w1, *b1, *w2, *b2;
  float* q;            // (N,)
  int n;

  template <int R, bool POD_ROWS>
  void run(dim3 grid, cudaStream_t stream) const;
};

template <int R, bool POD_ROWS>
__global__ void __launch_bounds__(SDQN_BLOCK, SCORE_MIN_BLOCKS(R, POD_ROWS))
    sdqn_score_kernel(const RowScore a) {
  __shared__ float4 s_w[SDQN_HIDDEN][2];
  __shared__ float s_b2;
  ScoreRows<R, POD_ROWS> m;
  m.init(a.n, 1);
  // the rows first, in flight while the weights are staged
  float x[6][R], q[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float2* p =
        reinterpret_cast<const float2*>(a.feats + (size_t)m.node[r] * 6);
    const float2 f01 = __ldg(p), f23 = __ldg(p + 1), f45 = __ldg(p + 2);
    x[0][r] = f01.x;
    x[1][r] = f01.y;
    x[2][r] = f23.x;
    x[3][r] = f23.y;
    x[4][r] = f45.x;
    x[5][r] = f45.y;
  }
  stage_weights(s_w, &s_b2, a.w1, a.b1, a.w2, a.b2, nullptr);
  mlp_q_rows<R>(s_w, s_b2, x, q);
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (m.write[r]) a.q[m.node[r]] = q[r];
}

template <int R, bool POD_ROWS>
void RowScore::run(dim3 grid, cudaStream_t stream) const {
  sdqn_score_kernel<R, POD_ROWS><<<grid, SDQN_BLOCK, 0, stream>>>(*this);
}

// One launch of the plan (rows, pod_rows, grid_x) that score_plan(n, 1)
// gives; returns a CUDA error code (0 = launched).
extern "C" int sdqn_score_launch(const void* feats, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* b2, void* q, int n, int rows,
                                 int pod_rows, int grid_x, void* stream) {
  const RowScore k{(const float*)feats, (const float*)w1, (const float*)b1,
                   (const float*)w2,    (const float*)b2, (float*)q, n};
  return launch_score_plan(k, n, 1, rows, pod_rows, grid_x, 1, stream);
}
