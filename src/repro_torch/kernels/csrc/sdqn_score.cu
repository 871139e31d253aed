// SDQN Q-net on built feature rows for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `sdqn_score` of
// src/repro/kernels/sdqn_score.py (function at :51, pallas_call at :70):
// Q (N,) of N normalized (N, 6) float32 Table-2 rows through the Table-4
// Q-net 6 -> 32 -> ReLU -> 1, with the (N, 32) hidden layer kept in
// registers.  Its caller is `PlacementEngine._score`.
//
// Design.  One thread per node: it reads its 24-byte row, runs the MLP
// against the weights staged in shared memory (sdqn_common.cuh), writes
// one float.  The hidden sum starts from b1 (the reference's GEMM adds it
// last; the two orders differ by rounding only, well inside 1e-5).
//
// What bounds it.  Per node ~513 fp32 operations against 28 bytes moved:
// at 67 TFLOP/s and 3.35 TB/s the two take about the same time, so it sits
// at the ridge; 256-thread blocks fill the card from N ~ 34k up.

#include "sdqn_common.cuh"

__global__ void __launch_bounds__(SDQN_BLOCK) sdqn_score_kernel(
    const float* __restrict__ feats,  // (N, 6) row-major
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    float* __restrict__ q, int n) {
  __shared__ float4 s_w[SDQN_HIDDEN][2];
  __shared__ float s_b2;
  stage_weights(s_w, &s_b2, w1, b1, w2, b2, nullptr);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* x = feats + (size_t)i * 6;
  q[i] = mlp_q(s_w, s_b2, x[0], x[1], x[2], x[3], x[4], x[5]);
}

extern "C" int sdqn_score_launch(const void* feats, const void* w1,
                                 const void* b1, const void* w2,
                                 const void* b2, void* q, int n,
                                 void* stream) {
  const dim3 grid((n + SDQN_BLOCK - 1) / SDQN_BLOCK);
  sdqn_score_kernel<<<grid, SDQN_BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)feats, (const float*)w1, (const float*)b1,
      (const float*)w2, (const float*)b2, (float*)q, n);
  return (int)cudaGetLastError();
}
