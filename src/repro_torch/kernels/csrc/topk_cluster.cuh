// The frame of the two top-k kernels for Hopper (sm_90a): kernel 4
// (sdqn_score_afterstate_topk.cu) and kernel 5 (sdqn_score_cols_topk in
// sdqn_score_cols.cu).  Each writes every shard's top-k, (B, shards, k),
// in one launch.
//
// Geometry (the wrapper's `sdqn_score.topk_plan` picks C, P and chunk).
// Grid (shards * C, ceil(B / P)); a thread block cluster of C blocks along
// x takes one (shard, group of P pods), and block rank r of it the nodes
// [r * chunk, (r + 1) * chunk) of the shard (clipped to the shard and to
// N).  Warp w of the block sweeps 32 consecutive nodes a step, from
// start + 32 w on, strided by the block, so every lane of a warp takes the
// same number of steps; each warp keeps its running best k per pod in a
// WarpList (sdqn_common.cuh), spread over its lanes.
//
// Reduction, all in the launch: warps 0..P-1 select the block's best k of
// the 8 warps' lists (warp_select: two warp reductions a round, no
// barrier), and after cluster.sync() rank 0 selects the shard's best k of
// the C blocks' lists, read from their shared memory (distributed shared
// memory, cluster_group::map_shared_rank), and writes them.  The packed
// candidate order is a total order (indices are unique), so every stage keeps
// "descending, NaN first, ties by ascending index" whatever the order in
// which it sees its candidates.

#pragma once

#include <cooperative_groups.h>

#include "sdqn_common.cuh"

#define TOPK_CLUSTER_MAX 8    // the portable cluster size

template <int P>
struct TopkShared {
  cand_t warp[P][SDQN_BLOCK / 32][TOPK_MAX];   // each warp's best k per pod
  cand_t block[P][TOPK_MAX];   // the block's best k per pod (read by rank 0)
};

// Where this block sweeps: shard `shard` of `shards`, its nodes
// [start, end) (rank * chunk onwards, clipped to the shard and to N).
struct TopkChunk {
  int shard, shards, rank, blocks, start, end;
};

__device__ __forceinline__ TopkChunk topk_chunk(int n, int shard_size,
                                                int chunk) {
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  TopkChunk ch;
  ch.blocks = (int)cluster.num_blocks();
  ch.rank = (int)cluster.block_rank();
  ch.shard = blockIdx.x / ch.blocks;
  ch.shards = gridDim.x / ch.blocks;
  const int base = ch.shard * shard_size;
  ch.start = base + min(ch.rank * chunk, shard_size);
  ch.end = min(n, base + min((ch.rank + 1) * chunk, shard_size));
  return ch;
}

// The block's warp lists reduced to each pod's best k of the shard,
// written by cluster rank 0 to out_v / out_i[(pod, shard, 0..k)].  All
// threads of every block of the cluster call it.
template <int P>
__device__ __forceinline__ void cluster_reduce(
    TopkShared<P>& sh, const TopkChunk& ch, const WarpList (&lists)[P],
    int b, int k, float* __restrict__ out_v, int* __restrict__ out_i) {
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (lane < k) sh.warp[p][warp][lane] = lists[p].slot;
  __syncthreads();
  if (warp < P) {      // the 8 warps' k each: lane l takes l and l + 32
    CandList<2> l;
    l.init();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int t = lane + 32 * j;
      if (t < (SDQN_BLOCK / 32) * k) l.push(sh.warp[warp][t / k][t % k]);
    }
    const cand_t w = warp_select(l, k);
    if (lane < k) sh.block[warp][lane] = w;
  }
  cluster.sync();     // every block's lists are in its shared memory
  const int pod = blockIdx.y * P + warp;
  if (ch.rank == 0 && warp < P && pod < b) {   // the C blocks' k each
    CandList<TOPK_CLUSTER_MAX * TOPK_MAX / 32> l;
    l.init();
#pragma unroll
    for (int j = 0; j < TOPK_CLUSTER_MAX * TOPK_MAX / 32; ++j) {
      const int t = lane + 32 * j;
      if (t < ch.blocks * k)
        l.push(cluster.map_shared_rank(&sh.block[warp][0], t / k)[t % k]);
    }
    const cand_t w = warp_select(l, k);
    if (lane < k) {
      const size_t o = ((size_t)pod * ch.shards + ch.shard) * k + lane;
      out_v[o] = cand_value(w);
      out_i[o] = cand_index(w);
    }
  }
  cluster.sync();     // no block leaves while rank 0 reads its lists
}

// Launch `kernel` over (shards * cluster, ceil(b / pods)) blocks in
// clusters of `cluster` along x; returns a CUDA error code (0 = launched).
template <typename... Params, typename... Args>
int launch_cluster_topk(void (*kernel)(Params...), int pods, int b, int k,
                        int shards, int shard_size, int cluster, int chunk,
                        void* stream, Args... args) {
  const int groups = (b + pods - 1) / pods;
  if (cluster < 1 || cluster > TOPK_CLUSTER_MAX || chunk < 1 ||
      (long long)cluster * chunk < shard_size || k < 1 || k > TOPK_MAX ||
      b < 1 || groups > 65535 || shards < 1 || shards > 65535)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(shards * cluster, groups, 1);
  cfg.blockDim = dim3(SDQN_BLOCK, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
