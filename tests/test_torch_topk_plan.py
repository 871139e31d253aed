"""The launch geometry of the top-k kernels (kernels 4 and 5) and a numpy
model of their reduction, on the CPU.

``sdqn_score.topk_plan`` is what the wrapper launches: a cluster of C
blocks per (shard, group of P pods), block rank r sweeping the shard's
nodes [r * chunk, (r + 1) * chunk) clipped to the shard and to N, thread t
of the block its nodes start + t, start + t + 256, ...  The model below
follows the kernel's reduction from the same plan: each warp's best k of
its nodes per pod, the block's best k of its 8 warps, cluster rank 0's
best k of the C blocks, all in the packed order of
``csrc/sdqn_common.cuh`` (order key of the value, then ~index).  It must
give exactly what ``shard_topk``'s stable sort gives.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import sdqn_score as ss

THREADS, WARP = ss.TOPK_THREADS, 32


def _ranges(plan, n, shards, shard_size):
    """{(shard, rank): (start, end)}: the nodes each block sweeps."""
    out = {}
    for s in range(shards):
        base = s * shard_size
        for r in range(plan.cluster):
            start = base + min(r * plan.chunk, shard_size)
            end = min(n, base + min((r + 1) * plan.chunk, shard_size))
            out[s, r] = (start, max(start, end))
    return out


@pytest.mark.parametrize("n", [1, 37, 1000, 131072, 131072 + 5])
@pytest.mark.parametrize("shards", [1, 3, 8])
@pytest.mark.parametrize("b", [1, 3, 32, 65535])
def test_plan_covers_every_node_once_in_ascending_chunks(n, shards, b):
    shard_size = -(-n // shards)
    plan = ss.topk_plan(n, b, shards, shard_size)
    assert plan.grid[0] % plan.cluster == 0
    assert plan.grid[0] // plan.cluster == shards
    assert plan.grid[1] == -(-b // plan.pods) and plan.grid[2] == 1
    assert plan.grid[1] <= 65535 and plan.grid[2] <= 65535
    assert 1 <= plan.cluster <= ss.TOPK_CLUSTER_MAX <= 8    # portable
    assert plan.pods in (1, 2) and plan.pods <= b
    assert plan.shared_bytes <= 232448
    ranges = _ranges(plan, n, shards, shard_size)
    for s in range(shards):
        # ascending chunks by rank, each swept by the 256 threads in turn
        swept = np.concatenate([
            np.concatenate([np.arange(start + t, end, THREADS)
                            for t in range(THREADS)] + [np.zeros(0, int)])
            for start, end in (ranges[s, r] for r in range(plan.cluster))])
        shard = np.arange(s * shard_size, min(n, (s + 1) * shard_size))
        np.testing.assert_array_equal(np.sort(swept), shard)
        starts = [ranges[s, r][0] for r in range(plan.cluster)]
        assert starts == sorted(starts)
        for r in range(plan.cluster - 1):
            assert ranges[s, r][1] <= ranges[s, r + 1][0] or (
                ranges[s, r + 1][0] == ranges[s, r + 1][1])


def test_plan_fills_the_card_at_one_pod_and_at_thirty_two():
    n, shards = 131072, 8
    size = n // shards
    one = ss.topk_plan(n, 1, shards, size)
    assert one.blocks >= 64 and one.pods == 1
    full = ss.topk_plan(n, 32, shards, size)
    # one wave: every block resident at once, no tail
    assert full.blocks <= ss.TOPK_FILL_BLOCKS
    assert full.chunk >= ss.TOPK_MIN_CHUNK


# ---------------------------------------------------------------------------
# the numpy model of the kernels' reduction
# ---------------------------------------------------------------------------


def _pack(q, idx):
    """The kernels' packed candidate: (order key << 32) | ~index."""
    u = q.astype(np.float32).view(np.uint32).copy()
    u[u == 0x80000000] = 0                          # -0.0 ranks as +0.0
    key = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    key[np.isnan(q)] = 0xFFFFFFFF
    low = (~idx.astype(np.uint32)).astype(np.uint64)
    return (key.astype(np.uint64) << np.uint64(32)) | low


def _unpack(c):
    key = (c >> np.uint64(32)).astype(np.uint32)
    pos = (key & 0x80000000) != 0
    bits = np.where(pos, key & 0x7FFFFFFF, ~key).astype(np.uint32)
    v = bits.view(np.float32).copy()
    v[~pos & (key <= 0x007FFFFF)] = -np.inf         # -inf and empty slots
    v[key == 0xFFFFFFFF] = np.nan
    i = (~(c & np.uint64(0xFFFFFFFF)).astype(np.uint32)).astype(np.int64)
    return v, np.where(np.isfinite(v), i, -1).astype(np.int32)


def _best(c, k):
    """The best ``k`` along the last axis, descending (0 = empty pads)."""
    if c.shape[-1] < k:
        pad = np.zeros(c.shape[:-1] + (k - c.shape[-1],), np.uint64)
        c = np.concatenate([c, pad], axis=-1)
    return np.sort(c, axis=-1)[..., ::-1][..., :k]


def kernel_model(q, ok, shards, shard_size, k):
    """(B, shards, k) values and indices, reduced as the kernels reduce."""
    b, n = q.shape
    plan = ss.topk_plan(n, b, shards, shard_size)
    packed = np.where(ok, _pack(q, np.arange(n)[None, :]), np.uint64(0))
    out = np.zeros((b, shards, k), np.uint64)
    for (s, r), (start, end) in sorted(_ranges(plan, n, shards,
                                               shard_size).items()):
        nodes = packed[:, start:end]
        per = -(-nodes.shape[1] // THREADS) * THREADS
        nodes = np.concatenate(
            [nodes, np.zeros((b, per - nodes.shape[1]), np.uint64)], axis=1)
        # warp w takes nodes start + 32 w + lane + 256 m: its best k
        warps = _best(nodes.reshape(b, -1, THREADS // WARP, WARP)
                      .transpose(0, 2, 1, 3).reshape(b, THREADS // WARP, -1),
                      k)                                  # (b, 8, k)
        block = _best(warps.reshape(b, -1), k)           # (b, k)
        # cluster rank 0 merges the blocks' lists in rank order
        out[:, s] = block if r == 0 else _best(
            np.concatenate([out[:, s], block], axis=1), k)
    return _unpack(out)


def _case(kind, b=3, shards=3, shard_size=5000, seed=0):
    """Scores (float32) and feasibility for one named case; N is 3 shards
    of 5,000 less 7, so the last shard is ragged and C = 5 at B = 1."""
    n = shards * shard_size - 7
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, n)).astype(np.float32)
    ok = rng.random((b, n)) > 0.3
    chunk = ss.topk_plan(n, b, shards, shard_size).chunk
    if kind == "all_equal":
        q[:] = 0.25
        ok[:] = True
    elif kind == "boundary_ties":
        # the top value on both sides of every chunk and shard boundary
        edges = sorted({e for s in range(shards) for r in range(1, 9)
                        for e in (s * shard_size + r * chunk,
                                  s * shard_size) if 0 < e < n})
        for e in edges:
            q[:, e - 1:e + 2] = 9.0
            ok[:, e - 1:e + 2] = True
    elif kind == "nan_inf_rows":
        q[-1, rng.choice(shard_size, 40, replace=False)] = np.nan
        q[:, shard_size:2 * shard_size] = -np.inf   # feasible, -inf scores
        q[0, 2 * shard_size::97] = np.inf
        q[0, 2 * shard_size + 5::211] = np.nan
    elif kind == "infeasible_shard":
        ok[:, shard_size:2 * shard_size] = False
        ok[-1, 2 * shard_size:] = False
    elif kind == "signed_zeros":
        q[:] = np.where(rng.random((b, n)) < 0.5, -0.0, 0.0).astype(
            np.float32)
        q[:, ::1000] = -1.0
    return q, ok, shards, shard_size


@pytest.mark.parametrize("kind", ["all_equal", "boundary_ties",
                                  "nan_inf_rows", "infeasible_shard",
                                  "signed_zeros"])
@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("b", [1, 3])
def test_model_of_the_kernels_reduction_is_shard_topk(kind, k, b):
    q, ok, shards, shard_size = _case(kind, b=b)
    got_v, got_i = kernel_model(q, ok, shards, shard_size, k)
    masked = torch.where(torch.from_numpy(ok), torch.from_numpy(q),
                         -torch.inf)
    want_v, want_i = ss.shard_topk(masked, shards, shard_size, k)
    np.testing.assert_array_equal(got_v, want_v.numpy())
    np.testing.assert_array_equal(got_i, want_i.numpy())
    if kind == "all_equal":     # each shard's k lowest indices win
        lowest = np.arange(k)[None, :] + shard_size * np.arange(shards)[:, None]
        np.testing.assert_array_equal(got_i, np.broadcast_to(lowest,
                                                             got_i.shape))
    if kind == "infeasible_shard":
        assert (got_i[:, 1] == -1).all() and (got_i[-1, 2] == -1).all()
    if b == 1:          # the cross-block merge is exercised: C > 1
        n = q.shape[1]
        assert ss.topk_plan(n, b, shards, shard_size).cluster > 1
