"""The launch plan of the scoring kernels 1 and 3, on the CPU (no JAX).

``sdqn_score.score_plan`` is what the two wrappers launch: a thread scores
R rows, a node's R pods (B >= R) or R nodes for one pod.  The model below
maps every thread of the plan's grid to its rows as ``ScoreRows`` in
``csrc/sdqn_common.cuh`` does, and checks that the rows that are written
cover every (pod, node) pair exactly once.
"""
import numpy as np
import pytest

from repro_torch.kernels import sdqn_score as ss

THREADS = ss.SCORE_THREADS

# the sweep, then a shape that reaches the branch the sweep misses (pod
# rows at R = 4); tests/test_torch_cuda.py runs the kernels at all of them
SWEEP_N = (1, 37, 1000, 5000, 131072)
SWEEP_B = (1, 2, 3, 5, 32, 33)
PLAN_SHAPES = tuple((n, b) for n in SWEEP_N for b in SWEEP_B) + ((40000, 5),)
# every (R, pod rows) the launch functions instantiate
BRANCHES = {(1, True), (2, True), (4, True), (8, True), (2, False),
            (4, False), (8, False)}
# the serving paths' shapes: the flat cluster (kernel 1, N = 5000, mean B
# ~ 1.6-4 a batch, 32 in the timings) and the job->host fleet (kernel 3,
# N = 131,072, B ~ 1, 32 in the timings)
PATH_SHAPES = ((5000, 1), (5000, 2), (5000, 4), (5000, 32), (131072, 1),
               (131072, 32))


def _rows(plan, n, b):
    """The pair index pod * N + node of every row that is written, as
    ``ScoreRows::init`` maps the threads of the plan's grid to rows."""
    gx, gy, gz = plan.grid
    assert gz == 1
    bx, by, t = (a.ravel().astype(np.int64) for a in np.meshgrid(
        np.arange(gx), np.arange(gy), np.arange(THREADS), indexing="ij"))
    R = plan.rows
    out = []
    for r in range(R):
        if plan.pod_rows:
            g, p = bx * THREADS + t, by * R + r
        else:
            g, p = (bx * R + r) * THREADS + t, by
        write = (g < n) & (p < b)
        out.append(p[write] * n + g[write])
    return np.concatenate(out)


@pytest.mark.parametrize("n,b", PLAN_SHAPES)
def test_plan_writes_every_pair_exactly_once(n, b):
    plan = ss.score_plan(n, b)
    written = _rows(plan, n, b)
    assert written.size == n * b
    np.testing.assert_array_equal(np.sort(written), np.arange(n * b))


@pytest.mark.parametrize("n,b", PLAN_SHAPES + ((32767, 65535), (1, 65535)))
def test_plan_is_a_built_branch_within_the_grid_limits(n, b):
    plan = ss.score_plan(n, b)
    assert (plan.rows, plan.pod_rows) in BRANCHES
    assert plan.pod_rows == (b >= plan.rows)
    assert plan.grid[1] <= 65535 and plan.grid[2] == 1
    # the largest node index a thread forms stays an int32
    reach = plan.grid[0] * THREADS * (1 if plan.pod_rows else plan.rows)
    assert n <= reach < 2 ** 31
    assert plan.args() == (plan.rows, int(plan.pod_rows), plan.grid[0],
                           plan.grid[1])


def test_plan_shapes_reach_every_branch():
    got = {(p.rows, p.pod_rows)
           for p in (ss.score_plan(n, b) for n, b in PLAN_SHAPES)}
    assert got == BRANCHES


@pytest.mark.parametrize("n,b", PATH_SHAPES)
def test_plan_fills_the_card_at_the_paths_shapes_where_it_can(n, b):
    """The largest R whose grid keeps ``SCORE_FILL_BLOCKS`` blocks; where
    none does (the 5,000-node cluster at small B), R = 1, the most blocks
    any plan has."""
    plan = ss.score_plan(n, b)
    bigger = [r for r in ss.SCORE_ROWS if r > plan.rows]
    assert all(ss.ScorePlan.of(n, b, r).blocks < ss.SCORE_FILL_BLOCKS
               for r in bigger)
    if n == 131072 or b == 32:
        assert plan.blocks >= ss.SCORE_FILL_BLOCKS
    else:
        assert plan.rows == 1 and plan.blocks == -(-n // THREADS) * b


def test_plan_rows_are_a_nodes_pods_where_b_allows():
    assert ss.score_plan(131072, 32) == ss.ScorePlan((512, 4, 1), 8, True)
    assert ss.score_plan(5000, 32) == ss.ScorePlan((20, 16, 1), 2, True)
    # B = 1 over the job->host fleet: two hosts a thread, 256 blocks
    assert ss.score_plan(131072, 1) == ss.ScorePlan((256, 1, 1), 2, False)
    assert ss.score_plan(131072, 5) == ss.ScorePlan((64, 5, 1), 8, False)
    assert ss.score_plan(5000, 1) == ss.ScorePlan((20, 1, 1), 1, True)
