"""The port's TOPSIS scorer (``repro_torch.sched.topsis``,
``api.topsis_score``), the job->host drain planner
(``sched.elastic.consolidation_plan``) and the straggler monitor
(``sched.straggler.StragglerMonitor``) against the JAX reference.

Fleets and Q-nets are drawn by the reference and carried across with
``convert``.  TOPSIS scores agree within 1e-5; plans and evacuations must
be the reference's: the same drained hosts, targets and migrations, the
projected CPU within 1e-5, and the fleets after them equal column by
column (within 1e-5).  Cases are those of the reference's
``tests/test_online.py`` (TOPSIS), ``tests/test_elastic.py`` and
``tests/test_substrates.py`` (plans and evacuations).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dqn as jdqn, env as jenv, types as jtypes
from repro.sched import api as japi, topsis as jtopsis
from repro.sched.elastic import consolidation_plan as jplan
from repro.sched.placement import (JobSpec as JJob, PlacementEngine as JEngine,
                                   fresh_fleet as jfresh)
from repro.sched.straggler import StragglerMonitor as JMonitor
from repro_torch import convert
from repro_torch.core import env as tenv, types as ttypes
from repro_torch.core.types import NO_PLACEMENT
from repro_torch.sched import api as tapi, topsis as ttopsis
from repro_torch.sched.elastic import ConsolidationPlan, consolidation_plan
from repro_torch.sched.placement import JobSpec, PlacementEngine
from repro_torch.sched.straggler import StragglerMonitor

TOL = dict(rtol=1e-5, atol=1e-5)
CFG_J, CFG_T = jtypes.paper_cluster(), ttypes.paper_cluster()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _fleet(jf):
    return convert.fleet_from_numpy(_np(jf), "cpu")


def _engines(seed=0):
    qp = jdqn.init_qnet(jax.random.PRNGKey(seed))
    return JEngine(qp), PlacementEngine(convert.qnet_from_numpy(_np(qp),
                                                                "cpu"))


def _same_fleet(got, want):
    for f, g, w in zip(got._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f, **TOL)


@pytest.fixture(scope="module")
def state():
    js = jenv.reset(jax.random.PRNGKey(1), CFG_J)
    return js, convert.state_from_numpy(_np(js), "cpu")


OVERSIZED = (1e9, 1e9, 1e9, 1e9)


# ---------------------------------------------------------------------------
# TOPSIS
# ---------------------------------------------------------------------------


def test_closeness_range_ranking_and_reference():
    crit = [[0.1, 0.1, 0.0, 0.1], [0.5, 0.4, 1.0, 0.3],
            [0.9, 0.8, 1.0, 0.6]]
    c = ttopsis.closeness(torch.tensor(crit))
    assert c.shape == (3,)
    assert bool(torch.all((c >= 0) & (c <= 1)))
    assert int(torch.argmax(c)) == 0 and float(c[1]) > float(c[2])
    np.testing.assert_allclose(c.numpy(), np.asarray(
        jtopsis.closeness(jnp.asarray(crit))), **TOL)
    # a batch of criteria sets, each with its own weights' closeness
    rng = np.random.default_rng(0)
    batch = rng.uniform(0, 100, (3, 11, 4)).astype(np.float32)
    for w in (jtopsis.DEFAULT_WEIGHTS, (0.05, 0.05, 0.9, 0.0)):
        got = ttopsis.closeness(torch.tensor(batch), w)
        for i in range(3):
            np.testing.assert_allclose(got[i].numpy(), np.asarray(
                jtopsis.closeness(jnp.asarray(batch[i]), w)), **TOL)
    assert ttopsis.DEFAULT_WEIGHTS == jtopsis.DEFAULT_WEIGHTS


def test_closeness_degenerate_uniform():
    c = ttopsis.closeness(torch.ones(5, 4))
    assert bool(torch.isfinite(c).all())
    np.testing.assert_allclose(c.numpy(), c[0].item())


def test_cluster_scores_and_selector_match_reference(state):
    js, ts = state
    jpod, tpod = jenv.default_pod(CFG_J), tenv.default_pod(CFG_T)
    q = ttopsis.topsis_scores(ts, tpod, cfg=CFG_T)
    assert q.shape == (CFG_T.n_nodes,) and bool(torch.isfinite(q).all())
    np.testing.assert_allclose(q.numpy(), np.asarray(
        jtopsis.topsis_scores(js, jpod, cfg=CFG_J)), **TOL)
    sel = ttopsis.make_topsis_selector(CFG_T)
    node = int(sel(None, ts, tpod))
    assert node == int(jtopsis.make_topsis_selector(CFG_J)(
        jax.random.PRNGKey(0), js, jpod))
    assert bool(tenv.feasible(ts, tpod, CFG_T)[node])
    # infeasible everywhere -> NO_PLACEMENT, like every selector
    assert int(sel(None, ts, ttypes.PodSpec(*OVERSIZED))) == NO_PLACEMENT
    # a batch of clusters, one pod each: each cluster's own scores
    both = ttypes.ClusterState(*(torch.stack([x, x]) for x in ts))
    pods = ttypes.PodSpec(*(torch.tensor([float(v), 2.0 * float(v)])
                            for v in tpod))
    qb = ttopsis.topsis_scores(both, pods, cfg=CFG_T)
    np.testing.assert_allclose(qb[0].numpy(), q.numpy(), **TOL)
    pod2 = jtypes.PodSpec(*(2.0 * x for x in jpod))
    np.testing.assert_allclose(qb[1].numpy(), np.asarray(
        jtopsis.topsis_scores(js, pod2, cfg=CFG_J)), **TOL)


def test_fleet_dispatch_and_api_parity(state):
    js, ts = state
    jf = jfresh(6, jax.random.PRNGKey(2))
    tf = _fleet(jf)
    qf = ttopsis.topsis_scores(tf, JobSpec(cpu_pct_demand=10.0))
    assert qf.shape == (6,) and bool(torch.isfinite(qf).all())
    np.testing.assert_allclose(qf.numpy(), np.asarray(
        jtopsis.topsis_scores(jf, JJob(cpu_pct_demand=10.0))), **TOL)
    assert torch.equal(tapi.topsis_score(tf, JobSpec(cpu_pct_demand=10.0)),
                       qf)
    tpod = tenv.default_pod(CFG_T)
    assert torch.equal(tapi.topsis_score(ts, tpod, cfg=CFG_T),
                       ttopsis.topsis_scores(ts, tpod, cfg=CFG_T))
    np.testing.assert_allclose(
        tapi.topsis_score(ts, tpod, cfg=CFG_T).numpy(),
        np.asarray(japi.topsis_score(js, jenv.default_pod(CFG_J),
                                     cfg=CFG_J)), **TOL)
    assert "topsis_score" in tapi.__all__
    with pytest.raises(ValueError, match="cfg"):
        ttopsis.topsis_scores(ts, tpod)
    with pytest.raises(TypeError, match="unsupported"):
        ttopsis.topsis_scores(object(), tpod)


def test_energy_weight_prefers_warm_nodes(state):
    _, ts = state
    exp = torch.zeros_like(ts.exp_pods)
    exp[1] = 3                                # one warm node
    st = ts._replace(exp_pods=exp)
    green = ttopsis.topsis_scores(st, tenv.default_pod(CFG_T), cfg=CFG_T,
                                  weights=(0.05, 0.05, 0.9, 0.0))
    assert int(torch.argmax(green)) == 1


# ---------------------------------------------------------------------------
# consolidation_plan
# ---------------------------------------------------------------------------


def _same_plan(got, want):
    assert isinstance(got, ConsolidationPlan)
    assert got.drain_hosts == want.drain_hosts
    assert got.target_hosts == want.target_hosts
    assert got.migrations == want.migrations
    assert got.hosts_freed == want.hosts_freed
    for f in ("projected_avg_cpu_before", "projected_avg_cpu_after"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), **TOL)


def test_plan_frees_hosts_as_reference():
    """``tests/test_substrates.py``'s two nearly-idle hosts."""
    jeng, teng = _engines()
    jf = jfresh(6)._replace(
        cpu_pct=jnp.array([40.0, 40.0, 6.0, 7.0, 30.0, 30.0]),
        num_jobs=jnp.array([8, 8, 1, 1, 6, 6], jnp.int32))
    tf = _fleet(jf)
    before = [x.clone() for x in tf]
    want = jplan(jeng, jf, JJob(cpu_pct_demand=4.0))
    got = consolidation_plan(teng, tf, JobSpec(cpu_pct_demand=4.0))
    _same_plan(got, want)
    assert got.hosts_freed >= 1
    assert got.projected_avg_cpu_after <= got.projected_avg_cpu_before + 1e-3
    # the caller's fleet is not written
    assert all(torch.equal(a, b) for a, b in zip(before, tf))


def _loaded_fleet(n, seed, max_jobs=6, demand=3.0):
    """The reference's fresh fleet with 0 to ``max_jobs - 1`` jobs a host,
    their load on the host's columns."""
    rng = np.random.default_rng(seed)
    jobs = rng.integers(0, max_jobs, n).astype(np.int32)
    jf = jfresh(n, jax.random.PRNGKey(seed))
    return jf._replace(
        cpu_pct=jf.cpu_pct + jnp.asarray(demand * jobs, jnp.float32),
        mem_pct=jf.mem_pct + jnp.asarray(2.0 * jobs, jnp.float32),
        job_util_pct=jnp.asarray(4.0 * jobs, jnp.float32),
        num_jobs=jnp.asarray(jobs))


@pytest.mark.parametrize("n,threshold,seed", [(64, 3, 3), (200, 2, 5)])
def test_plan_on_a_loaded_fleet_matches_reference(n, threshold, seed):
    """Fleets with a few jobs on most hosts, drained at two thresholds:
    the same plan through ``engine.select``'s column-kernel path (its
    plain version here) and its unfused path."""
    jeng, teng = _engines(seed)
    job_j, job_t = JJob(cpu_pct_demand=3.0), JobSpec(cpu_pct_demand=3.0)
    jf = _loaded_fleet(n, seed)
    want = jplan(jeng, jf, job_j, idle_threshold_jobs=threshold)
    assert want.migrations and want.hosts_freed > 1
    for use_kernel in (None, False):
        teng.use_kernel = use_kernel
        _same_plan(consolidation_plan(teng, _fleet(jf), job_t,
                                      idle_threshold_jobs=threshold), want)


# ---------------------------------------------------------------------------
# the straggler monitor
# ---------------------------------------------------------------------------


def _monitors(n_hosts, slow, window=8, threshold=1.5):
    mons = (JMonitor(window=window, threshold=threshold),
            StragglerMonitor(window=window, threshold=threshold))
    for _ in range(window):
        for h in range(n_hosts):
            for m in mons:
                m.record(h, 3.0 if h == slow else 1.0)
    return mons


def test_straggler_evacuation_then_consolidation_matches_reference():
    """``tests/test_elastic.py``'s recovery loop: evacuate a straggler,
    then consolidate; jobs conserved, the reference's migrations, fleets
    and plan."""
    jeng, teng = _engines()
    jf, _ = jeng.place_batch(jfresh(8, jax.random.PRNGKey(1)), 24,
                             JJob(cpu_pct_demand=3.0))
    for _ in range(3):                       # the straggler runs jobs too
        jf = jeng.place(jf, 5, JJob(cpu_pct_demand=3.0))
    tf = _fleet(jf)
    total = int(tf.num_jobs.sum())
    jmon, tmon = _monitors(8, slow=5)
    assert tmon.stragglers() == jmon.stragglers() == [5]
    jf2, jmig = jmon.evacuate(jeng, jf, JJob(cpu_pct_demand=3.0))
    tf2, tmig = tmon.evacuate(teng, tf, JobSpec(cpu_pct_demand=3.0))
    assert tmig == jmig and tmig
    _same_fleet(tf2, jf2)
    assert int(tf2.num_jobs.sum()) == total and int(tf2.num_jobs[5]) == 0
    assert tmon.evacuated == jmon.evacuated == [5]
    _same_plan(consolidation_plan(teng, tf2, JobSpec(cpu_pct_demand=3.0),
                                  idle_threshold_jobs=2),
               jplan(jeng, jf2, JJob(cpu_pct_demand=3.0),
                     idle_threshold_jobs=2))


def test_straggler_detection_and_evacuation_as_reference():
    """``tests/test_substrates.py``'s case: three jobs leave host 2."""
    jeng, teng = _engines()
    jmon, tmon = _monitors(4, slow=2)
    assert tmon.stragglers() == [2]
    jf = jfresh(4)._replace(num_jobs=jnp.array([2, 2, 3, 2], jnp.int32))
    jf2, jmig = jmon.evacuate(jeng, jf, JJob(cpu_pct_demand=2.0))
    tf2, tmig = tmon.evacuate(teng, _fleet(jf), JobSpec(cpu_pct_demand=2.0))
    assert tmig == jmig and len(tmig) == 3
    assert all(dst != 2 for _, dst in tmig)
    _same_fleet(tf2, jf2)


def test_evacuated_host_heals_on_fresh_fast_samples():
    _, teng = _engines()
    tf = _fleet(jfresh(8, jax.random.PRNGKey(1)))
    _, mon = _monitors(8, slow=5)
    tf, _ = mon.evacuate(teng, tf, JobSpec(cpu_pct_demand=3.0))
    assert mon.evacuated == [5] and float(tf.healthy[5]) == 0.0
    tf, healed = mon.recover(tf)             # no fresh samples yet
    assert healed == []
    for _ in range(4):                       # still slow: stays out
        mon.record(5, 3.0)
        mon.record(0, 1.0)
    tf, healed = mon.recover(tf)
    assert healed == []
    for _ in range(8):                       # fast again: rejoins
        mon.record(5, 1.0)
    tf, healed = mon.recover(tf)
    assert healed == [5] and mon.evacuated == []
    assert float(tf.healthy[5]) == 1.0


def test_evacuation_honors_no_placement_sentinel():
    """No feasible target anywhere: the jobs drain off with their host."""
    _, teng = _engines()
    tf = _fleet(jfresh(4, jax.random.PRNGKey(2)))
    for _ in range(3):
        tf = teng.place(tf, 0, JobSpec(cpu_pct_demand=3.0))
    tf = tf._replace(healthy=torch.tensor([1.0, 0.0, 0.0, 0.0]))
    mon = StragglerMonitor()
    tf, migrations = mon.evacuate(teng, tf, JobSpec(cpu_pct_demand=3.0),
                                  hosts=[0])
    assert migrations == [] and int(tf.num_jobs[0]) == 0
    assert mon.evacuated == [0]
