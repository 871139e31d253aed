"""The port's job->host placement against the JAX reference.

Fleets are made with numpy (unhealthy hosts, cpu / mem / job slots near
their ceilings) and carried into both packages.  The plain twins of the
``sdqn_score`` and ``sdqn_score_cols`` kernels are held to the reference's
Pallas kernels in interpret mode (``block_n=64``, several blocks); the
FleetState arm of the API, ``PlacementEngine`` and the flat
``FleetSubstrate`` daemon to the reference's on the same inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dqn as jdqn, env as jenv
from repro.kernels import ops as jops
from repro.sched import api as japi, daemon as jdaemon, placement as jpl
from repro_torch import convert
from repro_torch.core import env as tenv
from repro_torch.core.types import NO_PLACEMENT
from repro_torch.kernels import ops as tops, sdqn_score as tss
from repro_torch.sched import api as tapi, daemon as tdaemon
from repro_torch.sched import placement as tpl
from torch_parity import BreachTimer, FakeClock, drive, fleet_np, job_stream

TOL = dict(rtol=1e-5, atol=1e-5)
TIE_TOL = 1e-5
JOBS = [(5.0, 2.0), (9.5, 4.5), (1.0, 0.5)]


def _setup(n, seed=0, tight=False):
    cols = fleet_np(n, seed, tight)
    jf = jpl.FleetState(**{k: jnp.asarray(v) for k, v in cols.items()})
    jp = jdqn.init_qnet(jax.random.PRNGKey(seed + 1))
    tf = convert.fleet_from_numpy(cols, device="cpu")
    tp = convert.qnet_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cols, jf, jp, tf, tp


def test_fleet_types_and_fresh_fleet():
    _, jf, _, tf, _ = _setup(16)
    assert tf._fields == jf._fields
    for f, x in zip(tf._fields, tf):
        want = torch.int32 if f == "num_jobs" else torch.float32
        assert x.dtype == want and x.shape == (16,), f
    np.testing.assert_array_equal(tf.features().numpy(),
                                  np.asarray(jf.features()))
    fresh = tpl.fresh_fleet(64, torch.Generator().manual_seed(0),
                            device="cpu")
    assert fresh.num_jobs.dtype == torch.int32
    assert bool(((fresh.cpu_pct >= 2) & (fresh.cpu_pct <= 10)).all())
    assert bool(((fresh.uptime_hours >= 5) & (fresh.uptime_hours <= 105)).all())
    assert bool((fresh.healthy == 1).all()) and bool((fresh.mem_pct == 5).all())
    assert tpl.MAX_JOBS_PER_HOST == jpl.MAX_JOBS_PER_HOST
    assert tpl.JOB_UTIL_DELTA_PCT == jpl.JOB_UTIL_DELTA_PCT
    assert tpl.NO_HOST == jpl.NO_HOST == NO_PLACEMENT
    np.testing.assert_array_equal(
        tpl.job_delta(tpl.JobSpec(7.0, 3.0)).numpy(),
        np.asarray(jpl.job_delta(jpl.JobSpec(7.0, 3.0))))


@pytest.mark.parametrize("n", [1, 37, 97, 1000])
def test_plain_sdqn_score_matches_pallas(n):
    cols, jf, jp, tf, tp = _setup(n, seed=n)
    want = jops.sdqn_score(jenv.normalize_features(jf.features()), jp,
                           mode="interpret", block_n=64)
    got = tops.sdqn_score(tenv.normalize_features(tf.features()), tp)
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n", [1, 37, 97, 1000])
def test_plain_score_cols_matches_pallas(n):
    cols, jf, jp, tf, tp = _setup(n, seed=n)
    deltas = np.asarray([jpl.job_delta(jpl.JobSpec(*j)) for j in JOBS],
                        np.float32)
    got = tops.sdqn_score_delta(tpl.fleet_cols(tf), torch.from_numpy(deltas),
                                tp)                             # plain
    assert got.shape == (len(JOBS), n)
    for b, d in enumerate(deltas):
        want = jops.sdqn_score_delta(jpl.fleet_cols(jf), jnp.asarray(d), jp,
                                     mode="interpret", block_n=64)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), **TOL)
    ref = tops.sdqn_score_delta(tpl.fleet_cols(tf), torch.from_numpy(deltas),
                                tp, mode="ref")
    np.testing.assert_allclose(ref.numpy(), got.numpy(), **TOL)
    one = tops.sdqn_score_delta(tpl.fleet_cols(tf), torch.from_numpy(deltas[0]),
                                tp)
    torch.testing.assert_close(one, got[0], rtol=0, atol=0)


def test_wrappers_on_cpu_run_the_plain_versions_without_counting():
    cols, jf, jp, tf, tp = _setup(64)
    feats = tenv.normalize_features(tf.features())
    w = (tp["w1"], tp["b1"], tp["w2"], tp["b2"])
    before = (tss.sdqn_score.launches, tss.sdqn_score_cols.launches)
    torch.testing.assert_close(tss.sdqn_score(feats, *w),
                               tss.sdqn_score_plain(feats, *w), rtol=0, atol=0)
    d = tpl.job_deltas([tpl.JobSpec()], "cpu")
    torch.testing.assert_close(
        tss.sdqn_score_cols(tpl.fleet_cols(tf), d, tops.FEATURE_SCALE, *w),
        tss.sdqn_score_cols_plain(tpl.fleet_cols(tf), d, tops.FEATURE_SCALE,
                                  *w), rtol=0, atol=0)
    assert (tss.sdqn_score.launches, tss.sdqn_score_cols.launches) == before
    meta = torch.zeros(4, 6, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tss.sdqn_score(meta, *w)
    with pytest.raises(ValueError, match="CUDA"):
        tops.sdqn_score(feats, tp, mode="cuda")


def test_fleet_api_matches_reference():
    cols, jf, jp, tf, tp = _setup(300, seed=2)
    for c, m in JOBS:
        jjob, tjob = jpl.JobSpec(c, m), tpl.JobSpec(c, m)
        np.testing.assert_allclose(
            tapi.heuristic_score(tf, tjob).numpy(),
            np.asarray(japi.heuristic_score(jf, jjob)), **TOL)
        np.testing.assert_allclose(
            tapi.score(tf, tjob, params=tp).numpy(),
            np.asarray(japi.score(jf, jjob, params=jp)), **TOL)
        np.testing.assert_allclose(
            tapi.score(tf, tjob, params=tp, shard=3).numpy(),
            np.asarray(japi.score(jf, jjob, params=jp, shard=False)), **TOL)
        for fused in ("auto", False, "plain"):
            assert int(tapi.select(tf, tjob, params=tp, fused=fused)) == int(
                japi.select(jf, jjob, params=jp))
    jobs = [tpl.JobSpec(*j) for j in JOBS]
    np.testing.assert_allclose(
        tapi.score_batch(tf, jobs, params=tp).numpy(),
        np.asarray(japi.score_batch(jf, [jpl.JobSpec(*j) for j in JOBS],
                                    params=jp)), **TOL)
    with pytest.raises(TypeError):
        tapi.score(object(), jobs[0], params=tp)
    with pytest.raises(ValueError, match="fused"):
        tapi.score(tf, jobs[0], params=tp, fused="interpret")


def test_fleet_guard_swaps_diverged_scores_for_the_heuristic():
    cols, jf, jp, tf, tp = _setup(50)
    job = tpl.JobSpec()
    hot = dict(tp, b2=torch.tensor([float("nan")]))
    torch.testing.assert_close(tapi.score(tf, job, params=hot, guard=True),
                               tapi.heuristic_score(tf, job))
    jhot = dict(jp, b2=jnp.asarray([jnp.nan]))
    assert int(tapi.select(tf, job, params=hot, guard=True)) == int(
        japi.select(jf, jpl.JobSpec(), params=jhot, guard=True))


@pytest.mark.parametrize("use_kernel", [None, True, False])
def test_engine_select_and_place_match_reference(use_kernel):
    cols, jf, jp, tf, tp = _setup(300, seed=3)
    eng = tpl.PlacementEngine(tp, use_kernel=use_kernel)
    jeng = jpl.PlacementEngine(jp, use_kernel=use_kernel)
    for c, m in JOBS:
        host, scores = eng.select(tf, tpl.JobSpec(c, m))
        jhost, jscores = jeng.select(jf, jpl.JobSpec(c, m))
        assert isinstance(host, torch.Tensor) and host.dim() == 0
        assert host.dtype == torch.int32 and int(host) == int(jhost)
        np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), **TOL)
        np.testing.assert_array_equal(
            eng.feasible(tf, tpl.JobSpec(c, m)).numpy(),
            np.asarray(jeng.feasible(jf, jpl.JobSpec(c, m))))
        placed = eng.place(tf, host, tpl.JobSpec(c, m))
        jplaced = jeng.place(jf, jhost, jpl.JobSpec(c, m))
        for f, x, y in zip(tf._fields, placed, jplaced):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL,
                                       err_msg=f)
    dead = tf._replace(healthy=torch.zeros(300))
    host, _ = eng.select(dead, tpl.JobSpec())
    assert int(host) == tpl.NO_HOST
    # the NO_HOST sentinel is a no-op bind
    same = eng.place(dead, host, tpl.JobSpec())
    for x, y in zip(same, dead):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_engine_place_batch_matches_reference():
    cols, jf, jp, tf, tp = _setup(200, seed=4, tight=True)
    fleet, hosts = tpl.PlacementEngine(tp).place_batch(tf, 12,
                                                       tpl.JobSpec(6.0, 3.0))
    jfleet, jhosts = jpl.PlacementEngine(jp).place_batch(
        jf, 12, jpl.JobSpec(6.0, 3.0))
    np.testing.assert_array_equal(hosts, np.asarray(jhosts))
    assert len(set(hosts.tolist())) > 1        # slots fill, hosts change
    for f, x, y in zip(tf._fields, fleet, jfleet):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL, err_msg=f)


def test_engine_score_is_the_delta_scorer_at_zero_delta():
    cols, jf, jp, tf, tp = _setup(500, seed=5)
    eng = tpl.PlacementEngine(tp)
    q = eng._score(tf.features())
    zero = tops.sdqn_score_delta(tpl.fleet_cols(tf), torch.zeros(6), tp)
    torch.testing.assert_close(q, zero, **TOL)
    np.testing.assert_allclose(
        q.numpy(), np.asarray(jpl.PlacementEngine(jp)._score(jf.features())),
        **TOL)


# ---------------------------------------------------------------------------
# the flat FleetSubstrate daemon against the reference's
# ---------------------------------------------------------------------------


def _min_gap(log):
    gaps = [np.inf]
    for q, ok in log:
        for row, okr in zip(q, ok):
            top = np.sort(row[okr])[::-1][:4]
            if top.size > 1:
                gaps.append(np.min(top[:-1] - top[1:]))
    return min(gaps)


@pytest.mark.parametrize("conflict_policy", ["requeue", "next-best"])
def test_flat_fleet_daemon_matches_reference(conflict_policy):
    cols = fleet_np(120, seed=8, tight=True)
    jparams = jdqn.init_qnet(jax.random.PRNGKey(12))
    kw = dict(batch_size=8, max_wait_s=0.005, conflict_policy=conflict_policy,
              score_deadline_s=1.0, degrade_batches=2, max_retries=3)
    t_s, jobs = job_stream(64, seed=3)

    j_clock, j_log = FakeClock(), []
    jd = jdaemon.PlacementDaemon(
        jdaemon.FleetSubstrate(jpl.FleetState(**{
            k: jnp.asarray(v) for k, v in cols.items()})),
        jparams, jdaemon.DaemonConfig(fused="interpret", **kw),
        clock=j_clock, timer=BreachTimer(2))
    inner = jd._scorer

    def jspy(params, snap, deltas, carry, n_real):
        q, ok, c = inner(params, snap, deltas, carry, n_real)
        j_log.append((np.asarray(q)[:n_real], np.asarray(ok)[:n_real]))
        return q, ok, c

    jd._scorer = jspy
    drive(jd, j_clock, t_s, [jpl.JobSpec(*j) for j in jobs], 30)

    t_clock, t_log = FakeClock(), []
    sub = tdaemon.FleetSubstrate(convert.fleet_from_numpy(cols, device="cpu"),
                                 device="cpu")
    assert all(x.dtype == np.float64 for x in sub.live)
    td = tdaemon.PlacementDaemon(
        sub, convert.qnet_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
        tdaemon.DaemonConfig(fused=True, **kw), clock=t_clock,
        timer=BreachTimer(2))
    tinner = td._scorer

    def tspy(params, snap, deltas, carry, n_real):
        q, ok, c = tinner(params, snap, deltas, carry, n_real)
        t_log.append((q.numpy(), ok.numpy()))
        return q, ok, c

    td._scorer = tspy
    drive(td, t_clock, t_s, [tpl.JobSpec(*j) for j in jobs], 30)

    assert _min_gap(j_log) > TIE_TOL
    assert len(j_log) == len(t_log)
    for (jq, jok), (tq, tok) in zip(j_log, t_log):
        n_real = len(jq)
        np.testing.assert_array_equal(jok, tok[:n_real])
        np.testing.assert_allclose(tq[:n_real], jq, **TOL)
    assert td.decisions == jd.decisions
    for f in ("submitted", "bound", "dropped", "conflicts", "requeued",
              "evictions", "batches", "device_launches", "fallback_batches"):
        assert getattr(td.metrics, f) == getattr(jd.metrics, f), f
    m = td.metrics
    assert m.conflicts > 0 and m.evictions > 0 and m.fallback_batches >= 1
    for f, jx, tx in zip(jd._sub.live._fields, jd._sub.live, td._sub.live):
        np.testing.assert_array_equal(tx, np.asarray(jx), err_msg=f)


def test_fleet_substrate_rejects_other_layouts_and_policies():
    fleet = convert.fleet_from_numpy(fleet_np(8, 0), device="cpu")
    with pytest.raises(TypeError, match="FleetLayout"):
        tdaemon.FleetSubstrate(fleet, layout=object(), device="cpu")
    with pytest.raises(TypeError, match="PolicySpec"):
        tdaemon.FleetSubstrate(fleet, policy=object(), device="cpu")
