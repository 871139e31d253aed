"""The port's two-stage sharded selection against the JAX reference.

N = 97 nodes in 5 shards on purpose: 97 % 5 != 0 leaves the last shard
ragged, and the port masks it by index where the reference pads it with
infeasible filler — the candidates must agree all the same.  The plain twins
of the top-k kernels are held to the reference's Pallas kernels in
interpret mode (``block_n=64``, so several blocks merge), the sharded winner
to the flat masked argmax, and the sharded daemons to the reference's on
the same submissions under an injected clock.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dqn as jdqn, env as jenv
from repro.core import types as jtypes
from repro.kernels import ops as jops
from repro.launch import mesh as jmesh
from repro.sched import api as japi, daemon as jdaemon, placement as jpl
from repro_torch import convert
from repro_torch.core import env as tenv, policy as tpolicy
from repro_torch.core import types as ttypes
from repro_torch.core.types import NO_PLACEMENT
from repro_torch.kernels import ops as tops
from repro_torch.launch.mesh import FleetLayout, plan_fleet_layout
from repro_torch.sched import api as tapi, daemon as tdaemon
from repro_torch.sched import placement as tpl, shard as tshard
from torch_parity import BreachTimer, FakeClock, drive, fleet_np, job_stream

N = 97
SHARDS = 5
TOL = dict(rtol=1e-5, atol=1e-5)
TIE_TOL = 1e-5      # two candidates closer than this could swap places
# pods of different demands: the batch axis of one kernel launch
DEMANDS = [(140.0, 20.0, 128.0, 100.0), (900.0, 600.0, 2048.0, 1500.0),
           (50.0, 5.0, 64.0, 32.0)]


def _cluster(n=N, seed=5):
    """Reference reset (unhealthy nodes, randomized workload), its Q-net
    and their port copies on the CPU."""
    kw = dict(unhealthy_prob=0.2, randomize_workload=True)
    jcfg = dataclasses.replace(jtypes.fleet_cluster(n), **kw)
    tcfg = dataclasses.replace(ttypes.fleet_cluster(n), **kw)
    js = jenv.reset(jax.random.PRNGKey(seed), jcfg)
    jp = jdqn.init_qnet(jax.random.PRNGKey(seed + 1))
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    tp = convert.qnet_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return js, jp, jcfg, ts, tp, tcfg


def _jfleet(cols):
    return jpl.FleetState(**{k: jnp.asarray(v) for k, v in cols.items()})


def _deltas(b, seed):
    rng = np.random.default_rng(seed)
    d = np.zeros((b, 6), np.float32)
    d[:, 0] = rng.uniform(1.0, 10.0, b)
    d[:, 1] = rng.uniform(0.5, 5.0, b)
    d[:, 2] = tpl.JOB_UTIL_DELTA_PCT
    d[:, 5] = 1.0
    return d


def _assert_candidates(got, want_vals, want_idx):
    """Port candidates vs the reference's: finite values within the
    tolerance, the same indices there, and the reference's non-finite
    slots -inf (the port's carry index -1)."""
    vals, idx = (np.asarray(x) for x in got)
    want_vals, want_idx = np.asarray(want_vals), np.asarray(want_idx)
    k = vals.shape[-1]
    assert not np.isfinite(want_vals[..., k:]).any()
    want_vals, want_idx = want_vals[..., :k], want_idx[..., :k]
    finite = np.isfinite(want_vals)
    np.testing.assert_array_equal(np.isfinite(vals), finite)
    np.testing.assert_allclose(vals[finite], want_vals[finite], **TOL)
    np.testing.assert_array_equal(idx[finite], want_idx[finite])
    assert np.all(vals[~finite] == -np.inf) and np.all(idx[~finite] == -1)


# ---------------------------------------------------------------------------
# layout planning and the shard= knob
# ---------------------------------------------------------------------------


def test_layout_geometry_matches_reference():
    lay = plan_fleet_layout(N, shards=SHARDS)
    ref = jmesh.plan_fleet_layout(N, shards=SHARDS)
    assert (lay.shards, lay.shard_size, lay.n_nodes, lay.padded) == (
        ref.shards, ref.shard_size, ref.n_nodes, ref.padded) == (5, 20, 97,
                                                                 100)
    assert plan_fleet_layout(3, shards=5) is None
    assert plan_fleet_layout(N, shards=1) is None
    assert plan_fleet_layout(N) is None
    hash(lay)


def test_resolve_layout_knob():
    lay = plan_fleet_layout(N, shards=SHARDS)
    assert tshard.resolve_layout(None, N) is None
    assert tshard.resolve_layout(False, N) is None
    assert tshard.resolve_layout("auto", N) is None     # one card
    assert tshard.resolve_layout(SHARDS, N) == lay
    assert tshard.resolve_layout(lay, N) is lay
    assert tshard.resolve_layout(FleetLayout(1, N, N), N) is None
    for bad in (True, "bogus", 2.5):
        with pytest.raises(ValueError):
            tshard.resolve_layout(bad, N)


def test_auto_is_the_flat_program_bit_for_bit():
    _, _, _, ts, tp, tcfg = _cluster()
    pod = tenv.default_pod(tcfg)
    torch.testing.assert_close(
        tapi.score(ts, pod, params=tp, cfg=tcfg, shard="auto"),
        tapi.score(ts, pod, params=tp, cfg=tcfg, shard=False), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# kernel 4 and 5 plain twins vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 37, 97, 1000])
def test_plain_topk_afterstate_matches_pallas(n):
    js, jp, jcfg, ts, tp, tcfg = _cluster(n)
    pods = convert.pods_from_numpy(*zip(*DEMANDS), device="cpu")
    for k in (1, 4):
        got = tops.sdqn_topk_afterstate(ts, pods, tcfg, tp, k=k)   # plain
        assert got[0].shape == (len(DEMANDS), min(k, n))
        for b, d in enumerate(DEMANDS):
            jpod = jtypes.PodSpec(*(jnp.float32(x) for x in d))
            wv, wi = jops.sdqn_topk_afterstate(js, jpod, jcfg, jp, k=k,
                                               mode="interpret", block_n=64)
            _assert_candidates((got[0][b], got[1][b]), wv, wi)


@pytest.mark.parametrize("n", [1, 37, 97, 1000])
def test_plain_topk_delta_matches_pallas(n):
    cols = fleet_np(n, seed=n)
    jcols = jpl.fleet_cols(_jfleet(cols))
    tcols = tpl.fleet_cols(convert.fleet_from_numpy(cols, device="cpu"))
    _, jp, _, _, tp, _ = _cluster(8)
    deltas = _deltas(3, seed=n)
    for k in (1, 4):
        got = tops.sdqn_topk_delta(tcols, torch.from_numpy(deltas), tp, k=k)
        for b in range(len(deltas)):
            wv, wi = jops.sdqn_topk_delta(jcols, jnp.asarray(deltas[b]), jp,
                                          k=k, mode="interpret", block_n=64)
            _assert_candidates((got[0][b], got[1][b]), wv, wi)


@pytest.mark.parametrize("n", [37, 1000])
def test_ref_modes_match_plain(n):
    js, jp, jcfg, ts, tp, tcfg = _cluster(n)
    pods = convert.pods_from_numpy(*zip(*DEMANDS), device="cpu")
    lay = plan_fleet_layout(n, shards=3)
    plain = tops.sdqn_topk_afterstate(ts, pods, tcfg, tp, k=4, layout=lay)
    ref = tops.sdqn_topk_afterstate(ts, pods, tcfg, tp, k=4, layout=lay,
                                    mode="ref")
    _assert_candidates(ref, *plain)
    cols = tpl.fleet_cols(convert.fleet_from_numpy(fleet_np(n, 1), "cpu"))
    d = torch.from_numpy(_deltas(3, 1))
    _assert_candidates(
        tops.sdqn_topk_delta(cols, d, tp, k=4, layout=lay, mode="ref"),
        *tops.sdqn_topk_delta(cols, d, tp, k=4, layout=lay))


# ---------------------------------------------------------------------------
# two-stage selection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 5, 8])
def test_sharded_winner_is_the_flat_masked_argmax(shards):
    js, jp, jcfg, ts, tp, tcfg = _cluster()
    lay = plan_fleet_layout(N, shards=shards)
    for d in DEMANDS:
        pod = ttypes.PodSpec(*d)
        flat = int(tapi.select(ts, pod, params=tp, cfg=tcfg, shard=False))
        assert int(tapi.select(ts, pod, params=tp, cfg=tcfg,
                               shard=lay)) == flat
        jpod = jtypes.PodSpec(*(jnp.float32(x) for x in d))
        assert flat == int(japi.select(js, jpod, params=jp, cfg=jcfg,
                                       shard=False))


@pytest.mark.parametrize("k", [1, 4, 8])
def test_k_does_not_change_the_winner(k):
    _, _, _, ts, tp, tcfg = _cluster()
    lay = plan_fleet_layout(N, shards=SHARDS)
    pod = tenv.default_pod(tcfg)
    flat = int(tapi.select(ts, pod, params=tp, cfg=tcfg, shard=False))
    for fused in ("auto", True, False):
        assert int(tshard.select_candidates(
            ts, pod, params=tp, cfg=tcfg, layout=lay, k=k,
            fused=fused)) == flat


@pytest.mark.parametrize("fused", [True, False])
def test_candidates_match_reference_topk(fused):
    js, jp, jcfg, ts, tp, tcfg = _cluster()
    lay = plan_fleet_layout(N, shards=SHARDS)
    jlay = jmesh.plan_fleet_layout(N, shards=SHARDS)
    for d in DEMANDS:
        got = tapi.topk(ts, ttypes.PodSpec(*d), params=tp, cfg=tcfg, k=3,
                        shard=lay, fused=fused)
        assert got[0].shape == (SHARDS * 3,)
        jpod = jtypes.PodSpec(*(jnp.float32(x) for x in d))
        want = japi.topk(js, jpod, params=jp, cfg=jcfg, k=3, shard=jlay,
                         fused="interpret" if fused else False)
        _assert_candidates(got, *want)


def test_fleet_candidates_match_reference_and_engine():
    cols = fleet_np(N, seed=3)
    _, jp, _, _, tp, _ = _cluster(8)
    tfleet = convert.fleet_from_numpy(cols, device="cpu")
    lay = plan_fleet_layout(N, shards=SHARDS)
    jlay = jmesh.plan_fleet_layout(N, shards=SHARDS)
    for job in (tpl.JobSpec(), tpl.JobSpec(cpu_pct_demand=9.0,
                                           mem_pct_demand=4.5)):
        jjob = jpl.JobSpec(job.cpu_pct_demand, job.mem_pct_demand)
        got = tapi.topk(tfleet, job, params=tp, k=3, shard=lay)
        want = japi.topk(_jfleet(cols), jjob, params=jp, k=3, shard=jlay,
                         fused="interpret")
        _assert_candidates(got, *want)
        host, _ = tpl.PlacementEngine(tp).select(tfleet, job)
        assert int(tshard.select_candidates(tfleet, job, params=tp,
                                            layout=lay)) == int(host)


@pytest.mark.parametrize("k", [1, 3])
def test_tie_breaks_to_the_lowest_feasible_index(k):
    """Zero weights and a constant b2 tie every node: the winner must be
    the lowest feasible index through both stages."""
    _, _, _, ts, tp, tcfg = _cluster()
    const = {name: torch.zeros_like(w) for name, w in tp.items()}
    const["b2"] = torch.tensor([0.25])
    ts = ts._replace(healthy=ts.healthy.clone().index_fill_(
        0, torch.arange(3), False))
    pod = tenv.default_pod(tcfg)
    lay = plan_fleet_layout(N, shards=SHARDS)
    lowest = int(np.argmax(tenv.feasible(ts, pod, tcfg).numpy()))
    for fused in (True, False):
        vals, idx = tshard.cluster_topk(const, ts, pod, tcfg, lay, k=k,
                                        fused=fused)
        assert int(idx[0]) == lowest
        finite = idx[torch.isfinite(vals)].numpy()
        assert np.all(np.diff(finite) > 0)      # ties listed index-ascending
    fleet = convert.fleet_from_numpy(fleet_np(N, 4), device="cpu")
    ok = tpl.PlacementEngine(const).feasible(fleet, tpl.JobSpec())
    got = tshard.select_candidates(fleet, tpl.JobSpec(), params=const,
                                   layout=lay, k=k)
    assert int(got) == int(np.argmax(ok.numpy()))


def test_all_infeasible_is_no_placement():
    _, _, _, ts, tp, tcfg = _cluster()
    dead = ts._replace(healthy=torch.zeros(N, dtype=torch.bool))
    pod = tenv.default_pod(tcfg)
    lay = plan_fleet_layout(N, shards=SHARDS)
    assert int(tapi.select(dead, pod, params=tp, cfg=tcfg,
                           shard=lay)) == NO_PLACEMENT
    vals, idx = tapi.topk(dead, pod, params=tp, cfg=tcfg, shard=lay)
    assert not torch.isfinite(vals).any() and bool((idx == -1).all())
    fleet = convert.fleet_from_numpy(fleet_np(N, 5), device="cpu")
    fleet = fleet._replace(healthy=torch.zeros(N))
    vals, idx = tapi.topk(fleet, tpl.JobSpec(), params=tp, shard=lay)
    assert not torch.isfinite(vals).any() and bool((idx == -1).all())
    assert int(tapi.select(fleet, tpl.JobSpec(), params=tp,
                           shard=lay)) == NO_PLACEMENT


def test_pull_cost_is_global_not_per_shard():
    """In-flight pulls in ONE shard inflate every shard's scores alike."""
    _, _, _, ts, tp, tcfg = _cluster()
    startup = torch.zeros(N)
    startup[:4] = 0.9 * tcfg.image_pull_cost
    # wide nodes, so the pull's cpu cost is not clipped at capacity
    ts = ts._replace(startup_cpu=startup, cpu_capacity=torch.full((N,), 64e3),
                     image_cached=torch.zeros(N, dtype=torch.bool))
    pod = tenv.default_pod(tcfg)
    lay = plan_fleet_layout(N, shards=SHARDS)
    q = tapi.score(ts, pod, params=tp, cfg=tcfg, shard=False)
    torch.testing.assert_close(
        tapi.score(ts, pod, params=tp, cfg=tcfg, shard=lay), q, **TOL)
    vals, idx = tshard.cluster_topk(tp, ts, pod, tcfg, lay, fused=True)
    masked = torch.where(tenv.feasible(ts, pod, tcfg), q, -torch.inf)
    fin = torch.isfinite(vals)
    torch.testing.assert_close(vals[fin], masked[idx[fin].long()], **TOL)
    # a per-shard reduction would price shards 1-4 without the pulls
    local = tshard.cluster_topk(tp, ts, pod, tcfg, lay, fused=True,
                                pull_cost=tenv.pull_cost_now(
                                    ts._replace(startup_cpu=startup * 0),
                                    tcfg))
    assert not torch.allclose(local[0][fin], vals[fin])


def test_nan_candidates_and_the_guard():
    js, jp, jcfg, ts, tp, tcfg = _cluster()
    lay = plan_fleet_layout(N, shards=SHARDS)
    pod = tenv.default_pod(tcfg)
    bad = dict(tp, b1=torch.full_like(tp["b1"], float("nan")))
    vals, _ = tshard.cluster_topk(bad, ts, pod, tcfg, lay, fused=True)
    assert bool(torch.isnan(vals).any())
    assert not bool(tshard.candidates_valid(vals))
    got = tshard.select_candidates(ts, pod, params=bad, cfg=tcfg, layout=lay,
                                   guard=True)
    heur = tapi.heuristic_score(ts, pod, cfg=tcfg)
    ok = tenv.feasible(ts, pod, tcfg)
    assert int(got) == int(torch.argmax(torch.where(ok, heur, -torch.inf)))
    jbad = jax.tree.map(lambda x: jnp.full_like(x, jnp.nan), jp)
    want = japi.select(js, jenv.default_pod(jcfg), params=jbad, cfg=jcfg,
                       shard=jmesh.plan_fleet_layout(N, shards=SHARDS),
                       guard=True)
    assert int(got) == int(want)
    assert bool(tshard.candidates_valid(
        tshard.cluster_topk(tp, ts, pod, tcfg, lay)[0]))


def test_unported_scorers_raise():
    """A custom score_fn (the paper's Transformer baseline) gives the
    reference's two-stage candidates, and ``api.score``/``select`` with a
    shard count its scores and winner; the FleetState arms reject it, as
    the reference's do.  A policy that is not a registered PolicySpec, and
    an embed without a sequence policy, are rejected (registered classes
    are served: tests/test_torch_policy.py)."""
    from repro.core import baselines as jbase
    from repro.sched import shard as jshard
    from repro_torch.core import baselines as tbase

    js, _, jcfg, ts, tp, tcfg = _cluster()
    lay = plan_fleet_layout(N, shards=SHARDS)
    pod = tenv.default_pod(tcfg)
    jtr = jbase.init_transformer(jax.random.PRNGKey(4))
    ttr = convert.baseline_params_from_numpy(jax.tree.map(np.asarray, jtr),
                                             "transformer", device="cpu")
    jpod = jenv.default_pod(jcfg)
    wv, wi = jshard.cluster_topk(jtr, js, jpod, jcfg,
                                 jmesh.plan_fleet_layout(N, shards=SHARDS),
                                 k=4, score_fn=jbase.transformer_score)
    gv, gi = tshard.cluster_topk(ttr, ts, pod, tcfg, lay, k=4,
                                 score_fn=tbase.transformer_score)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    q = tapi.score(ts, pod, params=ttr, cfg=tcfg, shard=SHARDS,
                   score_fn=tbase.transformer_score)
    np.testing.assert_allclose(q.numpy(), np.asarray(japi.score(
        js, jpod, params=jtr, cfg=jcfg, shard=False,
        score_fn=jbase.transformer_score)), rtol=1e-5, atol=1e-5)
    assert int(tapi.select(ts, pod, params=ttr, cfg=tcfg, shard=SHARDS,
                           score_fn=tbase.transformer_score)) == int(gi[0])
    fleet = tpl.fresh_fleet(8, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="FleetState"):
        tapi.score(fleet, tpl.JobSpec(), params=tp,
                   score_fn=tbase.transformer_score)
    unregistered = dataclasses.replace(tpolicy.get("attention"))
    for kw, err in ((dict(policy=object()), TypeError),
                    (dict(policy=unregistered), ValueError),
                    (dict(embed=torch.zeros(4)), ValueError)):
        with pytest.raises(err):
            tshard.cluster_topk(tp, ts, pod, tcfg, lay, **kw)


@pytest.mark.parametrize("entry", [
    "ops_afterstate", "ops_delta", "cluster_topk", "cluster_heuristic",
    "fleet_topk", "fleet_heuristic", "cluster_substrate", "fleet_substrate"])
def test_k_past_the_kernels_list_raises_on_the_cpu_too(entry):
    """The top-k kernels keep TOPK_MAX = 8 candidates per shard: a larger
    k raises on the CPU as on the card, and a substrate refuses it when it
    is built, not at its first batch."""
    _, _, _, ts, tp, tcfg = _cluster()
    lay = plan_fleet_layout(N, shards=SHARDS)
    pod = tenv.default_pod(tcfg)
    fleet = convert.fleet_from_numpy(fleet_np(N, 6), device="cpu")
    d = torch.as_tensor(_deltas(2, 6))
    k = 9
    calls = {
        "ops_afterstate": lambda: tops.sdqn_topk_afterstate(
            ts, pod, tcfg, tp, k=k, layout=lay),
        "ops_delta": lambda: tops.sdqn_topk_delta(tpl.fleet_cols(fleet), d,
                                                  tp, k=k, layout=lay),
        "cluster_topk": lambda: tshard.cluster_topk(tp, ts, pod, tcfg, lay,
                                                    k=k, fused=True),
        "cluster_heuristic": lambda: tshard.cluster_topk(
            tp, ts, pod, tcfg, lay, k=k, heuristic=True),
        "fleet_topk": lambda: tshard.fleet_topk(tp, fleet, tpl.JobSpec(),
                                                lay, k=k),
        "fleet_heuristic": lambda: tshard.fleet_topk(
            tp, fleet, tpl.JobSpec(), lay, k=k, heuristic=True),
        "cluster_substrate": lambda: tdaemon.ClusterSubstrate(
            ts, tcfg, device="cpu", layout=lay, topk=k),
        "fleet_substrate": lambda: tdaemon.FleetSubstrate(
            fleet, layout=lay, topk=k, device="cpu"),
    }
    with pytest.raises(ValueError, match="TOPK_MAX"):
        calls[entry]()
    assert tshard.cluster_topk(tp, ts, pod, tcfg, lay, k=8)[0].shape == (
        SHARDS * 8,)


# ---------------------------------------------------------------------------
# the sharded daemons against the reference's
# ---------------------------------------------------------------------------


def _tight_cluster(seed):
    """Node i fits only k_i more pods (k_i in 1..3), so a batch collides."""
    cfg = dataclasses.replace(jtypes.fleet_cluster(N), unhealthy_prob=0.1,
                              randomize_workload=True)
    cols = jax.tree.map(np.asarray,
                        jenv.reset(jax.random.PRNGKey(seed), cfg))._asdict()
    k = np.random.default_rng(seed).integers(1, 4, N)
    cols["cpu_requested"] = (cols["cpu_capacity"] - np.float32(1000.0) * k
                             ).astype(np.float32)
    return cfg, cols


def _requests(n, seed):
    """(t_s, [(cpu_req, cpu_dem, mem_req, mem_dem)]) at 500/s offered."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1 / 500.0, n))
    pods = np.c_[rng.uniform(100, 1000, n), rng.uniform(10, 600, n),
                 rng.uniform(64, 1024, n), rng.uniform(32, 900, n)]
    return t - t[0], [tuple(float(x) for x in p) for p in pods]


def _spy(daemon, log, reference):
    inner = daemon._scorer

    if reference:
        def scorer(params, snap, pods, carry, n_real):
            a, b, c = inner(params, snap, pods, carry, n_real)
            log.append((np.asarray(a)[:n_real], np.asarray(b)[:n_real]))
            return a, b, c
    else:
        def scorer(params, snap, pods, carry, n_real):
            a, b, c = inner(params, snap, pods, carry, n_real)
            log.append((a.numpy(), b.numpy()))
            return a, b, c
    daemon._scorer = scorer


def _min_candidate_gap(log):
    gaps = [np.inf]
    for vals, _ in log:
        for row in vals:
            fin = row[np.isfinite(row)]
            if fin.size > 1:
                gaps.append(np.min(fin[:-1] - fin[1:]))
    return min(gaps)


def _assert_same_run(jd, j_log, td, t_log):
    assert _min_candidate_gap(j_log) > TIE_TOL
    assert len(j_log) == len(t_log)
    for (jv, ji), (tv, ti) in zip(j_log, t_log):
        n_real = len(jv)             # the port's log keeps the pad rows
        _assert_candidates((tv[:n_real], ti[:n_real]), jv,
                           np.where(np.isfinite(jv), ji, -1))
    assert td.decisions == jd.decisions
    for f in ("submitted", "bound", "dropped", "shed", "conflicts",
              "requeued", "evictions", "batches", "device_launches",
              "fallback_batches"):
        assert getattr(td.metrics, f) == getattr(jd.metrics, f), f
    m = td.metrics
    assert m.bound + m.dropped + m.shed == m.submitted
    assert m.conflicts > 0 and m.evictions > 0 and m.fallback_batches >= 1
    for f, jx, tx in zip(jd._sub.live._fields, jd._sub.live, td._sub.live):
        np.testing.assert_allclose(np.asarray(tx, np.float64),
                                   np.asarray(jx, np.float64), **TOL,
                                   err_msg=f)


DAEMON_KW = dict(batch_size=8, max_wait_s=0.005, score_deadline_s=1.0,
                 degrade_batches=2, max_retries=3)


@pytest.mark.parametrize("conflict_policy", ["requeue", "next-best"])
def test_sharded_cluster_daemon_matches_reference(conflict_policy):
    jcfg, cols = _tight_cluster(seed=3)
    jparams = jdqn.init_qnet(jax.random.PRNGKey(103))
    t_s, reqs = _requests(48, seed=1)
    kw = dict(DAEMON_KW, conflict_policy=conflict_policy)

    j_clock, j_log = FakeClock(), []
    jd = jdaemon.PlacementDaemon(
        jdaemon.ClusterSubstrate(jenv.ClusterState(**cols), jcfg,
                                 layout=jmesh.plan_fleet_layout(N, shards=5),
                                 topk=3),
        jparams, jdaemon.DaemonConfig(fused="interpret", **kw),
        clock=j_clock, timer=BreachTimer(2))
    _spy(jd, j_log, reference=True)
    drive(jd, j_clock, t_s, [jtypes.PodSpec(*r) for r in reqs], 20)

    tcfg = dataclasses.replace(ttypes.fleet_cluster(N), unhealthy_prob=0.1,
                               randomize_workload=True)
    t_clock, t_log = FakeClock(), []
    td = tdaemon.PlacementDaemon(
        tdaemon.ClusterSubstrate(convert.state_from_numpy(cols, device="cpu"),
                                 tcfg, device="cpu",
                                 layout=plan_fleet_layout(N, shards=5),
                                 topk=3),
        convert.qnet_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
        tdaemon.DaemonConfig(fused=True, **kw), clock=t_clock,
        timer=BreachTimer(2))
    _spy(td, t_log, reference=False)
    drive(td, t_clock, t_s, [ttypes.PodSpec(*r) for r in reqs], 20)
    assert t_log[0][0].shape == (8, 15)       # (B, shards * topk) read back
    _assert_same_run(jd, j_log, td, t_log)


def _fleet_daemons(layout_shards, cols, jparams, kw, fused_ref="interpret"):
    jlay = (None if layout_shards is None
            else jmesh.plan_fleet_layout(N, shards=layout_shards))
    tlay = (None if layout_shards is None
            else plan_fleet_layout(N, shards=layout_shards))
    jd = jdaemon.PlacementDaemon(
        jdaemon.FleetSubstrate(_jfleet(cols), layout=jlay, topk=3), jparams,
        jdaemon.DaemonConfig(fused=fused_ref, **kw), clock=FakeClock(),
        timer=BreachTimer(2))
    td = tdaemon.PlacementDaemon(
        tdaemon.FleetSubstrate(convert.fleet_from_numpy(cols, device="cpu"),
                               layout=tlay, topk=3, device="cpu"),
        convert.qnet_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
        tdaemon.DaemonConfig(fused=True, **kw), clock=FakeClock(),
        timer=BreachTimer(2))
    return jd, td


@pytest.mark.parametrize("conflict_policy", ["requeue", "next-best"])
def test_sharded_fleet_daemon_matches_reference(conflict_policy):
    cols = fleet_np(N, seed=13, tight=True)
    jparams = jdqn.init_qnet(jax.random.PRNGKey(11))
    t_s, jobs = job_stream(48, seed=2)
    jd, td = _fleet_daemons(SHARDS, cols, jparams,
                            dict(DAEMON_KW, conflict_policy=conflict_policy))
    j_log, t_log = [], []
    _spy(jd, j_log, reference=True)
    _spy(td, t_log, reference=False)
    drive(jd, jd._clock, t_s, [jpl.JobSpec(*j) for j in jobs], 20)
    drive(td, td._clock, t_s, [tpl.JobSpec(*j) for j in jobs], 20)
    assert t_log[0][0].shape == (8, 15)
    _assert_same_run(jd, j_log, td, t_log)


@pytest.mark.parametrize("substrate", ["cluster", "fleet"])
def test_nan_params_degrade_both_sharded_daemons_alike(substrate):
    kw = dict(batch_size=8, max_wait_s=0.005, degrade_batches=2)
    t_s, reqs = _requests(40, seed=4)
    jparams = jax.tree.map(lambda x: jnp.full_like(x, jnp.nan),
                           jdqn.init_qnet(jax.random.PRNGKey(0)))
    if substrate == "cluster":
        jcfg, cols = _tight_cluster(seed=6)
        tcfg = dataclasses.replace(ttypes.fleet_cluster(N), unhealthy_prob=0.1,
                                   randomize_workload=True)
        jd = jdaemon.PlacementDaemon(
            jdaemon.ClusterSubstrate(jenv.ClusterState(**cols), jcfg,
                                     layout=jmesh.plan_fleet_layout(
                                         N, shards=5)),
            jparams, jdaemon.DaemonConfig(fused="interpret", **kw),
            clock=FakeClock())
        td = tdaemon.PlacementDaemon(
            tdaemon.ClusterSubstrate(
                convert.state_from_numpy(cols, device="cpu"), tcfg,
                device="cpu", layout=plan_fleet_layout(N, shards=5)),
            convert.qnet_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
            tdaemon.DaemonConfig(fused=True, **kw), clock=FakeClock())
        jreqs = [jtypes.PodSpec(*r) for r in reqs]
        treqs = [ttypes.PodSpec(*r) for r in reqs]
    else:
        cols = fleet_np(N, seed=8, tight=True)
        jd, td = _fleet_daemons(SHARDS, cols, jparams,
                                dict(kw, score_deadline_s=None))
        jobs = [(r[0] / 100.0, r[2] / 200.0) for r in reqs]
        jreqs = [jpl.JobSpec(*j) for j in jobs]
        treqs = [tpl.JobSpec(*j) for j in jobs]
    drive(jd, jd._clock, t_s, jreqs, fail_after=-1)
    drive(td, td._clock, t_s, treqs, fail_after=-1)
    assert td.decisions == jd.decisions
    for f in ("batches", "device_launches", "fallback_batches", "bound"):
        assert getattr(td.metrics, f) == getattr(jd.metrics, f), f
    assert td.metrics.fallback_batches == td.metrics.batches > 0
