"""The port's pod lifecycle over time — ``env.remove_pod``, the in-episode
SDQN-n consolidator (``sched.elastic.make_consolidator``), episodes and
batched trials with ``consolidate=``, and scenario-mixture training
(``train_rl.train_mixture``) — against the JAX reference.

The consolidator runs on states and ledgers the reference built, batched
over the cases the reference's ``tests/test_lifecycle.py`` names (drain,
empty, saturated, already packed) and a mid-episode churn state: identical
``moved``, pod counts and ledger rows, float columns within 1e-6.
Episodes run on the reference's resets and pod tables
(``reference_trial_draws``): identical distributions, drops and
retirements, the metric and the lifecycle integrals within 1e-5 relative.
``train_mixture`` runs on the reference's own draws, rebuilt segment by
segment with each segment's config (``reference_mixture_draws``) and
joined by ``core.draws.SegmentDraws``: identical actions (each greedy
choice's two best Q values more than 1e-5 apart, asserted), params within
1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import scenarios as jscn
from repro.core import dqn as jdqn, env as jenv, schedulers as jsched
from repro.core import train_rl as jtrain, types as jtypes
from repro.eval import engine as jeval
from repro.sched import elastic as jelastic
from repro_torch import convert, scenarios as tscn
from repro_torch.core import env as tenv, schedulers as tsched
from repro_torch.core import train_rl as ttrain, types as ttypes
from repro_torch.core.draws import ArrayDraws, SegmentDraws, TorchDraws
from repro_torch.eval import engine as teval
from repro_torch.sched import elastic as telastic
from test_torch_train import (PARAM_TOL, _close_trees, _record_port,
                              _record_reference)
from torch_parity import _np, reference_mixture_draws, reference_trial_draws

TOL = dict(rtol=1e-6, atol=1e-6)


def _port_state(js):
    return convert.state_from_numpy(_np(js), "cpu")


def _port_ledger(jl):
    jl = _np(jl)
    return ttypes.PodLedger(
        node=torch.tensor(jl.node), expiry_s=torch.tensor(jl.expiry_s),
        spec=ttypes.PodSpec(*(torch.tensor(x) for x in jl.spec)))


def test_remove_pod_matches_reference():
    cfg_j, cfg_t = jscn.make_env("hetero-bigsmall"), tscn.make_env(
        "hetero-bigsmall")
    js = jenv.reset(jax.random.PRNGKey(3), dataclasses.replace(
        cfg_j, randomize_workload=True))
    pod = jtypes.PodSpec(*(jnp.float32(x) for x in (900.0, 780.0, 2048.0,
                                                    1800.0)))
    ts = _port_state(js)
    for node, count in ((0, 1), (5, 2), (-1, 1)):
        want = jenv.remove_pod(js, jnp.int32(node), pod, count)
        got = tenv.remove_pod(ts, node, ttypes.PodSpec(*(float(x)
                                                         for x in pod)), count)
        for f, g, w in zip(jtypes.ClusterState._fields, got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f,
                                       **TOL)
    # batched: one node and one pod per cluster
    both = ttypes.ClusterState(*(torch.stack([x, x]) for x in ts))
    got = tenv.remove_pod(both, torch.tensor([0, 5]), ttypes.PodSpec(
        *(torch.tensor([float(x)] * 2) for x in pod)))
    want = jenv.remove_pod(js, jnp.int32(5), pod)
    np.testing.assert_allclose(got.pods_cpu[1].numpy(),
                               np.asarray(want.pods_cpu), **TOL)


def _loaded(cfg, pods_per_node, key=0):
    """The reference's cluster with ``pods_per_node[i]`` experiment pods on
    node i, every one ledgered with a distinct long lifetime (as
    ``tests/test_lifecycle.py`` builds it)."""
    state = jenv.reset(jax.random.PRNGKey(key), cfg)
    pod = jenv.default_pod(cfg)
    k = int(sum(pods_per_node))
    ledger = jenv.ledger_init(max(k, 1))
    slot = 0
    for node, c in enumerate(pods_per_node):
        for _ in range(c):
            state = jenv.place(state, jnp.int32(node), pod, cfg)
            ledger = jenv.ledger_record(ledger, slot, jnp.int32(node),
                                        state.time_s + 1e6 + slot, pod)
            slot += 1
    return state, ledger


def _pad_ledger(jl, k):
    """A reference ledger padded with empty slots to ``k``."""
    pad = k - jl.node.shape[0]
    empty = jenv.ledger_init(pad)
    return jax.tree.map(lambda a, b: jnp.concatenate([a, b]), jl, empty)


def _churn_state(cfg, key):
    """A mid-episode state of a churn scenario, and its ledger: the
    reference's kube episode cut after its arrivals."""
    n = 40
    k_reset, k_pods, k_act = jax.random.split(key, 3)
    state = jenv.reset(k_reset, cfg)
    table = jenv.sample_pod_table(k_pods, cfg, n)
    ledger = jenv.ledger_init(n)
    sel = jsched.make_kube_selector(cfg)
    for t, k in enumerate(jax.random.split(k_act, n)):
        pod = jtypes.PodSpec(*(x[t] for x in table.specs))
        a = sel(k, state, pod)
        state = jenv.place(state, a, pod, cfg)
        ledger = jenv.ledger_record(ledger, t, a,
                                    state.time_s + table.lifetime_s[t], pod)
        state = jenv.tick(state, cfg, table.dt_s[t])
        state, ledger, _ = jenv.retire_expired(state, ledger)
    return state, ledger


@pytest.mark.parametrize("case", ["paper", "churn"])
def test_consolidator_matches_reference(case):
    """One batched port call over every case against the reference per
    case: ``moved``, pod counts and ledger rows identical, float columns
    within 1e-6."""
    if case == "paper":
        cfg_j, cfg_t = jtypes.paper_cluster(), ttypes.paper_cluster()
        loads = [(1, 6, 1, 0), (0, 0, 0, 0), (5, 5, 5, 5), (1, 0, 0, 0),
                 (2, 1, 2, 1)]
        cases = [_loaded(cfg_j, p) for p in loads]
    else:
        cfg_j = jscn.make_env("consolidation-stress")
        cfg_t = tscn.make_env("consolidation-stress")
        cases = [_churn_state(cfg_j, jax.random.PRNGKey(s)) for s in range(4)]
    k = max(c[1].node.shape[0] for c in cases)
    cases = [(s, _pad_ledger(led, k)) for s, led in cases]
    qp = jdqn.init_qnet(jax.random.PRNGKey(2))
    cons_j = jax.jit(jelastic.make_consolidator(qp, cfg_j, max_migrations=4,
                                                idle_threshold=2))
    want = [cons_j(s, led) for s, led in cases]
    assert sum(int(w[2]) for w in want) >= 2          # the pass does move
    states = ttypes.ClusterState(*(torch.stack(c) for c in zip(
        *[_port_state(s) for s, _ in cases])))
    ledgers = [_port_ledger(led) for _, led in cases]
    ledger = ttypes.PodLedger(
        node=torch.stack([x.node for x in ledgers]),
        expiry_s=torch.stack([x.expiry_s for x in ledgers]),
        spec=ttypes.PodSpec(*(torch.stack(c) for c in zip(
            *[x.spec for x in ledgers]))))
    cons_t = telastic.make_consolidator(convert.qnet_from_numpy(_np(qp),
                                                                "cpu"),
                                        cfg_t, max_migrations=4,
                                        idle_threshold=2)
    st, led, moved = cons_t(states, ledger)
    for i, (ws, wl, wm) in enumerate(want):
        assert int(moved[i]) == int(wm), i
        np.testing.assert_array_equal(led.node[i].numpy(), np.asarray(wl.node))
        for f, g, w in zip(jtypes.ClusterState._fields, st, ws):
            w = np.asarray(w)
            if w.dtype.kind in "ib":
                np.testing.assert_array_equal(g[i].numpy(), w, err_msg=f)
            else:
                np.testing.assert_allclose(g[i].numpy(), w, err_msg=f, **TOL)
        np.testing.assert_allclose(tenv.features(ttypes.ClusterState(
            *(x[i] for x in st)), cfg_t).numpy(),
            np.asarray(jenv.features(ws, cfg_j)), **TOL)


def test_consolidation_plan_still_raises():
    """The job->host drain planner runs: on the reference's case of two
    nearly-idle hosts (``tests/test_substrates.py``) it gives the
    reference's plan (more cases: tests/test_torch_elastic.py)."""
    from repro.sched import elastic as jel, placement as jpl
    from repro_torch.sched import placement as tpl

    qp = jdqn.init_qnet(jax.random.PRNGKey(0))
    jf = jpl.fresh_fleet(6)._replace(
        cpu_pct=jnp.array([40.0, 40.0, 6.0, 7.0, 30.0, 30.0]),
        num_jobs=jnp.array([8, 8, 1, 1, 6, 6], jnp.int32))
    want = jel.consolidation_plan(jpl.PlacementEngine(qp), jf,
                                  jpl.JobSpec(cpu_pct_demand=4.0))
    got = telastic.consolidation_plan(
        tpl.PlacementEngine(convert.qnet_from_numpy(_np(qp), "cpu")),
        convert.fleet_from_numpy(_np(jf), "cpu"),
        tpl.JobSpec(cpu_pct_demand=4.0))
    assert (got.drain_hosts, got.migrations) == (want.drain_hosts,
                                                 want.migrations)
    assert got.hosts_freed == want.hosts_freed >= 1
    assert got.projected_avg_cpu_after == pytest.approx(
        want.projected_avg_cpu_after, rel=1e-5)


def _consolidating(cfg_j, cfg_t, seed=8):
    """SDQN selectors and consolidators with the reference's random net."""
    qp = jdqn.init_qnet(jax.random.PRNGKey(seed))
    tp = convert.qnet_from_numpy(_np(qp), "cpu")
    return ((jsched.make_sdqn_selector(qp, cfg_j),
             jelastic.make_consolidator(qp, cfg_j)),
            (tsched.make_sdqn_selector(tp, cfg_t),
             telastic.make_consolidator(tp, cfg_t)))


@pytest.mark.parametrize("name", ["consolidation-stress", "short-job-burst"])
def test_consolidated_batch_episode_matches_reference(name, monkeypatch):
    """``make_batch_episode(consolidate=)`` (and through it ``run_episode``)
    on the reference's draws: identical distributions, drops and
    retirements; metric and lifecycle integrals within 1e-5 relative."""
    base_j, base_t = jscn.make_env(name), tscn.make_env(name)
    cfg_j = dataclasses.replace(base_j, consolidate_every_s=30.0)
    cfg_t = dataclasses.replace(base_t, consolidate_every_s=30.0)
    (sel_j, cons_j), (sel_t, cons_t) = _consolidating(cfg_j, cfg_t)
    n = 40
    keys = jeval.fixed_trial_keys(100, 2)
    want = jeval.make_batch_episode(cfg_j, sel_j, n, cons_j)(keys)
    seen = _record_port(monkeypatch, tsched)
    draws = ArrayDraws(**reference_trial_draws(keys, cfg_j, n), device="cpu")
    passes = []

    def recorded(state, ledger):
        out = cons_t(state, ledger)
        passes.append((state.time_s.clone(), out[2].clone()))
        return out

    got = teval.make_batch_episode(cfg_t, sel_t, n, recorded,
                                   device="cpu")(draws)
    assert len(seen) == n
    # ``moved`` adds up the passes kept: those whose clock step crossed a
    # multiple of the period (the clock starts at 0, one pass a step)
    kept, before = torch.zeros_like(got.moved), torch.zeros(2)
    for t, m in passes:
        crossed = torch.floor(t / 30.0) > torch.floor(before / 30.0)
        kept, before = kept + torch.where(crossed, m, 0), t
    assert torch.equal(got.moved, kept)
    assert int(got.moved.sum()) > 0
    np.testing.assert_array_equal(got.distribution.numpy(),
                                  np.asarray(want.distribution))
    for f in ("dropped", "retired", "nodes_active_final"):
        assert getattr(got, f).tolist() == np.asarray(
            getattr(want, f)).tolist(), f
    for f in ("metric", "nodes_active", "node_seconds", "energy_wh"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   err_msg=f)
    # the pass changed the episode: without it the active nodes differ
    plain = teval.make_batch_episode(cfg_t, sel_t, n, device="cpu")(draws)
    assert not torch.equal(plain.node_seconds, got.node_seconds)
    out = teval.summarize(got)
    for k in ("nodes_active_mean", "nodes_active_final_mean",
              "node_seconds_mean", "energy_wh_mean", "retired_mean"):
        assert np.isfinite(out[k]), k
    assert out["moved_mean"] == float(got.moved.double().mean())
    assert int(plain.moved.sum()) == 0


def test_run_episode_consolidate_period_zero_is_off():
    """``consolidate_every_s = 0`` leaves the episode as without a pass."""
    cfg = tscn.make_env("short-job-burst")
    _, (sel, cons) = _consolidating(jscn.make_env("short-job-burst"), cfg)

    def run(c):
        return tenv.run_episode(TorchDraws(torch.Generator().manual_seed(0),
                                           (2,)), cfg, sel, 20,
                                consolidate=c, device="cpu")

    a, b = run(None), run(cons)
    assert torch.equal(a.metric, b.metric)
    assert torch.equal(a.stats.node_seconds, b.stats.node_seconds)
    assert int(a.stats.moved.sum()) == int(b.stats.moved.sum()) == 0


# ---------------------------------------------------------------------------
# scenario-mixture training
# ---------------------------------------------------------------------------

MIX = dict(episodes=9, pods_per_episode=24, n_envs=2, batch_size=8,
           buffer_capacity=32, target_update_every=7, variant="sdqn_n",
           energy_weight=15.0)
MIX_NAMES = ("paper-burst", "short-job-burst")   # 4 and 8 nodes; pods retire
ROUNDS = 2


@functools.lru_cache(maxsize=None)
def _reference_mixture():
    mp = pytest.MonkeyPatch()
    try:
        seen = _record_reference(mp)
        rl = jtrain.RLConfig(**MIX)
        cfgs = [jscn.make_env(n, randomize=True) for n in MIX_NAMES]
        key = jax.random.PRNGKey(5)
        params, metrics = jtrain.train_mixture(key, cfgs, rl, rounds=ROUNDS)
        params = _np(params)
    finally:
        mp.undo()
    blocks, names = reference_mixture_draws(key, cfgs, rl, ROUNDS)
    actions = {names[k]: a for k, a in seen}
    return params, _np(metrics), actions, blocks


def test_train_mixture_matches_reference(monkeypatch):
    params, metrics, actions, blocks = _reference_mixture()
    trl = ttrain.RLConfig(**MIX)
    cfgs = [tscn.make_env(n, randomize=True) for n in MIX_NAMES]
    segments = ttrain.mixture_schedule(cfgs, trl.episodes, ROUNDS)
    assert [ep0 for _, ep0, _ in segments] == [b[0] for b in blocks]
    total = sum(n for _, _, n in segments)
    assert total == 10 and total % segments[0][2] == 0
    assert trl.episodes % segments[0][2] != 0
    seen = _record_port(monkeypatch)
    draws = SegmentDraws([(ep0, ArrayDraws(**d, device="cpu"))
                          for ep0, d in blocks])
    got, tm = ttrain.train_mixture(draws, cfgs, trl, rounds=ROUNDS,
                                   device="cpu")
    assert len(seen) == total * trl.pods_per_episode
    assert len(actions) == len(seen) * trl.n_envs
    for i, a in enumerate(seen):
        ep, t = divmod(i, trl.pods_per_episode)
        want = [actions[(ep, t, e)] for e in range(trl.n_envs)]
        assert a[0].tolist() == want, (ep, t)
    _close_trees(got, params, PARAM_TOL)
    assert tm["loss"].shape == (total,)
    np.testing.assert_allclose(tm["avg_cpu"].numpy(), metrics["avg_cpu"],
                               rtol=1e-5)


def test_train_mixture_honors_episode_budget():
    """A budget smaller than cfgs x rounds is not inflated to a round (the
    rule of ``tests/test_scenarios.py``)."""
    trl = ttrain.RLConfig(episodes=5, pods_per_episode=4, n_envs=2,
                          buffer_capacity=64, batch_size=8)
    cfgs = [tscn.make_env(n, randomize=True)
            for n in ("paper-burst", "hetero-bigsmall")]
    _, metrics = ttrain.train_mixture(
        TorchDraws(torch.Generator().manual_seed(0), (2,)), cfgs, trl,
        rounds=4, device="cpu")
    assert metrics["loss"].shape == (5,)
    assert [c.scenario.name for c, _, _ in ttrain.mixture_schedule(
        cfgs, 5, 4)] == ["paper-burst", "hetero-bigsmall"] * 2 + [
            "paper-burst"]
