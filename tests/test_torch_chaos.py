"""Chaos in the port's episodes (``repro_torch.core.env``: failure traces,
eviction into the reschedule ring, one re-placement attempt per arrival)
against the JAX reference.

Traces are sampled on the reference's own unit exponentials (``fold_in``
keys of ``repro/core/env.py:sample_failure_trace``) and must equal its
windows within 1e-6.  Episodes run on the reference's own draws
(``reference_chaos_draws`` adds to ``reference_trial_draws`` the trace
exponentials of ``fold_in(key, 13)`` and the re-placement tie-breaks of
``fold_in(step_key, 17)``): identical pod distributions, drops and
``evicted`` / ``rescheduled`` / ``lost`` counts, the metric within 1e-5
relative.  An empty trace reproduces the episode without one for every
policy class: identical placements, metric within 1e-6.
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
from repro.core import types as jtypes
from repro.eval import engine as jeval
from repro_torch import convert, scenarios as tscn
from repro_torch.core import dqn as tdqn, env as tenv, policy as tpol
from repro_torch.core import schedulers as tsched, types as ttypes
from repro_torch.core.draws import ArrayDraws, TorchDraws
from torch_parity import (_np, reference_chaos_draws,  # noqa: F401
                          reference_failure_units, reference_trial_draws)

CHAOS_SCENARIOS = ("preemptible-flaky", "batch-flaky", "train-flaky")
RTOL = 1e-5


def flaky_cfgs(**overrides):
    """``preemptible-flaky`` with an aggressive MTBF, so that a short
    episode sees failures (``tests/test_chaos.py``'s ``_flaky_cfg``), in
    both packages."""
    def flaky(scn):
        return dataclasses.replace(scn, node_classes=tuple(
            dataclasses.replace(c, mtbf_s=60.0, mttr_s=30.0)
            if np.isfinite(c.mtbf_s) else c for c in scn.node_classes))

    return (jtypes.scenario_env(flaky(jscn.get_scenario("preemptible-flaky")),
                                **overrides),
            ttypes.scenario_env(flaky(tscn.get_scenario("preemptible-flaky")),
                                **overrides))


# ---------------------------------------------------------------------------
# failure traces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [None] + list(CHAOS_SCENARIOS))
def test_trace_sampling_matches_reference(name):
    if name is None:
        jcfg, tcfg = jtypes.paper_cluster(), ttypes.paper_cluster()
    else:
        jcfg, tcfg = jscn.make_env(name), tscn.make_env(name)
    key = jax.random.PRNGKey(1)
    want = jenv.sample_failure_trace(key, jcfg)
    e = torch.tensor(np.asarray(reference_failure_units(key, jcfg)))
    got = tenv.sample_failure_trace(tcfg, e, "cpu")
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (jcfg.chaos_cycles, jcfg.n_nodes)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6)
        np.testing.assert_array_equal(np.isinf(g.numpy()), np.isinf(w))
        assert not np.isnan(g.numpy()).any()
    assert tenv.has_chaos(tcfg) == jenv.has_chaos(jcfg) == (name is not None)
    if name is None:
        assert bool(torch.isinf(got.fail_s).all())
        assert not bool(tenv.trace_down(got, 1e9).any())
    else:
        # the flaky classes fail, the reliable ones never do; windows are
        # ordered where finite
        assert bool(torch.isfinite(got.fail_s).any())
        assert bool(torch.isinf(got.fail_s).any())
        fin = torch.isfinite(got.fail_s)
        assert bool(torch.all(got.recover_s[fin] > got.fail_s[fin]))
    # a batch of exponentials gives a batch of traces
    batch = tenv.sample_failure_trace(tcfg, e.expand(3, *e.shape), "cpu")
    assert batch.fail_s.shape == (3, jcfg.chaos_cycles, jcfg.n_nodes)
    assert torch.equal(batch.recover_s[2], got.recover_s)


def test_trace_down_window_semantics():
    inf = float("inf")
    trace = ttypes.FailureTrace(fail_s=torch.tensor([[10.0, inf]]),
                                recover_s=torch.tensor([[20.0, inf]]))
    jtrace = jtypes.FailureTrace(*(jnp.asarray(x.numpy()) for x in trace))
    times = [5.0, 10.0, 19.9, 20.0]
    for t, expect in zip(times, ([False, False], [True, False],
                                 [True, False], [False, False])):
        assert tenv.trace_down(trace, t).tolist() == expect
        np.testing.assert_array_equal(
            np.asarray(jenv.trace_down(jtrace, jnp.float32(t))), expect)
    # one clock per cluster: a (B,) clock gives (B, N)
    got = tenv.trace_down(trace, torch.tensor(times))
    assert got.tolist() == [[False, False], [True, False], [True, False],
                            [False, False]]
    empty = tenv.empty_failure_trace(5, 3, device="cpu")
    assert empty.fail_s.shape == (3, 5)
    assert not bool(tenv.trace_down(empty, torch.tensor([0.0, 1e9])).any())


# ---------------------------------------------------------------------------
# the reschedule ring
# ---------------------------------------------------------------------------


def test_ring_overflow_is_counted_not_silent():
    q = tenv.reschedule_queue_init(2, device="cpu")
    q2, lost = tenv._queue_push(q, torch.tensor([True, True, True, False]),
                                torch.tensor([1.0, 2.0, 3.0, 4.0]), 2)
    assert int(q2.count) == 2 and int(lost) == 1
    assert q2.slot.tolist() == [0, 1]
    assert q2.remaining_s.tolist() == [1.0, 2.0]


def test_ring_push_wraps_around_head():
    q = tenv.reschedule_queue_init(3, device="cpu")._replace(
        head=torch.tensor(2, dtype=torch.int32))
    q2, lost = tenv._queue_push(q, torch.tensor([True, True, False]),
                                torch.tensor([7.0, 8.0, 0.0]), 3)
    assert int(lost) == 0 and int(q2.count) == 2
    # ring positions 2 and 0 (wrap), oldest first
    assert int(q2.slot[2]) == 0 and int(q2.slot[0]) == 1


def test_ring_push_matches_reference_per_cluster():
    """A batch of rings, each with its own head, count and mask, against
    the reference's ring one cluster at a time."""
    rng = np.random.default_rng(0)
    cap, k, b = 5, 9, 6
    heads = rng.integers(0, cap, b).astype(np.int32)
    counts = rng.integers(0, cap + 1, b).astype(np.int32)
    masks = rng.random((b, k)) < 0.5
    vals = rng.uniform(0, 100, (b, k)).astype(np.float32)
    slots = rng.integers(-1, k, (b, cap)).astype(np.int32)
    rem = rng.uniform(0, 10, (b, cap)).astype(np.float32)
    q = tenv.RescheduleQueue(torch.tensor(slots), torch.tensor(rem),
                             torch.tensor(heads), torch.tensor(counts))
    got, lost = tenv._queue_push(q, torch.tensor(masks), torch.tensor(vals),
                                 cap)
    for i in range(b):
        jq = jenv.RescheduleQueue(jnp.asarray(slots[i]), jnp.asarray(rem[i]),
                                  jnp.int32(heads[i]), jnp.int32(counts[i]))
        want, wlost = jenv._queue_push(jq, jnp.asarray(masks[i]),
                                       jnp.asarray(vals[i]), cap)
        assert got.slot[i].tolist() == np.asarray(want.slot).tolist(), i
        np.testing.assert_array_equal(got.remaining_s[i].numpy(),
                                      np.asarray(want.remaining_s))
        assert int(got.count[i]) == int(want.count)
        assert int(lost[i]) == int(wlost)


# ---------------------------------------------------------------------------
# an empty trace changes nothing, for every policy class
# ---------------------------------------------------------------------------


def _port_selectors(cfg):
    """(name, select, carry) for kube, SDQN and every registered class."""
    out = [("kube", tsched.make_kube_selector(cfg), None),
           ("sdqn", tsched.make_sdqn_selector(tdqn.init_qnet(
               torch.Generator().manual_seed(0), device="cpu"), cfg), None)]
    for name in tpol.names():
        spec = tpol.get(name)
        params = spec.init(torch.Generator().manual_seed(1), device="cpu")
        select, carry = tsched.make_policy_selector(spec, params, cfg)
        out.append((name, select, carry))
    return out


@pytest.mark.parametrize("scenario", [None, "diurnal-churn"])
def test_empty_trace_reproduces_every_policy_class(scenario):
    cfg = (ttypes.paper_cluster() if scenario is None
           else tscn.make_env(scenario))
    empty = tenv.empty_failure_trace(cfg.n_nodes, cfg.chaos_cycles,
                                     device="cpu")
    selectors = _port_selectors(cfg)
    assert {n for n, _, _ in selectors} >= {"kube", "sdqn", "mlp",
                                            "attention", "mamba"}
    for name, select, carry in selectors:
        def run(trace):
            draws = TorchDraws(torch.Generator().manual_seed(7), (2,))
            return tenv.run_episode(draws, cfg, select, 12,
                                    select_carry=carry, failure_trace=trace,
                                    device="cpu")

        ref, got = run(None), run(empty)
        assert torch.equal(ref.placements, got.placements), name
        assert float((ref.metric - got.metric).abs().max()) <= 1e-6, name
        assert torch.equal(ref.dropped, got.dropped), name
        assert int(got.stats.evicted.sum()) == 0, name
        assert int(got.stats.lost.sum()) == 0, name
        assert int(got.stats.rescheduled.sum()) == 0, name


# ---------------------------------------------------------------------------
# flaky episodes on the reference's traces and draws
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_episodes(kind, n, trials, explicit):
    """The reference's ``run_episode`` on trial keys 100.., vmapped:
    ``(keys, stats and outputs as numpy)``; ``explicit`` passes a fixed
    trace instead of the sampled one."""
    jcfg, _ = flaky_cfgs()
    if kind == "kube":
        select = jsched.make_kube_selector(jcfg)
    else:
        select = jsched.make_sdqn_selector(jdqn.init_qnet(
            jax.random.PRNGKey(0)), jcfg)
    trace = _explicit_trace(jcfg.n_nodes)[0] if explicit else None
    keys = jeval.fixed_trial_keys(100, trials)

    @jax.jit
    def run(ks):
        return jax.vmap(lambda k: jenv.run_episode(
            k, jcfg, select, n, failure_trace=trace))(ks)

    return keys, _np(run(keys))


def _explicit_trace(n):
    """Every other node down over [20, 60) s and every third over [90, 95)
    s; as a reference and a port trace."""
    inf = np.float32(np.inf)
    fail = np.full((2, n), inf, np.float32)
    rec = np.full((2, n), inf, np.float32)
    fail[0, ::2], rec[0, ::2] = 20.0, 60.0
    fail[1, ::3], rec[1, ::3] = 90.0, 95.0
    return (jtypes.FailureTrace(jnp.asarray(fail), jnp.asarray(rec)),
            ttypes.FailureTrace(torch.tensor(fail), torch.tensor(rec)))


def _same_episode(got, want):
    np.testing.assert_array_equal(got.placements.numpy(), want.placements)
    np.testing.assert_array_equal(got.state.exp_pods.numpy(),
                                  want.state.exp_pods)
    assert got.dropped.tolist() == want.dropped.tolist()
    for f in ("evicted", "rescheduled", "lost", "retired"):
        assert getattr(got.stats, f).tolist() == getattr(
            want.stats, f).tolist(), f
    np.testing.assert_allclose(got.metric.numpy(), want.metric, rtol=RTOL)
    for f in ("node_seconds", "energy_wh", "nodes_active_mean"):
        np.testing.assert_allclose(getattr(got.stats, f).numpy(),
                                   getattr(want.stats, f), rtol=RTOL,
                                   err_msg=f)


@pytest.mark.parametrize("kind,explicit", [("kube", False), ("sdqn", False),
                                           ("kube", True)])
def test_flaky_episode_matches_reference(kind, explicit):
    """kube and SDQN on the aggressive-MTBF pool, on the reference's own
    trace (or an explicit one) and draws: identical placements, drops and
    chaos counts, with evictions, re-placements and losses all seen."""
    n, trials = 40, 4
    keys, want = _reference_episodes(kind, n, trials, explicit)
    jcfg, tcfg = flaky_cfgs()
    draws = ArrayDraws(**reference_chaos_draws(keys, jcfg, n), device="cpu")
    if kind == "kube":
        select = tsched.make_kube_selector(tcfg)
    else:
        select = tsched.make_sdqn_selector(convert.qnet_from_numpy(
            _np(jdqn.init_qnet(jax.random.PRNGKey(0))), "cpu"), tcfg)
    got = tenv.run_episode(draws, tcfg, select, n, device="cpu",
                           failure_trace=(_explicit_trace(tcfg.n_nodes)[1]
                                          if explicit else None))
    _same_episode(got, want)
    ev = got.stats.evicted
    assert int(ev.sum()) > 0 and int(got.stats.rescheduled.sum()) > 0
    assert torch.equal(ev, got.stats.rescheduled + got.stats.lost)


def test_evicted_balances_rescheduled_plus_lost():
    """On a batch of clusters and the port's own draws, every cluster's
    ledger balances; a small ring loses what overflows it."""
    _, tcfg = flaky_cfgs()
    for cfg in (tcfg, dataclasses.replace(tcfg, chaos_requeue_cap=2)):
        res = tenv.run_episode(TorchDraws(torch.Generator().manual_seed(3),
                                          (6,)), cfg,
                               tsched.make_kube_selector(cfg), 40,
                               device="cpu")
        s = res.stats
        assert int(s.evicted.sum()) > 0
        assert torch.equal(s.evicted, s.rescheduled + s.lost)
        assert bool(torch.all((0 <= s.rescheduled) & (s.rescheduled
                                                      <= s.evicted)))
    assert int(s.lost.sum()) > 0
