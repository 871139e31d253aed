"""The PyTorch port's environment against ``repro.core.env``.

States are made by the reference from a seed and carried across through
numpy (JAX's threefry draws cannot be reproduced in PyTorch); features,
predicates and transitions must then agree to 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import env as jenv
from repro.core import types as jtypes
from repro_torch import convert
from repro_torch.core import env as tenv
from repro_torch.core import types as ttypes

TOL = dict(rtol=1e-6, atol=1e-6)


def _pair(n, seed, randomize=True, unhealthy=0.2):
    """(reference state, port state, reference cfg, port cfg)."""
    jcfg = dataclasses.replace(jtypes.fleet_cluster(n), unhealthy_prob=unhealthy,
                               randomize_workload=randomize)
    tcfg = dataclasses.replace(ttypes.fleet_cluster(n), unhealthy_prob=unhealthy,
                               randomize_workload=randomize)
    js = jenv.reset(jax.random.PRNGKey(seed), jcfg)
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    return js, ts, jcfg, tcfg


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **TOL)


CASES = [(4, 0, False), (37, 1, True), (300, 2, True), (1000, 3, True)]


@pytest.mark.parametrize("n,seed,randomize", CASES)
def test_features_match_reference(n, seed, randomize):
    js, ts, jcfg, tcfg = _pair(n, seed, randomize)
    got = tenv.features(ts, tcfg)
    assert got.dtype == torch.float32 and got.shape == (n, 6)
    _close(got, jenv.features(js, jcfg))
    _close(tenv.normalize_features(got),
           jenv.normalize_features(jenv.features(js, jcfg)))
    _close(tenv.cpu_pct(ts, tcfg), jenv.cpu_pct(js, jcfg))


@pytest.mark.parametrize("n,seed,randomize", CASES)
def test_hypothetical_place_matches_reference(n, seed, randomize):
    js, ts, jcfg, tcfg = _pair(n, seed, randomize)
    pod = jtypes.PodSpec(jnp.float32(300.0), jnp.float32(45.0),
                         jnp.float32(256.0), jnp.float32(180.0))
    got = tenv.hypothetical_place(ts, ttypes.PodSpec(300.0, 45.0, 256.0, 180.0),
                                  tcfg)
    _close(got, jenv.hypothetical_place(js, pod, jcfg))
    pinned = tenv.hypothetical_place(ts, tenv.default_pod(tcfg), tcfg,
                                     pull_cost=9000.0)
    _close(pinned, jenv.hypothetical_place(js, jenv.default_pod(jcfg), jcfg,
                                           pull_cost=jnp.float32(9000.0)))


def test_hypothetical_place_batches_pods():
    """Pod fields of shape (B, 1) give the (B, N, 6) stack of the rows."""
    _, ts, _, tcfg = _pair(50, 4)
    demands = [(140.0, 20.0, 128.0, 100.0), (500.0, 350.0, 1024.0, 900.0)]
    batch = ttypes.PodSpec(*(torch.tensor(c)[:, None] for c in zip(*demands)))
    got = tenv.hypothetical_place(ts, batch, tcfg)
    assert got.shape == (2, 50, 6)
    for b, d in enumerate(demands):
        torch.testing.assert_close(
            got[b], tenv.hypothetical_place(ts, ttypes.PodSpec(*d), tcfg),
            rtol=0, atol=0)


@pytest.mark.parametrize("n,seed,randomize", CASES)
def test_feasible_matches_reference(n, seed, randomize):
    js, ts, jcfg, tcfg = _pair(n, seed, randomize)
    for req in (140.0, 2000.0):
        jpod = jtypes.PodSpec(jnp.float32(req), jnp.float32(20.0),
                              jnp.float32(128.0), jnp.float32(100.0))
        got = tenv.feasible(ts, ttypes.PodSpec(req, 20.0, 128.0, 100.0), tcfg)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jenv.feasible(js, jpod, jcfg)))


@pytest.mark.parametrize("n,seed,randomize", CASES)
def test_pull_cost_matches_reference(n, seed, randomize):
    js, ts, jcfg, tcfg = _pair(n, seed, randomize)
    got = tenv.pull_cost_now(ts, tcfg)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == float(jenv.pull_cost_now(js, jcfg))


@pytest.mark.parametrize("which", ["drop", "first", "last", "cached",
                                   "uncached"])
def test_place_matches_reference(which):
    js, ts, jcfg, tcfg = _pair(64, 5)
    cached = np.flatnonzero(np.asarray(js.image_cached))
    cold = np.flatnonzero(~np.asarray(js.image_cached))
    action = {"drop": -1, "first": 0, "last": 63, "cached": int(cached[0]),
              "uncached": int(cold[0])}[which]
    got = tenv.place(ts, action, tenv.default_pod(tcfg), tcfg)
    want = jenv.place(js, jnp.int32(action), jenv.default_pod(jcfg), jcfg)
    for f, g, w in zip(ttypes.ClusterState._fields, got, want):
        assert g.dtype == getattr(ts, f).dtype, f
        _close(g, w)
    if which == "drop":
        assert got is ts                  # the sentinel binds nothing


def test_place_twice_accumulates_and_rejects_out_of_range():
    js, ts, jcfg, tcfg = _pair(16, 6)
    pod_t, pod_j = tenv.default_pod(tcfg), jenv.default_pod(jcfg)
    t2 = tenv.place(tenv.place(ts, 3, pod_t, tcfg), torch.tensor(3), pod_t, tcfg)
    j2 = jenv.place(jenv.place(js, 3, pod_j, jcfg), 3, pod_j, jcfg)
    for g, w in zip(t2, j2):
        _close(g, w)
    with pytest.raises(IndexError):
        tenv.place(ts, 16, pod_t, tcfg)


@pytest.mark.parametrize("randomize", [False, True])
@pytest.mark.parametrize("n", [4, 5, 1000])
def test_reset_contract(n, randomize):
    """The port's own draws: dtypes, shapes, ranges and determinism."""
    cfg = dataclasses.replace(ttypes.fleet_cluster(n), unhealthy_prob=0.3,
                              randomize_workload=randomize)
    s = tenv.reset(torch.Generator().manual_seed(7), cfg, device="cpu")
    again = tenv.reset(torch.Generator().manual_seed(7), cfg, device="cpu")
    ref = jenv.reset(jax.random.PRNGKey(7), dataclasses.replace(
        jtypes.fleet_cluster(n), unhealthy_prob=0.3,
        randomize_workload=randomize))
    for f, x, y, r in zip(ttypes.ClusterState._fields, s, again, ref):
        assert x.dtype == {np.dtype("float32"): torch.float32,
                           np.dtype("int32"): torch.int32,
                           np.dtype("bool"): torch.bool}[np.asarray(r).dtype], f
        assert tuple(x.shape) == np.asarray(r).shape, f
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert bool(torch.all((s.uptime_hours >= 1.0) & (s.uptime_hours < 200.0)))
    assert bool(torch.all(s.base_cpu >= 0.0))
    assert bool(torch.all(s.cpu_requested <= 0.98 * s.cpu_capacity))
    assert bool(torch.all(s.num_pods <= s.max_pods))
    assert bool(torch.all(s.exp_pods <= cfg.randomize_max_pods))
    if randomize:
        assert bool(torch.all(s.image_cached[s.exp_pods > 0]))
        assert bool(torch.all(s.startup_cpu < 0.3 * cfg.image_pull_cost))
    else:
        assert int(s.exp_pods.sum()) == 0 and not bool(s.image_cached.any())
    # cluster totals track the profile like the reference's (stable sums)
    if n >= 1000:
        assert float(s.base_cpu.mean()) == pytest.approx(
            float(np.mean(ref.base_cpu)), rel=0.02)


def test_configs_match_reference():
    for name in ("paper_cluster", "training_cluster"):
        assert (dataclasses.asdict(getattr(ttypes, name)())
                == dataclasses.asdict(getattr(jtypes, name)()))
    assert (dataclasses.asdict(ttypes.fleet_cluster(5000))
            == dataclasses.asdict(jtypes.fleet_cluster(5000)))
    assert ttypes.NO_PLACEMENT == jtypes.NO_PLACEMENT
    assert ttypes.FEATURE_DIM == jtypes.FEATURE_DIM
    np.testing.assert_array_equal(tenv.FEATURE_SCALE.numpy(),
                                  np.asarray(jenv.FEATURE_SCALE))


def test_scenarios_are_not_ported_yet():
    """Scenario pools are ported: a scenario EnvConfig equals the
    reference's field for field and resets to its pool.  The scenarios
    whose nodes fail mid-episode (chaos) run too: their failure traces
    sample the reference's windows from the same exponentials, and an
    episode evicts, re-places and loses pods with the ledger balanced
    (episode parity: tests/test_torch_chaos.py)."""
    from repro import scenarios as jscn
    from repro_torch import scenarios as tscn
    from repro_torch.core import schedulers as tsched
    from repro_torch.core.draws import TorchDraws

    tcfg = ttypes.scenario_env(tscn.get_scenario("hetero-bigsmall"))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(
        jtypes.scenario_env(jscn.get_scenario("hetero-bigsmall")))
    state = tenv.reset(torch.Generator().manual_seed(0), tcfg, device="cpu")
    np.testing.assert_array_equal(state.cpu_capacity.numpy(),
                                  [16000.0] * 2 + [2000.0] * 6)
    chaos = tscn.make_env("preemptible-flaky")
    jchaos = jscn.make_env("preemptible-flaky")
    e = np.random.default_rng(0).exponential(
        size=(chaos.chaos_cycles, 2, chaos.n_nodes)).astype(np.float32)
    got = tenv.sample_failure_trace(chaos, torch.tensor(e), "cpu")
    mtbf = jenv._scenario_pool(jchaos.scenario)["mtbf"]
    mttr = jenv._scenario_pool(jchaos.scenario)["mttr"]
    prev = np.zeros(chaos.n_nodes, np.float32)
    for c in range(chaos.chaos_cycles):
        f = prev + mtbf * np.maximum(e[c, 0], np.float32(1e-6))
        r = f + mttr * np.maximum(e[c, 1], np.float32(1e-6))
        np.testing.assert_array_equal(got.fail_s[c].numpy(), f)
        np.testing.assert_array_equal(got.recover_s[c].numpy(), r)
        prev = r
    res = tenv.run_episode(TorchDraws(torch.Generator().manual_seed(1), (4,)),
                           chaos, tsched.make_kube_selector(chaos), 60,
                           device="cpu")
    s = res.stats
    assert int(s.evicted.sum()) > 0
    assert torch.equal(s.evicted, s.rescheduled + s.lost)


def test_pods_and_table_match_reference():
    jcfg, tcfg = jtypes.fleet_cluster(8), ttypes.fleet_cluster(8)
    assert tuple(tenv.default_pod(tcfg)) == tuple(
        float(x) for x in jenv.default_pod(jcfg))
    assert tuple(tenv.mean_pod(tcfg)) == tuple(
        float(x) for x in jenv.mean_pod(jcfg))
    table = tenv.sample_pod_table(torch.Generator(), tcfg, 20, device="cpu")
    ref = jenv.sample_pod_table(jax.random.PRNGKey(0), jcfg, 20)
    for got, want in zip(list(table.specs) + list(table[1:]),
                         list(ref.specs) + list(ref[1:])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.numpy().dtype == np.asarray(want).dtype


def test_convert_keeps_the_port_dtypes():
    js = jenv.reset(jax.random.PRNGKey(0), jtypes.fleet_cluster(10))
    cols = {f: np.asarray(x).astype(np.float64)
            for f, x in zip(jtypes.ClusterState._fields, js)}
    ts = convert.state_from_numpy(cols, device="cpu")
    assert ts.max_pods.dtype == torch.int32
    assert ts.healthy.dtype == torch.bool
    assert ts.base_cpu.dtype == torch.float32
    pods = convert.pods_from_numpy([1.0, 2.0], [3.0, 4.0], [5.0, 6.0],
                                   [7.0, 8.0], device="cpu")
    assert all(p.dtype == torch.float32 and p.shape == (2,) for p in pods)
