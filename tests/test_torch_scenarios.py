"""The port's scenario pools (``repro_torch.scenarios``, the scenario arms
of ``core.env``) against the JAX reference.

The catalog and registry are compared field by field.  Resets and pod
tables are compared on the reference's own draws: ``reference_reset_units``
and ``reference_table_units`` rebuild the unit draws ``repro/core/env.py``
takes from a key (``reset``: ``split(key, 4)``, ``fold_in(key, 11)``,
``fold_in(key, 7)``; ``sample_pod_table``: ``split(key)``, ``fold_in(key,
3)``), the port's ``scenario_reset`` / ``scenario_pod_table`` build from
them, and the results must equal the reference's within 1e-6.  Episodes
run the kube scheduler on the reference's resets, pod tables and
tie-break rows (``reference_trial_draws``): identical distributions and
drops, metrics within 1e-5 relative.  The port's own draws
(``TorchDraws``) are held in distribution, with the bounds the reference's
``tests/test_scenarios.py`` and ``tests/test_lifecycle.py`` use.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import scenarios as jscn
from repro.core import env as jenv, schedulers as jsched, types as jtypes
from repro.eval import engine as jeval
from repro_torch import scenarios as tscn
from repro_torch.core import env as tenv, schedulers as tsched
from repro_torch.core import types as ttypes
from repro_torch.core.draws import ArrayDraws
from repro_torch.eval import engine as teval
from torch_parity import reference_trial_draws

TOL = dict(rtol=1e-6, atol=1e-6)
# every scenario up to one 4,096-node cluster (the larger cluster-of-
# clusters pools only repeat its classes)
NAMES = [n for n in jscn.scenario_names()
         if jscn.get_scenario(n).n_nodes <= 4096]


def _asdict(x):
    return dataclasses.asdict(x)


def test_catalog_and_registry_match_reference():
    assert tscn.scenario_names() == jscn.scenario_names()
    assert tscn.SCORING_ONLY == jscn.SCORING_ONLY
    for name in jscn.scenario_names():
        assert _asdict(tscn.get_scenario(name)) == _asdict(
            jscn.get_scenario(name)), name
        for randomize in (False, True):
            assert _asdict(tscn.make_env(name, randomize=randomize)) == \
                _asdict(jscn.make_env(name, randomize=randomize)), name
    assert {k: _asdict(v) for k, v in tscn.NODE_CLASSES.items()} == {
        k: _asdict(v) for k, v in jscn.NODE_CLASSES.items()}
    assert {k: _asdict(v) for k, v in tscn.POD_TYPES.items()} == {
        k: _asdict(v) for k, v in jscn.POD_TYPES.items()}
    assert [_asdict(c) for c in tscn.training_mixture()] == [
        _asdict(c) for c in jscn.training_mixture()]
    with pytest.raises(KeyError, match="unknown scenario"):
        tscn.get_scenario("nope")
    # a scenario config hashes: train_mixture keys its segments by it
    assert len({tscn.make_env(n) for n in NAMES}) == len(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_pool_watts_and_mean_pod_match_reference(name):
    tcfg, jcfg = tscn.make_env(name), jscn.make_env(name)
    tpool, jpool = tenv._scenario_pool(tcfg.scenario), jenv._scenario_pool(
        jcfg.scenario)
    assert list(tpool) == list(jpool)
    for k in jpool:
        np.testing.assert_array_equal(tpool[k], jpool[k], err_msg=k)
        assert tpool[k].dtype == jpool[k].dtype, k
    for got, want in zip(tenv.node_watts(tcfg, device="cpu"),
                         jenv.node_watts(jcfg)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tuple(tenv.mean_pod(tcfg)) == tuple(
        float(x) for x in jenv.mean_pod(jcfg))
    assert tenv.has_lifecycle(tcfg) == jenv.has_lifecycle(jcfg)
    assert tenv.has_chaos(tcfg) == jenv.has_chaos(jcfg)


def reference_reset_units(key, cfg):
    """The unit draws of ``repro.core.env.reset(key, cfg)``'s scenario arm,
    as ``env.reset_draws`` names them."""
    n = cfg.n_nodes
    k1, k2, k3, k4 = jax.random.split(key, 4)
    u = dict(uptime=jax.random.uniform(k2, (n,)),
             base=jax.random.uniform(k1, (n,)),
             healthy=jax.random.uniform(k3, (n,)),
             requested=jax.random.uniform(k4, (n,)),
             cached=jax.random.uniform(jax.random.fold_in(key, 11), (n,)))
    if cfg.randomize_workload:
        kr = jax.random.split(jax.random.fold_in(key, 7), 4)
        u.update(pods=jax.random.randint(kr[0], (n,), 0,
                                         cfg.randomize_max_pods + 1),
                 empty=jax.random.uniform(kr[1], (n,)),
                 cached_r=jax.random.uniform(kr[2], (n,)),
                 startup=jax.random.uniform(kr[3], (n,)))
    return u


def reference_table_units(key, cfg, n_pods):
    """The draws of ``repro.core.env.sample_pod_table(key, cfg, n_pods)``,
    as ``env.pod_table_draws`` names them."""
    k_type, k_dt = jax.random.split(key)
    w = np.asarray([p.weight for p in cfg.scenario.pod_types], np.float32)
    return dict(type_idx=jax.random.categorical(k_type, np.log(w),
                                                shape=(n_pods,)),
                e=jax.random.exponential(k_dt, (n_pods,)),
                z=jax.random.normal(jax.random.fold_in(key, 3), (n_pods,)))


def _tensors(d):
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


def _same_state(got, want):
    for f, g, w in zip(jtypes.ClusterState._fields, got, want):
        w = np.asarray(w)
        if w.dtype.kind in "ib":
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
        else:
            np.testing.assert_allclose(g.numpy(), w, err_msg=f, **TOL)


# training resets (randomized) for every scenario; the evaluation resets,
# which skip only the mid-flight tail, for one pool of each kind
RESET_CASES = [(n, True) for n in NAMES] + [
    (n, False) for n in ("paper-burst", "hetero-bigsmall", "diurnal-serve")]


@pytest.mark.parametrize("name,randomize", RESET_CASES)
def test_reset_table_and_features_on_reference_draws(name, randomize):
    tcfg = tscn.make_env(name, randomize=randomize)
    jcfg = jscn.make_env(name, randomize=randomize)
    n_pods = jcfg.scenario.n_pods

    @jax.jit
    def reference(key, k_table):
        """The reference's draws at once: one compilation a case (features
        run eagerly below: XLA's fusion moves them by ~1 ulp)."""
        return (jenv.reset(key, jcfg),
                jenv.sample_pod_table(k_table, jcfg, n_pods),
                reference_reset_units(key, jcfg),
                reference_table_units(k_table, jcfg, n_pods))

    js, jt, ru, tu = reference(jax.random.PRNGKey(7), jax.random.PRNGKey(8))
    jfeats = jenv.features(js, jcfg)
    jafter = jenv.hypothetical_place(
        js, jtypes.PodSpec(*(x[0] for x in jt.specs)), jcfg)
    ts = tenv.scenario_reset(tcfg, _tensors(ru), "cpu")
    _same_state(ts, js)
    tt = tenv.scenario_pod_table(tcfg, _tensors(tu), "cpu")
    np.testing.assert_array_equal(tt.type_idx.numpy(), np.asarray(jt.type_idx))
    for got, want in zip(list(tt.specs) + [tt.dt_s, tt.lifetime_s],
                         list(jt.specs) + [jt.dt_s, jt.lifetime_s]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tenv.features(ts, tcfg).numpy(),
                               np.asarray(jfeats), **TOL)
    pod_t = ttypes.PodSpec(*(float(x[0]) for x in jt.specs))
    np.testing.assert_allclose(
        tenv.hypothetical_place(ts, pod_t, tcfg).numpy(), np.asarray(jafter),
        **TOL)


@pytest.mark.parametrize("name,n_pods", [
    ("paper-burst", None), ("hetero-bigsmall", None), ("diurnal-serve", None),
    ("fleet-hetero", 200)])
def test_run_episode_on_reference_draws(name, n_pods):
    """kube on the reference's own resets, pod tables and tie-breaks:
    identical distributions and drops, metric and lifecycle integrals
    within 1e-5 relative."""
    jcfg, tcfg = jscn.make_env(name), tscn.make_env(name)
    n = n_pods or jcfg.scenario.n_pods
    keys = jeval.fixed_trial_keys(100, 2)
    want = jeval.make_batch_episode(jcfg, jsched.make_kube_selector(jcfg),
                                    n)(keys)
    draws = ArrayDraws(**reference_trial_draws(keys, jcfg, n), device="cpu")
    got = teval.make_batch_episode(tcfg, tsched.make_kube_selector(tcfg), n,
                                   device="cpu")(draws)
    np.testing.assert_array_equal(got.distribution.numpy(),
                                  np.asarray(want.distribution))
    np.testing.assert_array_equal(got.exp_pods.numpy(),
                                  np.asarray(want.exp_pods))
    assert got.dropped.tolist() == np.asarray(want.dropped).tolist()
    for f in ("metric", "nodes_active", "node_seconds", "energy_wh"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   err_msg=f)
    assert got.retired.tolist() == np.asarray(want.retired).tolist()


def _port_table(name, n_pods, seed):
    cfg = tscn.make_env(name)
    return cfg, tenv.sample_pod_table(torch.Generator().manual_seed(seed), cfg,
                                      n_pods, device="cpu")


def test_port_draws_mixture_weights():
    cfg, table = _port_table("train-serve-mix", 2000, 0)   # 30% train
    idx = table.type_idx.numpy()
    assert 0.2 < float(np.mean(idx == 0)) < 0.4
    req = table.specs.cpu_request.numpy()
    for i, p in enumerate(cfg.scenario.pod_types):
        assert np.all(req[idx == i] == p.cpu_request)


def test_port_draws_poisson_and_diurnal_gaps():
    cfg, table = _port_table("spot-flaky", 4000, 1)
    dt = table.dt_s.numpy()
    assert np.all(dt > 0)
    assert np.mean(dt) == pytest.approx(1.0 / cfg.scenario.arrival.rate_per_s,
                                        rel=0.1)
    _, table = _port_table("diurnal-serve", 2000, 1)
    dt = table.dt_s.numpy()
    assert np.all(dt > 0) and np.all(np.isfinite(dt))
    assert dt.max() / max(dt.min(), 1e-9) > 20.0
    _, table = _port_table("hetero-bigsmall", 32, 2)       # a burst
    assert np.all(table.dt_s.numpy() == 2.0)


def test_port_draws_lifetimes():
    _, table = _port_table("short-job-burst", 4000, 1)     # one 45 s type
    life = table.lifetime_s.numpy()
    assert np.all(np.isfinite(life)) and np.all(life > 0)
    assert np.mean(life) == pytest.approx(45.0, rel=0.1)
    _, table = _port_table("hetero-bigsmall", 32, 0)
    assert np.all(np.isinf(table.lifetime_s.numpy()))


def test_port_resets_stay_physical():
    """Randomized scenario resets: each node hosts only what its own
    memory and pod slots hold; bookings within capacity."""
    for name in ("hetero-bigsmall", "memory-pressure", "fleet-hetero"):
        cfg = tscn.make_env(name, randomize=True)
        st = tenv.reset(torch.Generator().manual_seed(3), cfg, device="cpu",
                        batch=(4,))
        assert bool(torch.all(st.num_pods <= st.max_pods))
        assert bool(torch.all(st.mem_used <= st.mem_capacity))
        assert bool(torch.all(st.cpu_requested <= st.cpu_capacity))
        assert st.cpu_capacity.shape == (4, cfg.n_nodes)


@pytest.mark.parametrize("name", ["preemptible-flaky", "batch-flaky",
                                  "train-flaky"])
def test_chaos_scenarios_still_raise(name):
    """Episodes and training on a scenario whose nodes fail mid-episode run:
    a short kube episode on the reference's draws and failure trace gives
    its distributions, drops and chaos counts, and the trainer runs on
    the scenario (without a failure trace, as the reference's)."""
    from repro_torch.core import train_rl as ttrain
    from repro_torch.core.draws import TorchDraws
    from test_torch_chaos import reference_chaos_draws

    jcfg, tcfg = jscn.make_env(name), tscn.make_env(name)
    n = 12
    keys = jeval.fixed_trial_keys(100, 2)
    select = jsched.make_kube_selector(jcfg)
    want = jax.jit(jax.vmap(lambda k: jenv.run_episode(k, jcfg, select, n)))(
        keys)
    draws = ArrayDraws(**reference_chaos_draws(keys, jcfg, n), device="cpu")
    got = tenv.run_episode(draws, tcfg, tsched.make_kube_selector(tcfg), n,
                           device="cpu")
    np.testing.assert_array_equal(got.placements.numpy(),
                                  np.asarray(want.placements))
    assert got.dropped.tolist() == np.asarray(want.dropped).tolist()
    for f in ("evicted", "rescheduled", "lost"):
        assert getattr(got.stats, f).tolist() == np.asarray(
            getattr(want.stats, f)).tolist(), f
    np.testing.assert_allclose(got.metric.numpy(), np.asarray(want.metric),
                               rtol=1e-5)
    rl = ttrain.RLConfig(episodes=1, pods_per_episode=4, n_envs=2,
                         batch_size=4, buffer_capacity=8)
    params, metrics = ttrain.train(
        TorchDraws(torch.Generator().manual_seed(0), (2,)),
        tscn.make_env(name, randomize=True), rl, device="cpu")
    assert bool(torch.isfinite(metrics["loss"]).all())
    assert all(bool(torch.isfinite(v).all()) for v in params.values())
