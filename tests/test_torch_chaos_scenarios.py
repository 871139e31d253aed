"""The registered chaos scenarios (``preemptible-flaky``, ``batch-flaky``,
``train-flaky``) on the port against the JAX reference: batched trials
under kube and SDQN on the reference's own draws and failure traces
(``reference_chaos_draws``): pod distributions, drops and the
``evicted`` / ``rescheduled`` / ``lost`` counts identical, the metric
within 1e-5 relative.  (Training on them: tests/test_torch_chaos_train.py.)
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro import scenarios as jscn
from repro.core import dqn as jdqn, env as jenv, schedulers as jsched
from repro.eval import engine as jeval
from repro_torch import convert, scenarios as tscn
from repro_torch.core import presets as tpresets, schedulers as tsched
from repro_torch.core.draws import ArrayDraws
from repro_torch.eval import engine as teval
from test_torch_chaos import reference_chaos_draws
from torch_parity import _np


@functools.lru_cache(maxsize=None)
def _reference(name, kind, trials):
    cfg = jscn.make_env(name)
    if kind == "kube":
        select = jsched.make_kube_selector(cfg)
    else:
        select = jsched.make_sdqn_selector(jdqn.init_qnet(
            jax.random.PRNGKey(4)), cfg)
    keys = jeval.fixed_trial_keys(100, trials)
    n = cfg.scenario.n_pods

    @jax.jit
    def run(ks):
        return jax.vmap(lambda k: jenv.run_episode(k, cfg, select, n))(ks)

    return keys, _np(run(keys))


@pytest.mark.parametrize("kind", ["kube", "sdqn"])
@pytest.mark.parametrize("name", tpresets.CHAOS_MIX_NAMES)
def test_flaky_scenario_matches_reference(name, kind):
    trials = 3
    keys, want = _reference(name, kind, trials)
    jcfg, tcfg = jscn.make_env(name), tscn.make_env(name)
    n = jcfg.scenario.n_pods
    draws = ArrayDraws(**reference_chaos_draws(keys, jcfg, n), device="cpu")
    if kind == "kube":
        select = tsched.make_kube_selector(tcfg)
    else:
        select = tsched.make_sdqn_selector(convert.qnet_from_numpy(
            _np(jdqn.init_qnet(jax.random.PRNGKey(4))), "cpu"), tcfg)
    got = teval.make_batch_episode(tcfg, select, device="cpu")(draws)
    for f, w in (("distribution", want.placements),
                 ("exp_pods", want.state.exp_pods)):
        np.testing.assert_array_equal(getattr(got, f).numpy(), w, err_msg=f)
    _same_trials(got, want)
    assert torch.equal(got.evicted, got.rescheduled + got.lost)


def _same_trials(got, want):
    assert got.dropped.tolist() == want.dropped.tolist()
    for f in ("evicted", "rescheduled", "lost", "retired"):
        assert getattr(got, f).tolist() == getattr(want.stats, f).tolist(), f
    np.testing.assert_allclose(got.metric.numpy(), want.metric, rtol=1e-5)
    np.testing.assert_allclose(got.node_seconds.numpy(),
                               want.stats.node_seconds, rtol=1e-5)


def test_flaky_scenarios_evict():
    """Across the three scenarios the reference's trials above evict,
    and the summary carries the chaos counts."""
    total = 0
    for name in tpresets.CHAOS_MIX_NAMES:
        _, want = _reference(name, "kube", 3)
        total += int(want.stats.evicted.sum())
    assert total > 0
    out = teval.summarize(teval.TrialResults(
        *(torch.ones(2) for _ in teval.TrialResults._fields)))
    assert {"evicted_mean", "rescheduled_mean", "lost_mean"} <= set(out)
