"""Training on the chaos scenarios: a short ``train_mixture`` over
``CHAOS_MIX_NAMES`` with ``SDQN_CHAOS_PRESET`` on the port against the JAX
reference, on the reference's own draws (``reference_mixture_draws``,
one ``ArrayDraws`` block a segment).  The trainer's episodes run without
a failure trace, as the reference's do (``repro/core/train_rl.py``
resets with none).  Actions identical (each greedy choice's two best Q
values more than 1e-5 apart, asserted), params within 1e-6, the trainer
tolerance of ``tests/test_train_engine.py``.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro import scenarios as jscn
from repro.core import presets as jpresets, train_rl as jtrain
from repro_torch import scenarios as tscn
from repro_torch.core import presets as tpresets, train_rl as ttrain
from repro_torch.core.draws import ArrayDraws, SegmentDraws
from test_torch_lifecycle import reference_mixture_draws
from test_torch_train import _close_trees, _record_port, _record_reference
from torch_parity import _np

TRAINER_TOL = 1e-6

CHAOS_CUT = dict(episodes=3, pods_per_episode=8, n_envs=2, batch_size=8,
                 buffer_capacity=32, target_update_every=7)
ROUNDS = 1


@functools.lru_cache(maxsize=None)
def _reference_chaos_mixture():
    mp = pytest.MonkeyPatch()
    try:
        seen = _record_reference(mp)
        rl = dataclasses.replace(jpresets.SDQN_CHAOS_PRESET, **CHAOS_CUT)
        cfgs = [jscn.make_env(n, randomize=True)
                for n in jpresets.CHAOS_MIX_NAMES]
        key = jax.random.PRNGKey(6)
        params, metrics = jtrain.train_mixture(key, cfgs, rl, rounds=ROUNDS)
        params = _np(params)
    finally:
        mp.undo()
    blocks, names = reference_mixture_draws(key, cfgs, rl, ROUNDS)
    actions = {names[k]: a for k, a in seen}
    return params, _np(metrics), actions, blocks


def test_train_mixture_on_chaos_scenarios_matches_reference(monkeypatch):
    """``train_mixture`` over the three flaky scenarios (4, 7 and 5 nodes,
    one segment each) with ``SDQN_CHAOS_PRESET`` cut to 3 episodes of 8
    pods on 2 clusters: the reference's actions, its params within 1e-6."""
    params, metrics, actions, blocks = _reference_chaos_mixture()
    trl = dataclasses.replace(tpresets.SDQN_CHAOS_PRESET, **CHAOS_CUT)
    cfgs = [tscn.make_env(n, randomize=True) for n in tpresets.CHAOS_MIX_NAMES]
    segments = ttrain.mixture_schedule(cfgs, trl.episodes, ROUNDS)
    assert [c.scenario.name for c, _, _ in segments] == list(
        tpresets.CHAOS_MIX_NAMES)
    seen = _record_port(monkeypatch)
    draws = SegmentDraws([(ep0, ArrayDraws(**d, device="cpu"))
                          for ep0, d in blocks])
    got, tm = ttrain.train_mixture(draws, cfgs, trl, rounds=ROUNDS,
                                   device="cpu")
    assert len(seen) == trl.episodes * trl.pods_per_episode
    for i, a in enumerate(seen):
        ep, t = divmod(i, trl.pods_per_episode)
        want = [actions[(ep, t, e)] for e in range(trl.n_envs)]
        assert a[0].tolist() == want, (ep, t)
    _close_trees(got, params, TRAINER_TOL)
    np.testing.assert_allclose(tm["avg_cpu"].numpy(), metrics["avg_cpu"],
                               rtol=1e-5)
