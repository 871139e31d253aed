"""The PyTorch port's scoring stack against the JAX reference.

The plain twin of the CUDA afterstate kernel is held to the reference's
Pallas kernel run in interpret mode (<=1e-5, the tolerance of
tests/test_kernels.py), over an explicit batch of pods; the Q-net, the
selectors and the public API are held to theirs.  Kernel tests on the card
carry the ``cuda`` marker and skip without one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dqn as jdqn, env as jenv, schedulers as jsched
from repro.core import types as jtypes
from repro.kernels import ops as jops, ref as jref
from repro.sched import api as japi
from repro_torch import convert
from repro_torch.core import dqn as tdqn, env as tenv, policy as tpolicy
from repro_torch.core import schedulers as tsched
from repro_torch.core import types as ttypes
from repro_torch.kernels import _build, ops as tops, ref as tref
from repro_torch.kernels import sdqn_score as tss
from repro_torch.sched import api as tapi

TOL = dict(rtol=1e-5, atol=1e-5)
# three pods of different demands: the batch axis of one kernel launch
DEMANDS = [(140.0, 20.0, 128.0, 100.0), (900.0, 600.0, 2048.0, 1500.0),
           (50.0, 5.0, 64.0, 32.0)]


def _setup(n, seed=5):
    """Reference state/params (unhealthy nodes, randomized workload) and
    their port copies on the CPU."""
    jcfg = dataclasses.replace(jtypes.fleet_cluster(n), unhealthy_prob=0.2,
                               randomize_workload=True)
    tcfg = dataclasses.replace(ttypes.fleet_cluster(n), unhealthy_prob=0.2,
                               randomize_workload=True)
    js = jenv.reset(jax.random.PRNGKey(seed), jcfg)
    jp = jdqn.init_qnet(jax.random.PRNGKey(seed + 1))
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    tp = convert.qnet_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return js, jp, jcfg, ts, tp, tcfg


def _jpods():
    return jtypes.PodSpec(*(jnp.asarray(c, jnp.float32) for c in zip(*DEMANDS)))


def _tpods():
    return convert.pods_from_numpy(*zip(*DEMANDS), device="cpu")


@pytest.mark.parametrize("n", [1, 37, 64, 100, 1000])
def test_plain_matches_reference_interpret(n):
    js, jp, jcfg, ts, tp, tcfg = _setup(n)
    want = jax.vmap(lambda p: jops.sdqn_score_afterstate(
        js, p, jcfg, jp, mode="interpret", block_n=64))(_jpods())
    got = tops.sdqn_score_afterstate(ts, _tpods(), tcfg, tp, mode="plain")
    assert got.shape == (len(DEMANDS), n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n", [1, 37, 1000])
def test_ref_mode_matches_plain_and_reference(n):
    js, jp, jcfg, ts, tp, tcfg = _setup(n)
    ref = tops.sdqn_score_afterstate(ts, _tpods(), tcfg, tp, mode="ref")
    plain = tops.sdqn_score_afterstate(ts, _tpods(), tcfg, tp)   # CPU: plain
    np.testing.assert_allclose(ref.numpy(), plain.numpy(), **TOL)
    want = jax.vmap(lambda p: jops.sdqn_score_afterstate(
        js, p, jcfg, jp, mode="ref"))(_jpods())
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), **TOL)


def test_pinned_pull_cost_reaches_the_scores():
    js, jp, jcfg, ts, tp, tcfg = _setup(200)
    pod = tenv.default_pod(tcfg)
    got = tops.sdqn_score_afterstate(ts, pod, tcfg, tp, pull_cost=12345.0)
    want = jops.sdqn_score_afterstate(js, jenv.default_pod(jcfg), jcfg, jp,
                                      mode="interpret", block_n=64,
                                      pull_cost=jnp.float32(12345.0))
    assert got.shape == (200,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrapper_on_cpu_runs_the_plain_version_without_counting():
    _, _, _, ts, tp, tcfg = _setup(100)
    inputs = tops._afterstate_inputs(ts, _tpods(), tcfg, tp)
    before = tss.sdqn_score_afterstate.launches
    got = tss.sdqn_score_afterstate(*inputs)
    assert tss.sdqn_score_afterstate.launches == before
    torch.testing.assert_close(got, tss.sdqn_score_afterstate_plain(*inputs),
                               rtol=0, atol=0)


def test_ops_rejects_bad_modes_and_params():
    _, _, _, ts, tp, tcfg = _setup(8)
    pod = tenv.default_pod(tcfg)
    with pytest.raises(ValueError, match="mode"):
        tops.sdqn_score_afterstate(ts, pod, tcfg, tp, mode="interpret")
    with pytest.raises(ValueError, match="CUDA"):
        tops.sdqn_score_afterstate(ts, pod, tcfg, tp, mode="cuda")
    wide = dict(tp, w1=torch.zeros(8, 32))
    with pytest.raises(ValueError, match="afterstate rows"):
        tops.sdqn_score_afterstate(ts, pod, tcfg, wide)


def test_wrapper_rejects_other_devices():
    cols = [torch.zeros(4, device="meta")] * 12
    with pytest.raises(ValueError, match="cuda or cpu"):
        tss.sdqn_score_afterstate(cols, None, None, None, None, None, None,
                                  None)


def test_build_paths_are_content_addressed():
    path = _build._lib_path(tss.KERNEL_SOURCE)
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libsdqn_score_afterstate-")
    assert path == _build._lib_path(tss.KERNEL_SOURCE)
    assert (_build.CSRC / f"{tss.KERNEL_SOURCE}.cu").exists()


@pytest.mark.parametrize("shape", [(1, 6), (37, 6), (3, 50, 6)])
def test_qnet_matches_reference(shape):
    jp = jdqn.init_qnet(jax.random.PRNGKey(3))
    tp = convert.qnet_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    feats = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = jdqn.qvalues(jp, jnp.asarray(feats))
    np.testing.assert_allclose(tdqn.qvalues(tp, torch.from_numpy(feats)).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tref.sdqn_score_ref(torch.from_numpy(feats), tp["w1"], tp["b1"],
                            tp["w2"], tp["b2"]).numpy(),
        np.asarray(jref.sdqn_score_ref(jnp.asarray(feats), jp["w1"], jp["b1"],
                                       jp["w2"], jp["b2"])),
        rtol=1e-6, atol=1e-6)


def test_init_qnet_layout_and_seeding():
    p = tdqn.init_qnet(torch.Generator().manual_seed(0), device="cpu")
    again = tdqn.init_qnet(torch.Generator().manual_seed(0), device="cpu")
    ref = jdqn.init_qnet(jax.random.PRNGKey(0))
    for k in ("w1", "b1", "w2", "b2"):
        assert tuple(p[k].shape) == ref[k].shape and p[k].dtype == torch.float32
        torch.testing.assert_close(p[k], again[k], rtol=0, atol=0)
    assert float(p["w1"].std()) == pytest.approx((2.0 / 6) ** 0.5, rel=0.35)


def test_masked_argmax_first_occurrence_and_sentinel():
    scores = torch.tensor([1.0, 3.0, 3.0, 2.0, 5.0])
    ok = torch.tensor([True, True, True, True, False])
    assert int(tsched.masked_argmax(None, scores, ok)) == 1
    none = tsched.masked_argmax(None, scores, torch.zeros(5, dtype=torch.bool))
    assert int(none) == ttypes.NO_PLACEMENT and none.dtype == torch.int32
    gen = torch.Generator().manual_seed(0)
    picks = {int(tsched.masked_argmax(gen, scores, ok, epsilon=1.0))
             for _ in range(50)}
    assert picks <= {0, 1, 2, 3} and len(picks) > 1     # explores, feasibly


@pytest.mark.parametrize("fused", ["auto", True, False, "plain"])
def test_score_afterstates_matches_reference(fused):
    js, jp, jcfg, ts, tp, tcfg = _setup(300)
    pod = ttypes.PodSpec(*DEMANDS[1])
    jpod = jtypes.PodSpec(*(jnp.float32(x) for x in DEMANDS[1]))
    want = jsched.score_afterstates(jp, js, jpod, jcfg, fused=False)
    got = tsched.score_afterstates(tp, ts, pod, tcfg, fused=fused)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    batch = tsched.score_afterstates_batch(tp, ts, _tpods(), tcfg, fused=fused)
    want_b = jsched.score_afterstates_batch(jp, js, _jpods(), jcfg, fused=False)
    np.testing.assert_allclose(batch.numpy(), np.asarray(want_b), **TOL)


def test_unported_scorers_raise():
    """A custom score_fn (the paper's LSTM baseline) scores as the
    reference's does, on the unfused path even at fleet scale; it cannot
    be forced onto the kernel or combined with a policy.  A policy that is
    not a registered PolicySpec is rejected, and so is a fused-only
    request for a class the kernels cannot score (registered classes are
    served: tests/test_torch_policy.py)."""
    from repro.core import baselines as jbase
    from repro_torch.core import baselines as tbase

    js, _, jcfg, ts, tp, tcfg = _setup(8)
    pod = tenv.default_pod(tcfg)
    jl = jbase.init_lstm(jax.random.PRNGKey(3))
    tl = convert.baseline_params_from_numpy(jax.tree.map(np.asarray, jl),
                                            "lstm", device="cpu")
    want = jsched.score_afterstates(jl, js, jenv.default_pod(jcfg), jcfg,
                                    score_fn=jbase.lstm_score)
    np.testing.assert_allclose(
        tsched.score_afterstates(tl, ts, pod, tcfg,
                                 score_fn=tbase.lstm_score).numpy(),
        np.asarray(want), **TOL)
    want_b = jsched.score_afterstates_batch(jl, js, _jpods(), jcfg,
                                            score_fn=jbase.lstm_score)
    np.testing.assert_allclose(
        tsched.score_afterstates_batch(tl, ts, _tpods(), tcfg,
                                       score_fn=tbase.lstm_score).numpy(),
        np.asarray(want_b), **TOL)
    with pytest.raises(ValueError, match="fused"):
        tsched.score_afterstates(tp, ts, pod, tcfg, score_fn=tdqn.qvalues,
                                 fused=True)
    with pytest.raises(ValueError, match="either"):
        tsched.score_afterstates(tp, ts, pod, tcfg, score_fn=tdqn.qvalues,
                                 policy=tpolicy.get("attention"))
    with pytest.raises(TypeError, match="PolicySpec"):
        tsched.score_afterstates(tp, ts, pod, tcfg, policy=object())
    attention = tpolicy.get("attention")
    with pytest.raises(ValueError, match="not registered"):
        tsched.score_afterstates(tp, ts, pod, tcfg,
                                 policy=dataclasses.replace(attention))
    with pytest.raises(ValueError, match="fused"):
        tsched.score_afterstates(tp, ts, pod, tcfg, policy=attention,
                                 fused=True)
    with pytest.raises(ValueError, match="fused"):
        tsched.score_afterstates(tp, ts, pod, tcfg, fused="interpret")
    assert tsched.FUSED_SCORE_MIN_NODES == jsched.FUSED_SCORE_MIN_NODES == 4096


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sdqn_selector_matches_reference(seed):
    js, jp, jcfg, ts, tp, tcfg = _setup(200, seed)
    jsel = jsched.make_sdqn_selector(jp, jcfg)
    tsel = tsched.make_sdqn_selector(tp, tcfg)
    for d in DEMANDS:
        jpod = jtypes.PodSpec(*(jnp.float32(x) for x in d))
        want = int(jsel(jax.random.PRNGKey(0), js, jpod))
        assert int(tsel(None, ts, ttypes.PodSpec(*d))) == want


def test_api_matches_reference():
    js, jp, jcfg, ts, tp, tcfg = _setup(300)
    for d in DEMANDS:
        jpod = jtypes.PodSpec(*(jnp.float32(x) for x in d))
        pod = ttypes.PodSpec(*d)
        np.testing.assert_allclose(
            tapi.heuristic_score(ts, pod, cfg=tcfg).numpy(),
            np.asarray(japi.heuristic_score(js, jpod, cfg=jcfg)), **TOL)
        np.testing.assert_allclose(
            tapi.score(ts, pod, params=tp, cfg=tcfg, guard=True).numpy(),
            np.asarray(japi.score(js, jpod, params=jp, cfg=jcfg, guard=True)),
            **TOL)
        assert int(tapi.select(ts, pod, params=tp, cfg=tcfg)) == int(
            japi.select(js, jpod, params=jp, cfg=jcfg))
    with pytest.raises(ValueError, match="cfg"):
        tapi.score(ts, pod, params=tp)
    with pytest.raises(TypeError):
        tapi.score(object(), pod, params=tp, cfg=tcfg)


def test_guard_swaps_diverged_scores_for_the_heuristic():
    _, _, _, ts, tp, tcfg = _setup(50)
    pod = tenv.default_pod(tcfg)
    for bad in (float("nan"), 1e9):
        hot = dict(tp, b2=torch.tensor([bad]))
        assert not bool(tapi.scores_valid(tapi.score(ts, pod, params=hot,
                                                     cfg=tcfg)))
        guarded = tapi.score(ts, pod, params=hot, cfg=tcfg, guard=True)
        torch.testing.assert_close(guarded,
                                   tapi.heuristic_score(ts, pod, cfg=tcfg))
    assert bool(tapi.scores_valid(tapi.score(ts, pod, params=tp, cfg=tcfg)))
    assert tapi.DIVERGENCE_LIMIT == japi.DIVERGENCE_LIMIT
