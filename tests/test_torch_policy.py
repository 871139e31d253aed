"""The port's policy registry (``repro_torch.core.policy``) and its scoring
arms against the JAX reference.

Params are made by the reference's ``init_*`` from a ``PRNGKey`` and carried
across with ``convert.policy_params_from_numpy``; states, pods and jobs are
made with numpy.  Policy outputs are held at 1e-5 (``tests/test_policy.py``'s
tolerance); selections must be identical where no two candidates lie within
1e-5 of each other (asserted first).  The reference's attention runs its
Pallas kernel in interpret mode or its XLA path; the port runs kernel 7's
plain version, as every wrapper does on CPU tensors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import env as jenv, policy as jpol, schedulers as jsched
from repro.core import types as jtypes
from repro.launch import mesh as jmesh
from repro.sched import api as japi, placement as jpl, shard as jshard
from repro_torch import convert
from repro_torch.core import env as tenv, policy as tpol, schedulers as tsched
from repro_torch.core import types as ttypes
from repro_torch.core.types import FEATURE_DIM
from repro_torch.launch.mesh import plan_fleet_layout
from repro_torch.sched import api as tapi, placement as tpl, shard as tshard
from torch_parity import fleet_np

TOL = dict(rtol=1e-5, atol=1e-5)
TIE_TOL = 1e-5
NAMES = ("mlp", "attention", "mamba")
N = 97          # 97 % 5 != 0: the last shard is padded with filler
SHARDS = 5
DEMANDS = [(140.0, 20.0, 128.0, 100.0), (900.0, 600.0, 2048.0, 1500.0),
           (50.0, 5.0, 64.0, 32.0)]


def _params(name, seed=2):
    """(reference spec, reference params, port spec, port params)."""
    jspec, tspec = jpol.get(name), tpol.get(name)
    jp = jspec.init(jax.random.PRNGKey(seed))
    tp = convert.policy_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jspec, jp, tspec, tp


def _cluster(n, seed=5):
    kw = dict(unhealthy_prob=0.2, randomize_workload=True)
    jcfg = dataclasses.replace(jtypes.fleet_cluster(n), **kw)
    tcfg = dataclasses.replace(ttypes.fleet_cluster(n), **kw)
    js = jenv.reset(jax.random.PRNGKey(seed), jcfg)
    ts = convert.state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    return js, jcfg, ts, tcfg


def _embeds(jspec, jp, demands):
    """One reference encoder step per pod from the initial carry: the
    (B, E) embeds (``None`` for stateless classes), both packages."""
    if not jspec.embed_dim:
        return None, None
    c = jspec.carry_init(jp)
    embs = [jspec.encode_step(jp, c, jpol.pod_workload_features(
        jtypes.PodSpec(*(jnp.float32(x) for x in d))))[1] for d in demands]
    jemb = jnp.stack(embs)
    return jemb, torch.tensor(np.asarray(jemb))


def _jpod(d):
    return jtypes.PodSpec(*(jnp.float32(x) for x in d))


def _assert_same_winner(got, want, scores, ok):
    """Identical selections, after asserting the two best feasible
    candidates are farther apart than the tie tolerance."""
    top = np.sort(np.asarray(scores)[np.asarray(ok)])[::-1][:2]
    assert top.size < 2 or top[0] - top[1] > TIE_TOL
    assert int(got) == int(want)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_registry_matches_reference():
    assert tpol.names() == jpol.names() == tuple(sorted(NAMES))
    for name in jpol.names():
        j, t = jpol.get(name), tpol.get(name)
        assert (t.feature_dim, t.embed_dim, t.fused_kernel, t.hyperparams) == (
            j.feature_dim, j.embed_dim, j.fused_kernel, j.hyperparams)
    assert tpol.ENCODER_IN == jpol.ENCODER_IN
    assert tpol._WORKLOAD_SCALE == jpol._WORKLOAD_SCALE
    for const in ("ATTN_DMODEL", "ATTN_HEADS", "MAMBA_DI", "MAMBA_STATE",
                  "MAMBA_DT_RANK", "MAMBA_EMBED", "MAMBA_HIDDEN"):
        assert getattr(tpol, const) == getattr(jpol, const), const
    with pytest.raises(KeyError, match="registered"):
        tpol.get("lstm")


@pytest.mark.parametrize("name", NAMES)
def test_init_matches_reference_shapes(name):
    """Same nesting, keys and shapes; the deterministic leaves (mamba's
    dt_bias, A_log, D and every zero bias) equal the reference's."""
    jp = jpol.get(name).init(jax.random.PRNGKey(0))
    tp = tpol.get(name).init(torch.Generator().manual_seed(0), device="cpu")
    jflat = dict(jax.tree_util.tree_leaves_with_path(jp))
    tflat = dict(jax.tree_util.tree_leaves_with_path(tp))
    assert {jax.tree_util.keystr(k) for k in jflat} == {
        jax.tree_util.keystr(k) for k in tflat}
    tleaf = {jax.tree_util.keystr(k): v for k, v in tflat.items()}
    for path, jx in jflat.items():
        key = jax.tree_util.keystr(path)
        tx = tleaf[key]
        assert tuple(tx.shape) == jx.shape and tx.dtype == torch.float32, key
        if any(s in key for s in ("dt_bias", "A_log", "'D'", "'b")):
            np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6,
                                       atol=1e-7, err_msg=key)
    again = tpol.get(name).init(torch.Generator().manual_seed(0),
                                device="cpu")
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(again)):
        assert torch.equal(a, b)                 # drawn from the generator


def test_checked_takes_only_registered_specs():
    spec = tpol.get("mamba")
    assert tpol.checked(None) is None and tpol.checked(spec) is spec
    with pytest.raises(TypeError, match="PolicySpec"):
        tpol.checked("mamba")
    with pytest.raises(ValueError, match="not registered"):
        tpol.checked(dataclasses.replace(spec))
    with pytest.raises(ValueError, match="encoder"):
        tpol.register(dataclasses.replace(spec, name="half",
                                          encode_sequence=None))
    assert "half" not in tpol.names()


def test_pod_workload_features_match_reference():
    cols = np.asarray(DEMANDS, np.float32).T
    want = jpol.pod_workload_features(jtypes.PodSpec(*map(jnp.asarray, cols)))
    got = tpol.pod_workload_features(ttypes.PodSpec(*map(torch.tensor, cols)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7)
    one = tpol.pod_workload_features(ttypes.PodSpec(*DEMANDS[0]))
    np.testing.assert_allclose(one.numpy(), np.asarray(want)[0], rtol=1e-7)


def test_policy_params_from_numpy_keeps_the_nesting():
    _, jp, _, tp = _params("mamba")
    assert set(tp) == {"enc", "head"} and set(tp["enc"]) == set(jp["enc"])
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# the classes' functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_qvalues_match_reference(name):
    jspec, jp, tspec, tp = _params(name)
    feats = np.random.default_rng(0).uniform(
        0.0, 1.5, (2, 37, jspec.feature_dim)).astype(np.float32)
    np.testing.assert_allclose(tspec.qvalues(tp, torch.tensor(feats)).numpy(),
                               np.asarray(jspec.qvalues(jp, feats)), **TOL)
    if name != "attention":     # pointwise: the set path IS the row path
        np.testing.assert_allclose(
            tspec.score_set(tp, torch.tensor(feats)).numpy(),
            np.asarray(jspec.qvalues(jp, feats)), **TOL)


def _sets(n, seed, b=2):
    return np.random.default_rng(seed).uniform(
        0.0, 1.5, (b, n, FEATURE_DIM)).astype(np.float32)


@pytest.mark.parametrize("n", [64, 256])
def test_attention_score_set_matches_pallas_interpret(n):
    _, jp, _, tp = _params("attention")
    sets = _sets(n, n)
    got = tpol.attention_score_set(tp, torch.tensor(sets))  # ONE (2, n) call
    for b in range(sets.shape[0]):
        want = jpol.attention_score_set(jp, sets[b], mode="interpret")
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n", [1, 37, 300])
def test_attention_score_set_matches_xla(n):
    _, jp, _, tp = _params("attention", seed=3)
    sets = _sets(n, n, b=3)
    got = tpol.attention_score_set(tp, torch.tensor(sets))
    for b in range(sets.shape[0]):
        np.testing.assert_allclose(
            got[b].numpy(), np.asarray(jpol.attention_score_set(jp, sets[b])),
            **TOL)
    for mode in ("plain", "ref"):
        np.testing.assert_allclose(
            tpol.attention_score_set(tp, torch.tensor(sets), mode=mode),
            got, **TOL)


def test_attention_singleton_sets_are_the_pointwise_path():
    _, _, _, tp = _params("attention")
    rows = torch.tensor(_sets(9, 0, b=1)[0])
    torch.testing.assert_close(
        tpol.attention_score_set(tp, rows[:, None, :])[:, 0],
        tpol.attention_qvalues(tp, rows), **TOL)


def _workloads(t, seed=7):
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (t, jpol.ENCODER_IN)).astype(np.float32)


def test_mamba_encode_step_fold_matches_reference():
    _, jp, _, tp = _params("mamba")
    w = _workloads(6)
    jc, tc = jpol.mamba_carry_init(jp), tpol.mamba_carry_init(tp)
    assert tuple(tc.shape) == jc.shape
    for i in range(len(w)):
        jc, je = jpol.mamba_encode_step(jp, jc, w[i])
        tc, te = tpol.mamba_encode_step(tp, tc, torch.tensor(w[i]))
        np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


@pytest.mark.parametrize("mode", [None, "ref"])
def test_mamba_encode_sequence_matches_reference(mode):
    """One launch over the run == the reference's step fold and its
    sequence re-encode (Pallas kernel in interpret mode), embeds AND final
    carry, from a carry that is not zero."""
    _, jp, _, tp = _params("mamba")
    w = _workloads(6)
    h0 = jpol.mamba_carry_init(jp)
    for x in _workloads(3, seed=1):
        h0, _ = jpol.mamba_encode_step(jp, h0, x)
    jc, stepped = h0, []
    for i in range(len(w)):
        jc, je = jpol.mamba_encode_step(jp, jc, w[i])
        stepped.append(je)
    embeds, h_final = tpol.mamba_encode_sequence(
        tp, torch.tensor(w), h0=torch.tensor(np.asarray(h0)), mode=mode)
    np.testing.assert_allclose(embeds.numpy(), np.asarray(stepped), **TOL)
    np.testing.assert_allclose(h_final.numpy(), np.asarray(jc), **TOL)
    je, jh = jpol.mamba_encode_sequence(jp, w, h0=h0, mode="interpret")
    np.testing.assert_allclose(embeds.numpy(), np.asarray(je), **TOL)
    np.testing.assert_allclose(h_final.numpy(), np.asarray(jh), **TOL)


def test_mamba_pad_rows_leave_the_carry():
    """Rows from ``n_real`` on take dt = 0: the carry after a padded run is
    the carry after its real rows, and the real rows' embeds are theirs."""
    _, _, _, tp = _params("mamba")
    w = torch.tensor(_workloads(8))
    h0 = torch.tensor(np.random.default_rng(3).normal(
        0, 0.1, (tpol.MAMBA_DI, tpol.MAMBA_STATE)).astype(np.float32))
    e_real, h_real = tpol.mamba_encode_sequence(tp, w[:5], h0=h0)
    e_pad, h_pad = tpol.mamba_encode_sequence(tp, w, h0=h0, n_real=5)
    torch.testing.assert_close(h_pad, h_real, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(e_pad[:5], e_real, rtol=1e-6, atol=1e-7)
    _, h_none = tpol.mamba_encode_sequence(tp, w, h0=h0, n_real=0)
    assert torch.equal(h_none, h0)


# ---------------------------------------------------------------------------
# scoring: schedulers, api, shard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("fused", ["auto", False, "plain"])
def test_score_afterstates_matches_reference(name, fused):
    js, jcfg, ts, tcfg = _cluster(300)
    jspec, jp, tspec, tp = _params(name)
    jemb, temb = _embeds(jspec, jp, DEMANDS)
    for i, d in enumerate(DEMANDS):
        want = jsched.score_afterstates(
            jp, js, _jpod(d), jcfg, policy=jspec,
            embed=None if jemb is None else jemb[i])
        got = tsched.score_afterstates(
            tp, ts, ttypes.PodSpec(*d), tcfg, fused=fused, policy=tspec,
            embed=None if temb is None else temb[i])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the whole batch in one call: (B, N), per-pod embeds for sequence specs
    batch = convert.pods_from_numpy(*zip(*DEMANDS), device="cpu")
    got = tsched.score_afterstates_batch(tp, ts, batch, tcfg, fused=fused,
                                         policy=tspec, embed=temb)
    for i, d in enumerate(DEMANDS):
        np.testing.assert_allclose(
            got[i].numpy(), np.asarray(jsched.score_afterstates(
                jp, js, _jpod(d), jcfg, policy=jspec,
                embed=None if jemb is None else jemb[i])), **TOL)


def test_sequence_policy_and_embed_go_together():
    _, _, ts, tcfg = _cluster(8)
    pod = tenv.default_pod(tcfg)
    _, _, mamba, mp = _params("mamba")
    _, _, attention, ap = _params("attention")
    with pytest.raises(ValueError, match="embed"):
        tsched.score_afterstates(mp, ts, pod, tcfg, policy=mamba)
    with pytest.raises(ValueError, match="embed"):
        tsched.score_afterstates(ap, ts, pod, tcfg, policy=attention,
                                 embed=torch.zeros(8))


@pytest.mark.parametrize("name", NAMES)
def test_api_matches_reference_on_a_cluster(name):
    js, jcfg, ts, tcfg = _cluster(300, seed=6)
    jspec, jp, tspec, tp = _params(name, seed=4)
    jemb, temb = _embeds(jspec, jp, DEMANDS)
    for i, d in enumerate(DEMANDS):
        jkw = dict(params=jp, cfg=jcfg, policy=jspec,
                   embed=None if jemb is None else jemb[i])
        tkw = dict(params=tp, cfg=tcfg, policy=tspec,
                   embed=None if temb is None else temb[i])
        jpod, tpod = _jpod(d), ttypes.PodSpec(*d)
        q = tapi.score(ts, tpod, **tkw)
        np.testing.assert_allclose(q.numpy(),
                                   np.asarray(japi.score(js, jpod, **jkw)),
                                   **TOL)
        ok = np.asarray(jenv.feasible(js, jpod, jcfg))
        # the reference's select takes no embed: its masked argmax here
        want_sel = jnp.argmax(jnp.where(ok, japi.score(js, jpod, **jkw),
                                        -jnp.inf))
        _assert_same_winner(tapi.select(ts, tpod, **tkw), want_sel,
                            q.numpy(), ok)
        vals, idx = tapi.topk(ts, tpod, k=4, **tkw)
        wv, wi = japi.topk(js, jpod, k=4, **jkw)
        np.testing.assert_allclose(vals.numpy(), np.asarray(wv), **TOL)
        assert np.all(np.diff(np.asarray(wv)) < -TIE_TOL)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    batch = convert.pods_from_numpy(*zip(*DEMANDS), device="cpu")
    got = tapi.score_batch(ts, batch, params=tp, cfg=tcfg, policy=tspec,
                           embed=temb)
    for i, d in enumerate(DEMANDS):
        np.testing.assert_allclose(
            got[i].numpy(), np.asarray(japi.score(
                js, _jpod(d), params=jp, cfg=jcfg, policy=jspec,
                embed=None if jemb is None else jemb[i])), **TOL)


def _jobs():
    rng = np.random.default_rng(9)
    return [(float(c), float(m)) for c, m in zip(rng.uniform(1, 10, 3),
                                                 rng.uniform(0.5, 5, 3))]


def _job_embeds(jspec, jp, jobs):
    """The FleetSubstrate encoder input: (delta / FEATURE_SCALE)[:4]."""
    if not jspec.embed_dim:
        return None, None
    c = jspec.carry_init(jp)
    embs = [jspec.encode_step(jp, c, (jpl.job_delta(jpl.JobSpec(*j))
                                      / jenv.FEATURE_SCALE)[:4])[1]
            for j in jobs]
    return jnp.stack(embs), torch.tensor(np.asarray(jnp.stack(embs)))


@pytest.mark.parametrize("name", NAMES)
def test_api_matches_reference_on_a_job_fleet(name):
    cols = fleet_np(300, seed=3)
    jf = jpl.FleetState(**{k: jnp.asarray(v) for k, v in cols.items()})
    tf = convert.fleet_from_numpy(cols, device="cpu")
    jspec, jp, tspec, tp = _params(name, seed=5)
    jobs = _jobs()
    jemb, temb = _job_embeds(jspec, jp, jobs)
    for i, j in enumerate(jobs):
        jkw = dict(params=jp, policy=jspec,
                   embed=None if jemb is None else jemb[i])
        tkw = dict(params=tp, policy=tspec,
                   embed=None if temb is None else temb[i])
        q = tapi.score(tf, tpl.JobSpec(*j), **tkw)
        want = japi.score(jf, jpl.JobSpec(*j), **jkw)
        np.testing.assert_allclose(q.numpy(), np.asarray(want), **TOL)
        ok = np.asarray(jpl.PlacementEngine(jp).feasible(jf, jpl.JobSpec(*j)))
        _assert_same_winner(tapi.select(tf, tpl.JobSpec(*j), **tkw),
                            jnp.argmax(jnp.where(ok, want, -jnp.inf)),
                            q.numpy(), ok)
        vals, idx = tapi.topk(tf, tpl.JobSpec(*j), k=4, **tkw)
        wv, wi = japi.topk(jf, jpl.JobSpec(*j), k=4, **jkw)
        np.testing.assert_allclose(vals.numpy(), np.asarray(wv), **TOL)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    got = tapi.score_batch(tf, [tpl.JobSpec(*j) for j in jobs], params=tp,
                           policy=tspec, embed=temb)
    for i, j in enumerate(jobs):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(japi.score(
            jf, jpl.JobSpec(*j), params=jp, policy=jspec,
            embed=None if jemb is None else jemb[i])), **TOL)


def test_guard_swaps_nan_policy_scores_for_the_heuristic():
    _, _, ts, tcfg = _cluster(50)
    _, _, spec, tp = _params("attention")
    bad = dict(tp, b_out=torch.tensor([float("nan")]))
    pod = tenv.default_pod(tcfg)
    guarded = tapi.score(ts, pod, params=bad, cfg=tcfg, policy=spec,
                         guard=True)
    torch.testing.assert_close(guarded, tapi.heuristic_score(ts, pod,
                                                             cfg=tcfg))


def _assert_candidates(got, want):
    """Port (vals, idx) vs the reference's two-stage candidates: values
    within the tolerance, -inf / -1 tails alike, and identical indices at
    every slot whose neighbours lie farther away than the tie tolerance —
    the winner's among them (asserted)."""
    vals, idx = (np.asarray(x) for x in got)
    wv, wi = (np.asarray(x) for x in want)
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(vals), fin)
    np.testing.assert_allclose(vals[fin], wv[fin], **TOL)
    assert np.all(idx[~fin] == -1)
    wf = wv[fin]
    gap = np.diff(wf) > -TIE_TOL                 # a near tie between i, i+1
    close = np.zeros(wf.shape, bool)
    close[1:] |= gap
    close[:-1] |= gap
    assert not close[0]
    np.testing.assert_array_equal(idx[fin][~close], wi[fin][~close])


@pytest.mark.parametrize("name", NAMES)
def test_sharded_cluster_arms_match_reference(name):
    """Shard-local ``score_set`` with the reference's padded last shard (its
    filler rows are keys of the block-local attention), infeasible nodes at
    -inf, per-shard top-k by the stable merge, then the shard merge."""
    js, jcfg, ts, tcfg = _cluster(N, seed=7)
    jspec, jp, tspec, tp = _params(name, seed=6)
    jemb, temb = _embeds(jspec, jp, DEMANDS)
    jlay, tlay = (jmesh.plan_fleet_layout(N, shards=SHARDS),
                  plan_fleet_layout(N, shards=SHARDS))
    batch = convert.pods_from_numpy(*zip(*DEMANDS), device="cpu")
    bv, bi = tshard.cluster_topk(tp, ts, batch, tcfg, tlay, k=3,
                                 policy=tspec, embed=temb)
    for i, d in enumerate(DEMANDS):
        jkw = dict(policy=jspec, embed=None if jemb is None else jemb[i])
        tkw = dict(policy=tspec, embed=None if temb is None else temb[i])
        want = jshard.cluster_topk(jp, js, _jpod(d), jcfg, jlay, k=3, **jkw)
        got = tshard.cluster_topk(tp, ts, ttypes.PodSpec(*d), tcfg, tlay,
                                  k=3, **tkw)
        _assert_candidates(got, want)
        _assert_candidates((bv[i], bi[i]), want)
        np.testing.assert_allclose(
            tapi.score(ts, ttypes.PodSpec(*d), params=tp, cfg=tcfg,
                       shard=tlay, **tkw).numpy(),
            np.asarray(japi.score(js, _jpod(d), params=jp, cfg=jcfg,
                                  shard=jlay, **jkw)), **TOL)
        assert int(tshard.select_candidates(
            ts, ttypes.PodSpec(*d), params=tp, cfg=tcfg, layout=tlay,
            **tkw)) == int(jshard.select_candidates(
                js, _jpod(d), params=jp, cfg=jcfg, layout=jlay, **jkw))


@pytest.mark.parametrize("name", NAMES)
def test_sharded_fleet_arms_match_reference(name):
    cols = fleet_np(N, seed=4)
    jf = jpl.FleetState(**{k: jnp.asarray(v) for k, v in cols.items()})
    tf = convert.fleet_from_numpy(cols, device="cpu")
    jspec, jp, tspec, tp = _params(name, seed=8)
    jobs = _jobs()
    jemb, temb = _job_embeds(jspec, jp, jobs)
    jlay, tlay = (jmesh.plan_fleet_layout(N, shards=SHARDS),
                  plan_fleet_layout(N, shards=SHARDS))
    for i, j in enumerate(jobs):
        jkw = dict(policy=jspec, embed=None if jemb is None else jemb[i])
        tkw = dict(policy=tspec, embed=None if temb is None else temb[i])
        want = jshard.fleet_topk(jp, jf, jpl.JobSpec(*j), jlay, k=3, **jkw)
        got = tshard.fleet_topk(tp, tf, tpl.JobSpec(*j), tlay, k=3, **tkw)
        _assert_candidates(got, want)
        np.testing.assert_allclose(
            tapi.score(tf, tpl.JobSpec(*j), params=tp, shard=tlay,
                       **tkw).numpy(),
            np.asarray(japi.score(jf, jpl.JobSpec(*j), params=jp, shard=jlay,
                                  **jkw)), **TOL)
