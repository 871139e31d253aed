"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

They skip where no CUDA device is visible.  This file imports no JAX, so it
also runs on a machine that has only PyTorch (``--noconftest`` skips
``tests/conftest.py``, which imports JAX):

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import dqn, env
from repro_torch.core.types import fleet_cluster
from repro_torch.kernels import mamba_scan as tms, ops, sdqn_score as ss
from repro_torch.sched import daemon
from test_torch_score_plan import BRANCHES, PLAN_SHAPES


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _one_call_kernels(call):
    """Names of the device kernels one call of ``call`` runs
    (``chip_smoke.device_kernels``: the kernel nodes of a CUDA graph of
    the call)."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from chip_smoke import device_kernels

    return device_kernels(call)


def _case(n, b, device, seed):
    cfg = dataclasses.replace(fleet_cluster(n), unhealthy_prob=0.2,
                              randomize_workload=True)
    gen = torch.Generator().manual_seed(seed)
    state = env.reset(gen, cfg, device=device)
    params = dqn.init_qnet(gen, device=device)
    rng = np.random.default_rng(seed)
    pods = convert.pods_from_numpy(*(rng.uniform(10, 900, b) for _ in range(4)),
                                   device=device)
    return cfg, state, params, pods


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 1000, 5000, 131072])
@pytest.mark.parametrize("b", [1, 32])
def test_kernel_matches_plain_on_card(cuda_device, n, b):
    cfg, state, params, pods = _case(n, b, cuda_device, n + b)
    before = ss.sdqn_score_afterstate.launches
    got = ops.sdqn_score_afterstate(state, pods, cfg, params, mode="cuda")
    torch.cuda.synchronize()
    assert ss.sdqn_score_afterstate.launches == before + 1
    want = ops.sdqn_score_afterstate(state, pods, cfg, params, mode="plain")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernel_propagates_nan_weights(cuda_device):
    """A diverged net must reach the daemon's NaN guard, not read as 0."""
    cfg, state, params, pods = _case(300, 4, cuda_device, 1)
    params = dict(params, b1=torch.full_like(params["b1"], float("nan")))
    q = ops.sdqn_score_afterstate(state, pods, cfg, params, mode="cuda")
    assert bool(torch.isnan(q).all())


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda_device):
    cfg, state, params, pods = _case(64, 2, cuda_device, 2)
    inputs = list(ops._afterstate_inputs(state, pods, cfg, params))
    cols = list(inputs[0])
    cols[3] = cols[3].to(torch.int64)                # num_pods must be int32
    with pytest.raises(ValueError, match="num_pods"):
        ss.sdqn_score_afterstate(cols, *inputs[1:])
    cols = list(inputs[0])
    cols[0] = torch.zeros(128, device=cuda_device)[::2]   # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        ss.sdqn_score_afterstate(cols, *inputs[1:])


@pytest.mark.cuda
def test_daemon_batch_is_one_kernel_launch(cuda_device):
    cfg = fleet_cluster(5000)
    gen = torch.Generator().manual_seed(0)
    d = daemon.PlacementDaemon(
        daemon.ClusterSubstrate(env.reset(gen, cfg, device=cuda_device), cfg,
                                device=cuda_device),
        dqn.init_qnet(gen, device=cuda_device),
        daemon.DaemonConfig(batch_size=32, max_wait_s=1e9))
    d.warmup()
    before = ss.sdqn_score_afterstate.launches
    for _ in range(70):
        d.submit(env.default_pod(cfg))
    d.drain()
    m = d.metrics
    # identical pods collide on one node and re-queue, so batches > 3
    assert m.bound + m.dropped == m.submitted == 70
    assert m.device_launches == m.batches >= 3
    assert ss.sdqn_score_afterstate.launches - before == m.device_launches


# ---------------------------------------------------------------------------
# kernels 2-5 and the sharded / job->host serving paths
# ---------------------------------------------------------------------------


def _fleet(n, device, seed):
    """A job fleet with infeasible hosts (unhealthy, near the ceilings)."""
    from repro_torch.sched import placement as pl

    rng = np.random.default_rng(seed)
    jobs = rng.integers(0, 26, n)
    return convert.fleet_from_numpy(dict(
        cpu_pct=rng.uniform(2, 92, n), mem_pct=rng.uniform(2, 96, n),
        job_util_pct=jobs * pl.JOB_UTIL_DELTA_PCT,
        healthy=(rng.random(n) > 0.15).astype(np.float32),
        uptime_hours=rng.uniform(1, 200, n), num_jobs=jobs), device=device)


def _deltas(b, device, seed):
    from repro_torch.sched import placement as pl

    rng = np.random.default_rng(seed)
    return pl.job_deltas([pl.JobSpec(c, m) for c, m in
                          zip(rng.uniform(1, 10, b), rng.uniform(0.5, 5, b))],
                         device)


def _same_candidates(got, want, tol=1e-5):
    """Finite values within ``tol``; indices equal wherever neighbouring
    candidate values differ by more than it; identical -inf / -1 tails."""
    (gv, gi), (wv, wi) = ((v.cpu().numpy(), i.cpu().numpy()) for v, i in
                          (got, want))
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), fin)
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=tol, atol=tol)
    np.testing.assert_array_equal(gi[~fin], wi[~fin])
    close = np.zeros_like(fin)
    gap = np.abs(np.diff(wv, axis=-1)) <= tol
    close[..., 1:] |= gap
    close[..., :-1] |= gap
    np.testing.assert_array_equal(gi[fin & ~close], wi[fin & ~close])


def _both_topk(state, pods, cfg, params, fleet, deltas, k, lay, mode=None):
    """Kernel 4's and kernel 5's candidates (through ``ops``), and the
    launches each made."""
    from repro_torch.sched import placement as pl

    before = (ss.sdqn_score_afterstate_topk.launches,
              ss.sdqn_score_cols_topk.launches)
    out = (ops.sdqn_topk_afterstate(state, pods, cfg, params, k=k, layout=lay,
                                    mode=mode),
           ops.sdqn_topk_delta(pl.fleet_cols(fleet), deltas, params, k=k,
                               layout=lay, mode=mode))
    return out, (ss.sdqn_score_afterstate_topk.launches - before[0],
                 ss.sdqn_score_cols_topk.launches - before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 1000, 131072])
@pytest.mark.parametrize("shards", [1, 8])
@pytest.mark.parametrize("b", [1, 5, 32])
def test_topk_kernels_match_plain_on_card(cuda_device, n, shards, b):
    from repro_torch.launch.mesh import plan_fleet_layout

    cfg, state, params, pods = _case(n, b, cuda_device, n + shards + b)
    lay = plan_fleet_layout(n, shards=shards)
    size = n if lay is None else lay.shard_size
    fleet = _fleet(n, cuda_device, n + b)
    deltas = _deltas(b, cuda_device, n + b)
    for k in (1, 4, 8):
        k = min(k, size)
        got, launches = _both_topk(state, pods, cfg, params, fleet, deltas, k,
                                   lay)
        assert launches == (1, 1)
        want, _ = _both_topk(state, pods, cfg, params, fleet, deltas, k, lay,
                             mode="plain")
        for g, w in zip(got, want):
            _same_candidates(g, w)


def _constant_case(n, b, device):
    """Every node (host) alike, every pod (job) alike: all scores tie."""
    cfg, state, params, _ = _case(n, b, device, 11)
    state = type(state)(*(x[:1].expand_as(x).contiguous() if x.dim() == 1
                          else x for x in state))
    state = state._replace(healthy=torch.ones_like(state.healthy))
    pods = convert.pods_from_numpy(*(np.full(b, v) for v in
                                     (100.0, 64.0, 100.0, 64.0)),
                                   device=device)
    fleet = convert.fleet_from_numpy(dict(
        cpu_pct=np.full(n, 30.0), mem_pct=np.full(n, 40.0),
        job_util_pct=np.full(n, 12.0), healthy=np.ones(n, np.float32),
        uptime_hours=np.full(n, 50.0), num_jobs=np.full(n, 3)), device=device)
    deltas = _deltas(1, device, 0).expand(b, 6).contiguous()
    return cfg, state, params, pods, fleet, deltas


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 32])
def test_topk_kernels_break_all_ties_to_the_lowest_index(cuda_device, b):
    """All scores equal: each shard's winners are its k lowest indices."""
    from repro_torch.launch.mesh import plan_fleet_layout

    n = 131072
    cfg, state, params, pods, fleet, deltas = _constant_case(n, b,
                                                             cuda_device)
    lay = plan_fleet_layout(n, shards=8)
    got, _ = _both_topk(state, pods, cfg, params, fleet, deltas, 8, lay)
    want = (torch.arange(8, dtype=torch.int32, device=cuda_device)[None]
            + torch.arange(0, n, lay.shard_size, dtype=torch.int32,
                           device=cuda_device)[:, None])
    for (v, i), (pv, pi) in zip(got, _both_topk(
            state, pods, cfg, params, fleet, deltas, 8, lay,
            mode="plain")[0]):
        assert bool(torch.isfinite(v).all())
        assert bool((v == v[..., :1]).all())
        assert torch.equal(i, want.expand_as(i)) and torch.equal(i, pi)
        torch.testing.assert_close(v, pv, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_topk_kernels_write_an_empty_shard_as_no_candidates(cuda_device):
    """3 shards of 500 over N = 1000: the last covers no node."""
    from repro_torch.launch.mesh import FleetLayout

    n, b = 1000, 5
    cfg, state, params, pods = _case(n, b, cuda_device, 4)
    lay = FleetLayout(shards=3, shard_size=500, n_nodes=n)
    fleet = _fleet(n, cuda_device, 4)
    deltas = _deltas(b, cuda_device, 4)
    got, _ = _both_topk(state, pods, cfg, params, fleet, deltas, 8, lay)
    want, _ = _both_topk(state, pods, cfg, params, fleet, deltas, 8, lay,
                         mode="plain")
    for (v, i), w in zip(got, want):
        assert bool((v[:, 2] == -torch.inf).all())
        assert bool((i[:, 2] == -1).all())
        assert bool(torch.isfinite(v[:, :2]).all())
        _same_candidates((v, i), w)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 5, 32])
def test_topk_values_are_the_scoring_kernels_scores_bit_for_bit(cuda_device,
                                                                 b):
    """Kernel 4's candidates carry kernel 1's scores of the same (pod,
    node) exactly, kernel 5's kernel 3's: the same order of operations,
    whichever branch of ``score_plan`` kernels 1 and 3 took."""
    from repro_torch.launch.mesh import plan_fleet_layout
    from repro_torch.sched import placement as pl

    n = 131072
    cfg, state, params, pods = _case(n, b, cuda_device, 9)
    lay = plan_fleet_layout(n, shards=8)
    fleet = _fleet(n, cuda_device, 9)
    deltas = _deltas(b, cuda_device, 9)
    (av, ai), (cv, ci) = _both_topk(state, pods, cfg, params, fleet, deltas,
                                    8, lay)[0]
    scores = (ops.sdqn_score_afterstate(state, pods, cfg, params),
              ops.sdqn_score_delta(pl.fleet_cols(fleet), deltas, params))
    for v, i, q in ((av, ai, scores[0]), (cv, ci, scores[1])):
        real = i >= 0
        assert int(real.sum()) > b * 8 * 4
        at = torch.gather(q, 1, i.clamp(min=0).flatten(1)).view_as(v)
        assert torch.equal(v[real], at[real])


@pytest.mark.cuda
def test_topk_wrapper_call_is_one_device_kernel(cuda_device):
    """No sort, gather or copy runs beside the kernel: one wrapper call
    runs exactly one device kernel."""
    from repro_torch.launch.mesh import plan_fleet_layout
    from repro_torch.sched import placement as pl

    n, b = 131072, 32
    cfg, state, params, pods = _case(n, b, cuda_device, 10)
    lay = plan_fleet_layout(n, shards=8)
    fleet = _fleet(n, cuda_device, 10)
    deltas = _deltas(b, cuda_device, 10)
    a_in = ops._afterstate_inputs(state, pods, cfg, params)
    t_cols = a_in[0] + (state.cpu_requested, state.mem_requested)
    creq = ops._pod_column(pods.cpu_request, cuda_device)
    mreq = ops._pod_column(pods.mem_request, cuda_device)
    cols = pl.fleet_cols(fleet)
    geo = dict(k=8, shards=lay.shards, shard_size=lay.shard_size)
    calls = {
        "sdqn_score_afterstate_topk": lambda: ss.sdqn_score_afterstate_topk(
            t_cols, a_in[1], a_in[2], creq, mreq, *a_in[3:], **geo),
        "sdqn_score_cols_topk": lambda: ss.sdqn_score_cols_topk(
            cols, deltas, ops.FEATURE_SCALE, *a_in[4:], ops.DEFAULT_CEILINGS,
            **geo)}
    for name, call in calls.items():
        kernels = _one_call_kernels(call)
        assert len(kernels) == 1, kernels
        assert name in kernels[0], kernels[0]


def _plan_branch(n, b):
    plan = ss.score_plan(n, b)
    return plan.rows, plan.pod_rows


def _scoring_calls(n, b, device, seed):
    """Kernel 1's and kernel 3's wrapper calls at (N, B) with their plain
    versions on the same inputs: {name: (call, plain)}."""
    from repro_torch.sched import placement as pl

    cfg, state, params, pods = _case(n, b, device, seed)
    a_in = ops._afterstate_inputs(state, pods, cfg, params)
    cols = pl.fleet_cols(_fleet(n, device, seed))
    c_in = (cols, _deltas(b, device, seed), ops.FEATURE_SCALE, *a_in[4:])
    return {"sdqn_score_afterstate": (
                lambda: ss.sdqn_score_afterstate(*a_in),
                lambda: ss.sdqn_score_afterstate_plain(*a_in)),
            "sdqn_score_cols": (
                lambda: ss.sdqn_score_cols(*c_in),
                lambda: ss.sdqn_score_cols_plain(*c_in))}


@pytest.mark.cuda
@pytest.mark.parametrize("n,b", PLAN_SHAPES)
def test_scoring_kernels_match_plain_at_every_plan_branch(cuda_device, n, b):
    """Kernels 1 and 3 against their plain versions at 1e-5 on the sweep
    and the shapes that reach the plan's other branches, one launch each."""
    for name, (call, plain) in _scoring_calls(n, b, cuda_device,
                                              n + b).items():
        wrapper = getattr(ss, name)
        before = wrapper.launches
        got = call()
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert got.shape == (b, n) and bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, plain(), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n,b", sorted(
    {_plan_branch(n, b): (n, b) for n, b in PLAN_SHAPES}.values()))
def test_scoring_kernels_propagate_nan_at_every_plan_branch(cuda_device, n,
                                                            b):
    from repro_torch.sched import placement as pl

    assert _plan_branch(n, b) in BRANCHES
    cfg, state, params, pods = _case(n, b, cuda_device, 5)
    for key in ("b1", "w2"):
        bad = dict(params, **{key: torch.full_like(params[key], float("nan"))})
        assert bool(torch.isnan(ops.sdqn_score_afterstate(
            state, pods, cfg, bad)).all())
        assert bool(torch.isnan(ops.sdqn_score_delta(
            pl.fleet_cols(_fleet(n, cuda_device, 5)),
            _deltas(b, cuda_device, 5), bad)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,b", [(5000, 1), (5000, 32), (131072, 1),
                                 (131072, 32)])
def test_scoring_wrapper_call_is_one_device_kernel(cuda_device, n, b):
    for name, (call, _) in _scoring_calls(n, b, cuda_device, 11).items():
        kernels = _one_call_kernels(call)
        assert len(kernels) == 1, kernels
        assert name + "_kernel" in kernels[0], kernels


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 1000, 131072])
def test_column_kernels_match_plain_on_card(cuda_device, n):
    from repro_torch.core import env as tenv
    from repro_torch.sched import placement as pl

    params = dqn.init_qnet(torch.Generator().manual_seed(n),
                           device=cuda_device)
    fleet = _fleet(n, cuda_device, n)
    deltas = _deltas(32, cuda_device, n)
    before = ss.sdqn_score_cols.launches
    got = ops.sdqn_score_delta(pl.fleet_cols(fleet), deltas, params)
    assert ss.sdqn_score_cols.launches == before + 1
    torch.testing.assert_close(got, ops.sdqn_score_delta(
        pl.fleet_cols(fleet), deltas, params, mode="plain"),
        rtol=1e-5, atol=1e-5)
    feats = tenv.normalize_features(fleet.features())
    before = ss.sdqn_score.launches
    got = ops.sdqn_score(feats, params)
    assert ss.sdqn_score.launches == before + 1
    torch.testing.assert_close(got, ops.sdqn_score(feats, params,
                                                   mode="plain"),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_new_kernels_propagate_nan(cuda_device):
    from repro_torch.core import env as tenv
    from repro_torch.launch.mesh import plan_fleet_layout
    from repro_torch.sched import placement as pl

    cfg, state, params, pods = _case(3000, 4, cuda_device, 3)
    params = dict(params, b1=torch.full_like(params["b1"], float("nan")))
    lay = plan_fleet_layout(3000, shards=3)
    vals, idx = ops.sdqn_topk_afterstate(state, pods, cfg, params, k=4,
                                         layout=lay)
    assert bool(torch.isnan(vals).all()) and bool((idx == -1).all())
    fleet = _fleet(3000, cuda_device, 3)
    vals, _ = ops.sdqn_topk_delta(pl.fleet_cols(fleet),
                                  _deltas(4, cuda_device, 3), params, k=4,
                                  layout=lay)
    assert bool(torch.isnan(vals).all())
    assert bool(torch.isnan(ops.sdqn_score_delta(
        pl.fleet_cols(fleet), _deltas(2, cuda_device, 3), params)).all())
    assert bool(torch.isnan(ops.sdqn_score(
        tenv.normalize_features(fleet.features()), params)).all())


@pytest.mark.cuda
def test_new_kernels_reject_bad_inputs(cuda_device):
    from repro_torch.sched import placement as pl

    params = dqn.init_qnet(torch.Generator().manual_seed(0),
                           device=cuda_device)
    w = (params["w1"], params["b1"], params["w2"], params["b2"])
    fleet = _fleet(64, cuda_device, 0)
    cols = list(pl.fleet_cols(fleet))
    d = _deltas(2, cuda_device, 0)
    with pytest.raises(ValueError, match="feats"):
        ss.sdqn_score(torch.zeros(64, 5, device=cuda_device), *w)
    with pytest.raises(ValueError, match="deltas"):
        ss.sdqn_score_cols(cols, d.double(), ops.FEATURE_SCALE, *w)
    bad = cols[:2] + [torch.zeros(128, device=cuda_device)[::2]] + cols[3:]
    with pytest.raises(ValueError, match="contiguous"):
        ss.sdqn_score_cols(bad, d, ops.FEATURE_SCALE, *w)
    with pytest.raises(ValueError, match="k="):
        ss.sdqn_score_cols_topk(cols, d, ops.FEATURE_SCALE, *w,
                                (88.0, 95.0, 100.0), k=9, shards=1,
                                shard_size=64)
    with pytest.raises(ValueError, match="cover"):
        ss.sdqn_score_cols_topk(cols, d, ops.FEATURE_SCALE, *w,
                                (88.0, 95.0, 100.0), k=4, shards=2,
                                shard_size=16)


@pytest.mark.cuda
@pytest.mark.parametrize("substrate", ["cluster-sharded", "fleet-flat",
                                       "fleet-sharded"])
def test_new_daemon_batches_are_one_kernel_launch(cuda_device, substrate):
    from repro_torch.launch.mesh import plan_fleet_layout
    from repro_torch.sched import placement as pl

    n = 40000          # 8 shards of 5,000: the fused path from 4,096 up
    gen = torch.Generator().manual_seed(0)
    params = dqn.init_qnet(gen, device=cuda_device)
    lay = plan_fleet_layout(n, shards=8)
    if substrate == "cluster-sharded":
        cfg = fleet_cluster(n)
        sub = daemon.ClusterSubstrate(env.reset(gen, cfg, device=cuda_device),
                                      cfg, device=cuda_device, layout=lay)
        kernel, reqs = ss.sdqn_score_afterstate_topk, [env.default_pod(cfg)]
    else:
        sub = daemon.FleetSubstrate(
            pl.fresh_fleet(n, gen, device=cuda_device), device=cuda_device,
            layout=lay if substrate == "fleet-sharded" else None)
        kernel = (ss.sdqn_score_cols_topk if substrate == "fleet-sharded"
                  else ss.sdqn_score_cols)
        reqs = [pl.JobSpec()]
    d = daemon.PlacementDaemon(sub, params,
                               daemon.DaemonConfig(batch_size=32,
                                                   max_wait_s=1e9))
    d.warmup()
    before = kernel.launches
    for _ in range(70):
        d.submit(reqs[0])
    d.drain()
    m = d.metrics
    assert m.bound + m.dropped == m.submitted == 70
    assert m.device_launches == m.batches >= 3
    assert kernel.launches - before == m.device_launches


# ---------------------------------------------------------------------------
# kernels 6 and 7 and the policy classes' serving paths
# ---------------------------------------------------------------------------


def _qkv(b, sq, skv, hq, hkv, d, device, seed):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(s, generator=gen).to(device) for s in
                 ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))


def _scan(b, s, di, n, device, seed):
    gen = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=gen)

    args = (r(b, s, di) * 0.5,
            torch.nn.functional.softplus(r(b, s, di) * 0.3 - 1.0),
            -torch.exp(r(di, n) * 0.3), r(b, s, n) * 0.5, r(b, s, n) * 0.5,
            torch.ones(di), r(b, di, n) * 0.1)
    return tuple(a.to(device) for a in args)


# Sq and Skv across the kernel's 64-row tiles (15, 17, 63, 65), causal
# with Sq < Skv, and GQA 4:1 at D = 128
FA_EDGES = [(2, 15, 15, 2, 2, 8), (2, 17, 17, 2, 2, 8), (2, 63, 63, 2, 2, 8),
            (2, 65, 65, 2, 2, 8), (2, 15, 65, 4, 2, 16), (2, 17, 63, 4, 1, 32),
            (1, 65, 130, 2, 2, 64), (2, 63, 65, 8, 2, 128),
            (2, 65, 130, 8, 2, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 64, 64, 4, 4, 32), (2, 128, 128, 4, 2, 32), (2, 64, 128, 8, 1, 16),
    (1, 256, 256, 2, 2, 64), (3, 37, 37, 2, 2, 8), (2, 1, 1, 2, 1, 8),
    (32, 5000, 5000, 2, 2, 8)] + FA_EDGES)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_plain_on_card(cuda_device, shape, causal):
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _qkv(*shape, cuda_device, sum(shape))
    before = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    torch.testing.assert_close(got, ops.flash_attention(
        q, k, v, causal=causal, mode="plain"), rtol=3e-5, atol=3e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 32, 8, 4), (2, 64, 16, 8),
                                   (1, 128, 32, 16), (3, 37, 200, 4),
                                   (2, 256, 1024, 16)])
def test_mamba_scan_matches_plain_on_card(cuda_device, shape):
    from repro_torch.kernels import mamba_scan as ms

    args = _scan(*shape, cuda_device, sum(shape))
    before = ms.mamba_scan.launches
    y, h = ops.mamba_scan(*args)
    torch.cuda.synchronize()
    assert ms.mamba_scan.launches == before + 1
    wy, wh = ops.mamba_scan(*args, mode="plain")
    torch.testing.assert_close(y, wy, rtol=4e-5, atol=4e-5)
    torch.testing.assert_close(h, wh, rtol=4e-5, atol=4e-5)


@pytest.mark.cuda
def test_sequence_kernels_propagate_nan(cuda_device):
    q, k, v = _qkv(2, 300, 300, 2, 2, 8, cuda_device, 0)
    q[0, 5, 1, 3] = float("nan")                 # one query row of one head
    k[1, 17, 0, 0] = float("nan")                # one key of batch 1, head 0
    out = ops.flash_attention(q, k, v, causal=False)
    want = ops.flash_attention(q, k, v, causal=False, mode="plain")
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    assert bool(torch.isnan(out[0, 5, 1]).all())
    assert bool(torch.isnan(out[1, :, 0]).all())
    assert not bool(torch.isnan(out[0, :5]).any())
    x, dt, a, bm, cm, d, h0 = _scan(1, 32, 8, 4, cuda_device, 1)
    dt[0, 10, 2] = float("nan")
    y, h = ops.mamba_scan(x, dt, a, bm, cm, d, h0)
    assert bool(torch.isnan(y[0, 10:, 2]).all())
    assert not bool(torch.isnan(y[0, :10]).any())
    assert bool(torch.isnan(h[0, 2]).all()) and not bool(
        torch.isnan(h[0, 3]).any())


@pytest.mark.cuda
def test_sequence_kernels_reject_bad_inputs(cuda_device):
    from repro_torch.kernels import flash_attention as fa, mamba_scan as ms

    q, k, v = _qkv(1, 64, 64, 2, 2, 8, cuda_device, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           k, v, causal=False)
    shifted = torch.empty(q.numel() + 1, device=cuda_device)[1:].view(q.shape)
    shifted.copy_(q)                     # contiguous, 4 bytes off alignment
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(shifted, k, v, causal=False)
    with pytest.raises(ValueError, match="float32"):
        fa.flash_attention(q.half(), k, v, causal=False)
    with pytest.raises(ValueError, match="head width"):
        fa.flash_attention(*_qkv(1, 64, 64, 2, 2, 12, cuda_device, 2),
                           causal=False)
    with pytest.raises(ValueError, match="on cpu"):
        fa.flash_attention(q, k.cpu(), v, causal=False)
    args = list(_scan(1, 32, 8, 4, cuda_device, 3))
    with pytest.raises(ValueError, match="contiguous"):
        ms.mamba_scan(*args[:3], args[3].transpose(1, 2).contiguous()
                      .transpose(1, 2), *args[4:])
    with pytest.raises(ValueError, match="state size"):
        ms.mamba_scan(*_scan(1, 32, 8, 5, cuda_device, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 31, 33, 257, 2048])
@pytest.mark.parametrize("di", [200, 1024])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_mamba_scan_matches_plain_across_chunks_and_widths(cuda_device, s, di,
                                                          n):
    """Kernel 6 (its chunked scan) against plain at 4e-5: S across the
    chunk edges and long, di a multiple of the block's warps and not,
    every state size."""
    from repro_torch.kernels import mamba_scan as ms

    args = _scan(1, s, di, n, cuda_device, s + di + n)
    before = ms.mamba_scan.launches
    y, h = ms.mamba_scan(*args)
    torch.cuda.synchronize()
    assert ms.mamba_scan.launches == before + 1
    wy, wh = ms.mamba_scan_plain(*args)
    torch.testing.assert_close(y, wy, rtol=4e-5, atol=4e-5)
    torch.testing.assert_close(h, wh, rtol=4e-5, atol=4e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [(n, spl, seg, w) for n, spl, seg in
                                     tms.SCAN_BUILT for w in (4, 16)])
def test_mamba_scan_every_built_variant_matches_plain(cuda_device, variant,
                                                      monkeypatch):
    """Every (SPL, L) the kernel is built for, at 4 and 16 warps a block,
    so that any of them may be planned."""
    from repro_torch.kernels import mamba_scan as ms

    n, spl, seg, warps = variant
    args = _scan(2, 300, 37, n, cuda_device, spl + seg)
    monkeypatch.setattr(ms, "scan_plan", lambda b, di, n_: ms.ScanPlan.of(
        b, di, n_, spl, seg, warps))
    y, h = ms.mamba_scan(*args)
    wy, wh = ms.mamba_scan_plain(*args)
    torch.testing.assert_close(y, wy, rtol=4e-5, atol=4e-5)
    torch.testing.assert_close(h, wh, rtol=4e-5, atol=4e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n_real", [1, 9, 20, 31, 37, 95])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_mamba_scan_pad_rows_leave_hT_bit_exact_on_card(cuda_device, n_real,
                                                        n):
    """dt = 0 rows after ``n_real`` (the daemon's pad rows) leave hT bit
    for bit the hT of the sequence cut at ``n_real``."""
    from repro_torch.kernels import mamba_scan as ms

    x, dt, a, bm, cm, d, h0 = _scan(2, 96, 8, n, cuda_device, n_real)
    dt_pad = dt.clone()
    dt_pad[:, n_real:] = 0.0
    _, h_pad = ms.mamba_scan(x, dt_pad, a, bm, cm, d, h0)
    cut = [t[:, :n_real].contiguous() for t in (x, dt, bm, cm)]
    _, h_cut = ms.mamba_scan(cut[0], cut[1], a, cut[2], cut[3], d, h0)
    assert torch.equal(h_pad, h_cut)


@pytest.mark.cuda
def test_mamba_encode_sequence_pad_rows_never_reach_the_carry(cuda_device):
    """The mamba class's batch of 32 rows through kernel 6: two batches
    that differ only in their pad rows (after ``n_real``) give the same
    carry bit for bit, and it is the carry of the real rows alone (within
    4e-5: the cut batch's projections are other cuBLAS calls)."""
    from repro_torch.core import policy

    gen = torch.Generator().manual_seed(4)
    params = policy.get("mamba").init(gen, device=cuda_device)
    rows = torch.rand((32, policy.ENCODER_IN), generator=gen).to(cuda_device)
    other = torch.rand((32, policy.ENCODER_IN), generator=gen).to(cuda_device)
    for n_real in (1, 7, 31):
        mixed = torch.cat([rows[:n_real], other[n_real:]])
        _, h_pad = policy.mamba_encode_sequence(params, rows, n_real=n_real)
        _, h_mix = policy.mamba_encode_sequence(params, mixed, n_real=n_real)
        _, h_cut = policy.mamba_encode_sequence(params, rows[:n_real])
        assert torch.equal(h_pad, h_mix), n_real
        torch.testing.assert_close(h_pad, h_cut, rtol=4e-5, atol=4e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 32, 8, 4), (2, 256, 1024, 16)])
def test_mamba_scan_call_is_one_device_kernel(cuda_device, shape):
    from repro_torch.kernels import mamba_scan as ms

    args = _scan(*shape, cuda_device, 0)
    kernels = _one_call_kernels(lambda: ms.mamba_scan(*args))
    assert len(kernels) == 1 and "mamba_scan_kernel" in kernels[0], kernels


def _rows(n, device, seed):
    """Kernel 2's inputs: a fleet's normalized feature rows and a Q-net."""
    from repro_torch.core import env as tenv

    params = dqn.init_qnet(torch.Generator().manual_seed(seed),
                           device=device)
    feats = tenv.normalize_features(_fleet(n, device, seed).features())
    return feats.contiguous(), (params["w1"], params["b1"], params["w2"],
                                params["b2"])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 5000, 131072])
def test_sdqn_score_matches_plain_on_card(cuda_device, n):
    """Kernel 2 against plain at 1e-5, one launch a call, at the plan's
    R = 1 (N <= 5000) and R = 2 (N = 131,072)."""
    feats, w = _rows(n, cuda_device, n)
    before = ss.sdqn_score.launches
    got = ss.sdqn_score(feats, *w)
    torch.cuda.synchronize()
    assert ss.sdqn_score.launches == before + 1
    assert got.shape == (n,) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ss.sdqn_score_plain(feats, *w),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ss.SCORE_ROWS)
@pytest.mark.parametrize("n", [17, 5000, 131072])
def test_sdqn_score_every_plan_branch_matches_plain(cuda_device, rows, n,
                                                   monkeypatch):
    """Kernel 2 at every R of its launch plan (``score_plan(n, 1)``: node
    rows for R > 1), so that any of them may be planned."""
    feats, w = _rows(n, cuda_device, n + rows)
    plan = ss.ScorePlan.of(n, 1, rows)
    monkeypatch.setattr(ss, "score_plan", lambda n_, b_: plan)
    torch.testing.assert_close(ss.sdqn_score(feats, *w),
                               ss.sdqn_score_plain(feats, *w),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("key", ["w1", "b1", "w2", "b2"])
def test_sdqn_score_propagates_a_nan_weight_to_every_row(cuda_device, key):
    """One NaN weight, of the hidden layer (w1, b1: one unit) or of the
    output (w2, b2), makes every score NaN, as in the plain version."""
    feats, w = _rows(5000, cuda_device, 1)
    w = dict(zip(("w1", "b1", "w2", "b2"), w))
    w[key] = w[key].clone()
    w[key].view(-1)[0] = float("nan")
    q = ss.sdqn_score(feats, *w.values())
    want = ss.sdqn_score_plain(feats, *w.values())
    assert bool(torch.isnan(want).all()) and bool(torch.isnan(q).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5000, 131072])
def test_sdqn_score_call_is_one_device_kernel(cuda_device, n):
    feats, w = _rows(n, cuda_device, 2)
    kernels = _one_call_kernels(lambda: ss.sdqn_score(feats, *w))
    assert len(kernels) == 1 and "sdqn_score_kernel" in kernels[0], kernels


@pytest.mark.cuda
def test_sdqn_score_refuses_unaligned_rows(cuda_device):
    feats, w = _rows(64, cuda_device, 3)
    shifted = torch.empty(feats.numel() + 1,
                          device=cuda_device)[1:].view(64, 6)
    shifted.copy_(feats)                 # contiguous, 4 bytes off alignment
    with pytest.raises(ValueError, match="aligned"):
        ss.sdqn_score(shifted, *w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["attention", "mamba"])
def test_policy_daemon_batch_is_one_kernel_launch(cuda_device, name):
    """Every batch of the attention daemon is one launch of kernel 7, of
    the mamba daemon one launch of kernel 6 (its Q-head is no kernel)."""
    from repro_torch.core import policy
    from repro_torch.kernels import flash_attention as fa, mamba_scan as ms

    cfg = fleet_cluster(5000)
    gen = torch.Generator().manual_seed(0)
    spec = policy.get(name)
    d = daemon.PlacementDaemon(
        daemon.ClusterSubstrate(env.reset(gen, cfg, device=cuda_device), cfg,
                                device=cuda_device, policy=spec),
        spec.init(gen, device=cuda_device),
        daemon.DaemonConfig(batch_size=32, max_wait_s=1e9))
    d.warmup()
    kernel = fa.flash_attention if name == "attention" else ms.mamba_scan
    other = ms.mamba_scan if name == "attention" else fa.flash_attention
    before, before_other = kernel.launches, other.launches
    for _ in range(70):
        d.submit(env.default_pod(cfg))
    d.drain()
    m = d.metrics
    assert m.bound + m.dropped == m.submitted == 70
    assert m.device_launches == m.batches >= 3
    assert kernel.launches - before == m.device_launches
    assert other.launches == before_other


# ---------------------------------------------------------------------------
# kernel 8 and kernel 7 in bfloat16 / D = 128: the LM serving path
# ---------------------------------------------------------------------------


def _decode_qkv(b, hq, hkv, s, d, dtype, device, seed):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(x, generator=gen).to(dtype).to(device) for x in
                 ((b, hq, d), (b, hkv, s, d), (b, hkv, s, d)))


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(
        rtol=3e-5, atol=3e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4, 4, 128, 32), (2, 8, 2, 256, 64),
                                   (3, 4, 1, 512, 16), (8, 16, 16, 544, 128),
                                   (8, 32, 8, 4096, 128)])
@pytest.mark.parametrize("kv_len", [0, 1, 17, "full", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_matches_plain_on_card(cuda_device, shape, kv_len,
                                                dtype):
    from repro_torch.kernels import decode_attention as da

    b, hq, hkv, s, d = shape
    q, k, v = _decode_qkv(*shape, dtype, cuda_device, sum(shape))
    n = (s if kv_len == "full" else torch.randint(
        0, s + 1, (b,), generator=torch.Generator().manual_seed(b)).to(
            cuda_device) if kv_len == "ragged" else kv_len)
    before = da.decode_attention.launches
    got = ops.decode_attention(q, k, v, n)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, hq, d)
    torch.testing.assert_close(got, ops.decode_attention(q, k, v, n,
                                                         mode="plain"),
                               **_tol(dtype))


@pytest.mark.cuda
def test_decode_attention_reads_the_cache_in_place_on_card(cuda_device):
    """The model's (B, S, Hkv, D) cache permuted to (B, Hkv, S, D)."""
    gen = torch.Generator().manual_seed(5)
    cache_k, cache_v = (torch.randn((4, 300, 2, 64), generator=gen)
                        .to(torch.bfloat16).to(cuda_device) for _ in range(2))
    q = torch.randn((4, 8, 64), generator=gen).to(torch.bfloat16).to(
        cuda_device)
    kview, vview = cache_k.permute(0, 2, 1, 3), cache_v.permute(0, 2, 1, 3)
    got = ops.decode_attention(q, kview, vview, 257)
    torch.testing.assert_close(got, ops.decode_attention(
        q, kview.contiguous(), vview.contiguous(), 257, mode="plain"),
        **_tol(torch.bfloat16))


@pytest.mark.cuda
def test_decode_attention_refuses_on_card(cuda_device):
    from repro_torch.kernels import decode_attention as da

    q, k, v = _decode_qkv(2, 4, 2, 64, 32, torch.float32, cuda_device, 6)
    k5 = k.to(torch.float8_e5m2)
    with pytest.raises(ValueError, match="float8_e5m2"):
        da.decode_attention(q, k5, k5, 10)
    with pytest.raises(ValueError, match="cuda"):
        ops.decode_attention(q.cpu(), k.cpu(), v.cpu(), 10, mode="cuda")
    shifted = torch.empty(k.numel() + 1, device=cuda_device)[1:].view(k.shape)
    shifted.copy_(k)                     # contiguous, 4 bytes off alignment
    with pytest.raises(ValueError, match="aligned"):
        da.decode_attention(q, shifted, v, 10)
    with pytest.raises(ValueError, match="on cpu"):
        da.decode_attention(q, k.cpu(), v, 10)


# kernel 8 with a float8_e4m3fn cache: the shapes above, dbrx-132b's
# decode and a 16:1 group at 4,096 keys
E4M3_SHAPES = [(1, 4, 4, 128, 32), (2, 8, 2, 256, 64), (3, 4, 1, 512, 16),
               (8, 16, 16, 544, 128), (8, 32, 8, 4096, 128),
               (8, 48, 8, 544, 128), (2, 128, 8, 4096, 128)]


def _ragged_with_zero(b, s, device):
    n = torch.randint(1, s + 1, (b,), generator=torch.Generator().manual_seed(
        b + s))
    n[0] = 0
    return n.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", E4M3_SHAPES)
@pytest.mark.parametrize("kv_len", ["full", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_e4m3_cache_matches_plain_on_card(cuda_device, shape,
                                                           kv_len, dtype):
    """q in float32 or bfloat16 against a float8_e4m3fn cache, the full
    length or a ragged (B,) kv_len holding a 0: one launch, the plain
    version's output (which casts the cache to float32, exactly)."""
    from repro_torch.kernels import decode_attention as da

    b, hq, hkv, s, d = shape
    q, k, v = _decode_qkv(*shape, dtype, cuda_device, sum(shape) + 1)
    k, v = k.to(torch.float8_e4m3fn), v.to(torch.float8_e4m3fn)
    n = s if kv_len == "full" else _ragged_with_zero(b, s, cuda_device)
    before = da.decode_attention.launches
    got = ops.decode_attention(q, k, v, n)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, hq, d)
    want = ops.decode_attention(q, k, v, n, mode="plain")
    torch.testing.assert_close(got, want, **_tol(dtype))
    if kv_len == "ragged":
        assert not bool(got[0].any())


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 4, 6, 8, 12, 16, 24])
@pytest.mark.parametrize("cache", ["same", "e4m3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_every_group_size_matches_plain_on_card(
        cuda_device, group, cache, dtype):
    """The GQA groups of the repo's configs (and 24, two chunks of query
    heads), a (B, S, Hkv, D) cache view, a ragged kv_len holding a 0."""
    gen = torch.Generator().manual_seed(group)
    b, hkv, s, d = 3, 2, 700, 128
    ck, cv = (torch.randn((b, s, hkv, d), generator=gen).to(dtype)
              for _ in range(2))
    if cache == "e4m3":
        ck, cv = ck.to(torch.float8_e4m3fn), cv.to(torch.float8_e4m3fn)
    q = torch.randn((b, group * hkv, d), generator=gen).to(dtype)
    q, ck, cv = (t.to(cuda_device) for t in (q, ck, cv))
    kview, vview = ck.permute(0, 2, 1, 3), cv.permute(0, 2, 1, 3)
    n = _ragged_with_zero(b, s, cuda_device)
    got = ops.decode_attention(q, kview, vview, n)
    torch.testing.assert_close(got, ops.decode_attention(
        q, kview, vview, n, mode="plain"), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["same", "e4m3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_nan_in_q_gives_nan_rows_on_card(cuda_device, cache,
                                                          dtype):
    """A NaN in one query head makes that head's output NaN and nothing
    else, across the splits of a 4:1 group."""
    q, k, v = _decode_qkv(4, 32, 8, 3000, 128, dtype, cuda_device, 12)
    if cache == "e4m3":
        k, v = k.to(torch.float8_e4m3fn), v.to(torch.float8_e4m3fn)
    q[1, 5, 7] = float("nan")
    q[3, 30, 0] = float("nan")
    got = ops.decode_attention(q, k, v, 2900)
    want = ops.decode_attention(q, k, v, 2900, mode="plain")
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(got[1, 5]).all() and torch.isnan(got[3, 30]).all())
    assert int(torch.isnan(got).sum()) == 2 * 128


@pytest.mark.cuda
@pytest.mark.parametrize("cache", ["same", "e4m3"])
def test_decode_attention_q_past_float16s_range_matches_plain_on_card(
        cuda_device, cache):
    """bfloat16 q whose rows lie past float16's largest value (~1e5) or
    below its smallest normal (2^-14; here ~2^-18), or mix the two: with a
    float8 cache the products run in float16, so each query row is scaled
    by a power of two first; the output is the plain version's, finite
    where it is."""
    q, k, v = _decode_qkv(4, 32, 8, 600, 128, torch.bfloat16, cuda_device,
                          14)
    if cache == "e4m3":
        k, v = k.to(torch.float8_e4m3fn), v.to(torch.float8_e4m3fn)
    q[:, 0::4] *= 1e5
    q[:, 1::4] *= 2.0 ** -18
    q[:, 2::4, 0::2] *= 3e4
    q[:, 2::4, 1::2] *= 2.0 ** -20
    n = _ragged_with_zero(4, 600, cuda_device)
    got = ops.decode_attention(q, k, v, n)
    want = ops.decode_attention(q, k, v, n, mode="plain")
    assert bool(torch.isfinite(want.float()).all())
    torch.testing.assert_close(got, want, **_tol(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_converts_every_e4m3_code_exactly_on_card(
        cuda_device, dtype):
    """All 256 float8_e4m3fn codes as the one visible value row: with one
    key the output is that row, so it must be the codes' values exactly
    (NaN for 0x7F and 0xFF) in q's dtype."""
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(
        torch.float8_e4m3fn).reshape(2, 1, 1, 128)
    v = torch.zeros((2, 1, 40, 128), dtype=torch.float8_e4m3fn)
    v[:, :, :1] = codes
    v = v.to(cuda_device)
    k = torch.zeros_like(v)
    q = torch.zeros((2, 4, 128), dtype=dtype, device=cuda_device)
    got = ops.decode_attention(q, k, v, 1)
    want = codes.reshape(2, 1, 128).to(torch.float32).expand(2, 4, 128)
    torch.testing.assert_close(got.float().cpu(), want, rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n", [((8, 16, 16, 544, 128), 543),
                                     ((8, 48, 8, 544, 128), 543),
                                     ((8, 32, 8, 32768, 128), 32768),
                                     ((2, 128, 8, 4096, 128), 4096),
                                     ((2, 8, 2, 256, 64), 256)])
@pytest.mark.parametrize("cache", ["same", "e4m3"])
def test_decode_attention_call_is_one_device_kernel(cuda_device, shape, n,
                                                    cache):
    """One call is one device kernel, its splits merged inside it (the
    kernel nodes of a CUDA graph of one call); the 32k and the 16:1 shapes
    split their keys."""
    from repro_torch.kernels import decode_attention as da

    q, k, v = _decode_qkv(*shape, torch.bfloat16, cuda_device, 13)
    if cache == "e4m3":
        k, v = k.to(torch.float8_e4m3fn), v.to(torch.float8_e4m3fn)
    b, hq, hkv, s, d = shape
    p = da.plan(b, hq, hkv, s, n, da.capacity(q.device, q.dtype, k.dtype,
                                              d))
    names = _one_call_kernels(lambda: da.decode_attention(q, k, v, n))
    assert len(names) == 1 and "decode_attention" in names[0], names
    assert p.splits > 1 or s < 4096, p


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 64, 64, 4, 4, 32), (2, 128, 128, 4, 2, 32), (2, 64, 128, 8, 1, 16),
    (1, 256, 256, 2, 2, 64), (3, 37, 37, 2, 2, 8), (2, 100, 130, 4, 2, 128),
    (8, 512, 512, 16, 16, 128)] + FA_EDGES)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_bf16_and_d128_match_plain_on_card(cuda_device, shape,
                                                           causal):
    from repro_torch.kernels import flash_attention as fa

    b, sq, skv, hq, hkv, d = shape
    for dtype in (torch.bfloat16,) + ((torch.float32,) if d == 128 else ()):
        q, k, v = (t.to(dtype) for t in _qkv(*shape, cuda_device, sum(shape)))
        before = fa.flash_attention.launches
        got = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert fa.flash_attention.launches == before + 1
        assert got.dtype == dtype
        torch.testing.assert_close(got, ops.flash_attention(
            q, k, v, causal=causal, mode="plain"), **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 300, 300, 2, 2, 8),
                                   (2, 100, 130, 4, 2, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_nan_in_q_gives_the_plain_versions_nan_rows(
        cuda_device, dtype, shape, causal):
    """A NaN in one query row makes that (row, head) NaN and nothing else,
    in both dtypes (the daemon's NaN guard relies on it)."""
    d = shape[-1]
    q, k, v = (t.to(dtype) for t in _qkv(*shape, cuda_device, 5))
    q[0, 5, 1, 3] = float("nan")
    q[1, -1, 0, 0] = float("nan")
    out = ops.flash_attention(q, k, v, causal=causal)
    want = ops.flash_attention(q, k, v, causal=causal, mode="plain")
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    assert bool(torch.isnan(out[0, 5, 1]).all())
    assert bool(torch.isnan(out[1, -1, 0]).all())
    assert int(torch.isnan(out).sum()) == 2 * d


# kernel 7's wgmma instances (bf16, D in {64, 128}): chip_smoke.FA_FWD_TIMED's
# rows (the LM prefill, train_4k, whisper's encoder and cross-attention,
# dbrx's 6:1 GQA) and ragged Sq / Skv across the 128-row work items and the
# 64- or 128-key tiles (B, Sq, Skv, Hq, Hkv, D, causal)
FA_WGMMA_SHAPES = [(8, 512, 512, 16, 16, 128, True),
                   (1, 4096, 4096, 16, 16, 128, True),
                   (8, 1500, 1500, 16, 16, 64, False),
                   (8, 384, 1500, 16, 16, 64, False),
                   (8, 512, 512, 48, 8, 128, True),
                   (2, 77, 300, 6, 2, 64, True), (2, 77, 300, 6, 2, 128, False),
                   (1, 129, 257, 3, 1, 64, False), (2, 65, 130, 8, 2, 128, True),
                   (3, 1, 40, 4, 2, 128, True), (1, 300, 300, 2, 2, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FA_WGMMA_SHAPES)
def test_flash_attention_wgmma_matches_plain_on_card(cuda_device, shape):
    """Both wgmma instances (with and without the lse store) against the
    plain version: the output within 2e-2 and per row within
    ``chip_smoke.FA_ROW_TOL`` of the row's scale, the lse within 1e-4; the
    two instances' outputs equal, a second call equal bit for bit (the
    forward has no atomics), one launch a call."""
    import pathlib
    import sys

    from repro_torch.kernels import flash_attention as fa

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from chip_smoke import FA_ROW_TOL, attention_rss, row_rel_err

    b, sq, skv, hq, hkv, d, causal = shape
    assert fa.plan(d, torch.bfloat16).design == "wgmma"
    q, k, v = (t.to(torch.bfloat16)
               for t in _qkv(b, sq, skv, hq, hkv, d, cuda_device, sum(shape)))
    want, want_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                              return_lse=True)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal)
    out_lse, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    again = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 3
    torch.testing.assert_close(out, want, **_tol(torch.bfloat16))
    rss = attention_rss(q, k, v, want, torch.zeros_like(q), want_lse,
                        causal)[0]
    assert row_rel_err(out, want, rss) <= FA_ROW_TOL[torch.bfloat16]
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)
    assert torch.equal(out, out_lse) and torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 512, 512, 16, 16, 128, True),
                                   (8, 1500, 1500, 16, 16, 64, False)])
def test_flash_attention_wgmma_catches_a_planted_tile_fault(cuda_device,
                                                            shape):
    """V's last 32 keys taken from the 32 before them (what a kernel that
    read the wrong tile there would see): the kernel's output on those
    inputs fails ``FA_ROW_TOL`` against the plain version on the true
    ones, where its output on the true ones passes."""
    import pathlib
    import sys

    from repro_torch.kernels import flash_attention as fa

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    from chip_smoke import FA_ROW_TOL, attention_rss, row_rel_err, shifted_tile

    b, sq, skv, hq, hkv, d, causal = shape
    q, k, v = (t.to(torch.bfloat16)
               for t in _qkv(b, sq, skv, hq, hkv, d, cuda_device, 29))
    want, want_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                              return_lse=True)
    rss = attention_rss(q, k, v, want, torch.zeros_like(q), want_lse,
                        causal)[0]
    tol = FA_ROW_TOL[torch.bfloat16]
    good = fa.flash_attention(q, k, v, causal=causal)
    bad = fa.flash_attention(q, k, shifted_tile(v, 32), causal=causal)
    assert row_rel_err(good, want, rss) <= tol < row_rel_err(bad, want, rss)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_wgmma_call_is_one_device_kernel(cuda_device, d):
    """One launch of a wgmma instance is one device kernel, the wgmma one,
    with and without the lse store; a plan that disagrees with the
    kernel's tiles is refused with the reason."""
    from repro_torch.kernels import _build, flash_attention as fa

    q, k, v = (t.to(torch.bfloat16)
               for t in _qkv(2, 300, 300, 4, 2, d, cuda_device, d))
    for call in (lambda: fa.flash_attention(q, k, v, causal=True),
                 lambda: fa.flash_attention_fwd(q, k, v, causal=True)):
        names = _one_call_kernels(call)
        assert len(names) == 1 and "flash_attention_wgmma" in names[0], names
    p = fa.plan(d, torch.bfloat16)
    with pytest.raises(RuntimeError, match="disagrees with FwdTiles"):
        _build.launch("flash_attention", fa.SOURCE,
                      [_build.P] * 5 + [_build.I] * 10, q.device, q, k, v,
                      torch.empty_like(q), None, 2, 300, 300, 4, 2, d, 1, 1,
                      p.rows, p.smem_bytes + 16)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 300, 300, 2, 2, 64),
                                   (2, 100, 130, 4, 2, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_wgmma_nan_rows_match_plain(cuda_device, shape,
                                                    causal):
    """NaN in two query rows of the wgmma instances gives the plain
    version's NaN rows, and only those, with and without the lse store."""
    from repro_torch.kernels import flash_attention as fa

    d = shape[-1]
    q, k, v = (t.to(torch.bfloat16) for t in _qkv(*shape, cuda_device, 5))
    q[0, 5, 1, 3] = float("nan")
    q[1, -1, 0, 0] = float("nan")
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    for out in (fa.flash_attention(q, k, v, causal=causal),
                fa.flash_attention_fwd(q, k, v, causal=causal)[0]):
        assert torch.equal(torch.isnan(out), torch.isnan(want))
        assert int(torch.isnan(out).sum()) == 2 * d


@pytest.mark.cuda
def test_lm_wave_goes_through_kernels_7_and_8(cuda_device):
    """A smoke-size olmo-1b wave on the card: one launch of kernel 7 per
    layer for the prefill, one of kernel 8 per layer and decode step, and
    the tokens of the plain versions' run on the same card."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models import model as mdl

    cfg = get_config("olmo-1b", smoke=True)
    params = mdl.init_params(serve.seed_generator(0, 0, cuda_device), cfg,
                             cuda_device)
    prompts = serve.sample_requests(serve.seed_generator(0, 100, cuda_device),
                                    4, cfg.vocab_size, 32)
    f0, d0 = fa.flash_attention.launches, da.decode_attention.launches
    wave = serve.serve_wave(params, cfg, prompts, 8)
    assert fa.flash_attention.launches - f0 == cfg.num_layers
    assert da.decode_attention.launches - d0 == cfg.num_layers * 7
    plain = serve.serve_wave(params, cfg, prompts, 8, attn_mode="plain")
    assert fa.flash_attention.launches - f0 == cfg.num_layers
    torch.testing.assert_close(wave.prefill_logits, plain.prefill_logits,
                               rtol=2e-2, atol=2e-2)
    near = (plain.top2_gap <= 4e-2).any(dim=0).nonzero()
    upto = int(near[0]) if len(near) else 8
    torch.testing.assert_close(wave.tokens[:, :upto], plain.tokens[:, :upto])


@pytest.mark.cuda
def test_mamba_scan_at_falcon_mamba_width_matches_plain_on_card(cuda_device):
    """Kernel 6 at falcon-mamba-7b's d_inner = 8192, N = 16 (the ssm
    prefill's grid of 1,024 x B blocks), S cut to 64 for the plain loop."""
    from repro_torch.kernels import mamba_scan as ms

    args = _scan(2, 64, 8192, 16, cuda_device, 8192)
    before = ms.mamba_scan.launches
    y, h = ms.mamba_scan(*args)
    torch.cuda.synchronize()
    assert ms.mamba_scan.launches == before + 1
    wy, wh = ms.mamba_scan_plain(*args)
    torch.testing.assert_close(y, wy, rtol=4e-5, atol=4e-5)
    torch.testing.assert_close(h, wh, rtol=4e-5, atol=4e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [1500, 384, 7])
def test_flash_attention_at_whisper_shapes_matches_plain_on_card(cuda_device,
                                                                sq):
    """Kernel 7 in bf16 at D = 64 against whisper's 1,500 encoder frames:
    the encoder (Sq = Skv), cross-attention at prefill (Sq = 384) and a
    ragged short query block, non-causal."""
    q, k, v = (t.to(torch.bfloat16)
               for t in _qkv(2, sq, 1500, 16, 16, 64, cuda_device, sq))
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, causal=False),
        ops.flash_attention(q, k, v, causal=False, mode="plain"),
        **_tol(torch.bfloat16))


@pytest.mark.cuda
def test_decode_attention_at_whisper_cross_cache_matches_plain_on_card(
        cuda_device):
    """Kernel 8 in bf16 at D = 64 against whisper's (B, 1500, 16, 64)
    encoder cache seen through ``permute``, kv_len = 1500 (one-token
    cross-attention through ``layers.attention`` with no kv_len)."""
    from repro_torch.models import layers

    gen = torch.Generator().manual_seed(9)
    xk, xv = (torch.randn((4, 1500, 16, 64), generator=gen)
              .to(torch.bfloat16).to(cuda_device) for _ in range(2))
    q = torch.randn((4, 1, 16, 64), generator=gen).to(torch.bfloat16).to(
        cuda_device)
    got = layers.attention(q, xk, xv, causal=False)
    want = ops.decode_attention(q[:, 0], xk.permute(0, 2, 1, 3).contiguous(),
                                xv.permute(0, 2, 1, 3).contiguous(), 1500,
                                mode="plain")
    torch.testing.assert_close(got[:, 0], want, **_tol(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "qwen2-moe-a2.7b",
                                  "jamba-1.5-large-398b", "whisper-medium"])
def test_family_wave_goes_through_its_kernels(cuda_device, arch):
    """A smoke-size wave of each new family on the card: kernel 6 once a
    mamba layer in prefill, kernel 7 once an attention layer (and for
    whisper once an encoder layer and once a cross-attention), kernel 8
    once an attention layer (whisper: twice) a decode step; the plain
    versions' prefill logits on the same card."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.launch import serve
    from repro_torch.models import model as mdl

    cfg = get_config(arch, smoke=True)
    spec = mdl.block_spec(cfg)
    nb = mdl.num_blocks(cfg)
    attn = nb * sum(s.mixer == "attn" for s in spec)
    mamba = nb * sum(s.mixer == "mamba" for s in spec)
    cross = nb * sum(s.cross for s in spec)
    params = mdl.init_params(serve.seed_generator(0, 0, cuda_device), cfg,
                             cuda_device)
    prompts = serve.sample_requests(serve.seed_generator(0, 100, cuda_device),
                                    4, cfg.vocab_size, 32)
    extra = None
    if cfg.is_encoder_decoder:
        gen = serve.seed_generator(0, 3, cuda_device)
        extra = {"frames": 0.02 * torch.randn(
            (4, cfg.enc_seq, cfg.d_model), generator=gen,
            device=cuda_device).to(torch.bfloat16)}
    counts = lambda: (fa.flash_attention.launches,     # noqa: E731
                      da.decode_attention.launches, ms.mamba_scan.launches)
    f0, d0, m0 = counts()
    wave = serve.serve_wave(params, cfg, prompts, 8, extra=extra)
    f1, d1, m1 = counts()
    assert (f1 - f0, d1 - d0, m1 - m0) == (
        attn + cross + (cfg.enc_layers if cross else 0),
        (attn + cross) * 7, mamba)
    plain = serve.serve_wave(params, cfg, prompts, 8, attn_mode="plain",
                             extra=extra)
    assert counts() == (f1, d1, m1)
    torch.testing.assert_close(wave.prefill_logits, plain.prefill_logits,
                               rtol=5e-2, atol=5e-2)


def _coc_4k(device, seed, randomize=True):
    """A cluster-of-clusters-4k pool (three classes whose capacities
    differ), randomized mid-flight or not, with its random Q-net."""
    from repro_torch import scenarios

    cfg = scenarios.make_env("cluster-of-clusters-4k", randomize=randomize)
    gen = torch.Generator().manual_seed(seed)
    state = env.reset(gen, cfg, device=device)
    return cfg, state, dqn.init_qnet(gen, device=device), gen


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 32])
def test_kernel_matches_plain_on_a_scenario_pool(cuda_device, b):
    """Kernel 1 on a heterogeneous 4,096-node pool: per-node capacities,
    pod slots and memory of three classes, the scenario's pod mix."""
    from repro_torch import scenarios

    cfg, state, params, gen = _coc_4k(cuda_device, 3 + b)
    assert len(set(state.cpu_capacity.tolist())) == 3
    table = env.sample_pod_table(gen, cfg, b, device=cuda_device)
    got = ops.sdqn_score_afterstate(state, table.specs, cfg, params,
                                    mode="cuda")
    want = ops.sdqn_score_afterstate(state, table.specs, cfg, params,
                                     mode="plain")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert scenarios.get_scenario("cluster-of-clusters-4k").n_nodes == 4096


@pytest.mark.cuda
def test_consolidator_fused_matches_plain_on_card(cuda_device):
    """The consolidator at 4,096 nodes scores through kernel 1 (one launch
    a cluster a sub-step) and moves what its plain version moves."""
    from repro_torch.core.types import ClusterState, PodLedger, PodSpec
    from repro_torch.sched import elastic

    cfg, state, params, _ = _coc_4k(cuda_device, 7, randomize=False)
    # two light nodes to drain, each pod ledgered with a long lifetime
    pod = env.default_pod(cfg)
    ledger = env.ledger_init(4, device=cuda_device)
    for slot, node in enumerate((10, 10, 2000, 3000)):
        state = env.place(state, node, pod, cfg)
        ledger = env.ledger_record(ledger, slot, node, 1e6 + slot, pod)
    states = ClusterState(*(x[None] for x in state))
    ledgers = PodLedger(ledger.node[None], ledger.expiry_s[None],
                        PodSpec(*(x[None] for x in ledger.spec)))
    before = ss.sdqn_score_afterstate.launches
    got = elastic.make_consolidator(params, cfg)(states, ledgers)
    torch.cuda.synchronize()
    assert ss.sdqn_score_afterstate.launches == before + 4
    want = elastic.make_consolidator(params, cfg, fused="plain")(states,
                                                                 ledgers)
    assert torch.equal(got[2], want[2]) and int(got[2][0]) > 0
    assert torch.equal(got[1].node, want[1].node)
    assert torch.equal(got[0].exp_pods, want[0].exp_pods)


# ---------------------------------------------------------------------------
# kernel 7's backward and LM training; no kernel drops a gradient
# ---------------------------------------------------------------------------

# (B, Sq, Skv, Hq, Hkv, D, causal): OLMo-1B's training shape, GQA 4:1 and
# 6:1, whisper's encoder and cross-attention, ragged causal Sq < Skv (6:1
# at D = 128 too)
FA_BWD_SHAPES = [(8, 512, 512, 16, 16, 128, True), (2, 512, 512, 32, 8, 128, True),
                 (2, 130, 130, 12, 2, 128, True), (2, 1500, 1500, 4, 4, 64, False),
                 (2, 448, 1500, 4, 4, 64, False), (2, 77, 300, 6, 2, 64, True),
                 (3, 65, 65, 2, 1, 64, True), (2, 77, 300, 12, 2, 128, True)]
# relative to the largest gradient: float32 exact to 1e-4; bf16 rounds P
# and dS to bf16 for the products and the gradients on output (PERF.md)
FA_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _bwd_case(shape, dtype, device, seed):
    b, sq, skv, hq, hkv, d, _ = shape
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(s, generator=gen).to(device, dtype) for s in
                 ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d),
                  (b, sq, hq, d)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FA_BWD_SHAPES)
def test_flash_attention_backward_matches_plain_on_card(cuda_device, shape,
                                                        dtype):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do = _bwd_case(shape, dtype, cuda_device, sum(shape[:6]))
    causal = shape[6]
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    _, want_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                           return_lse=True)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    want = fa.flash_attention_bwd_plain(q, k, v, out, do, lse, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = float((g.float() - w.float()).abs().max())
        assert err <= FA_BWD_TOL[dtype] * float(w.float().abs().max()), err
    # a second call bit for bit: dK and dV summed in registers in a fixed
    # order, bf16 dQ's pieces added in ascending key-block order
    again = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.cuda
def test_flash_attention_under_grad_runs_its_backward(cuda_device):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do = _bwd_case((2, 96, 96, 4, 2, 64, True), torch.bfloat16,
                            cuda_device, 1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    f0, b0 = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    out = ops.flash_attention(*leaves, causal=True)
    out.backward(do)
    assert (fa.flash_attention.launches - f0,
            fa.flash_attention_bwd.launches - b0) == (1, 1)
    want = fa.flash_attention_bwd(q, k, v, out.detach(), do,
                                  fa.flash_attention_fwd(q, k, v,
                                                         causal=True)[1],
                                  causal=True)
    # dQ, dK, dV bit for bit
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)
    small = [t.clone().requires_grad_() for t in
             _qkv(1, 16, 16, 2, 2, 8, cuda_device, 0)]
    with pytest.raises(ValueError, match="no backward at head width 8"):
        ops.flash_attention(*small, causal=False)
    with torch.no_grad():
        ops.flash_attention(*small, causal=False)        # serving: fine


# kernel 6's backward: the plain twins' shapes (the mamba class's batch
# and the wide one), ragged S across chunk edges, several batch rows
SCAN_BWD_SHAPES = [(1, 32, 8, 4), (2, 256, 1024, 16), (3, 77, 200, 8),
                   (2, 129, 13, 16)]
SCAN_BWD_TOL = 1e-4         # relative to each gradient's largest element


@pytest.mark.cuda
@pytest.mark.parametrize("dht", [True, False])
@pytest.mark.parametrize("shape", SCAN_BWD_SHAPES)
def test_mamba_scan_bwd_matches_plain_on_card(cuda_device, shape, dht):
    """The training forward's chunk states and y (bit for bit the serving
    launch's), and the seven gradients against ``mamba_scan_bwd_plain``
    on the same tensors; a second call bit for bit; two device kernels."""
    b, s, di, n = shape
    args = _scan(b, s, di, n, cuda_device, s + di)
    serve_y, serve_h = tms.mamba_scan(*args)
    y, h_t, states = tms.mamba_scan_fwd(*args)
    _, _, want_states = tms.mamba_scan_plain(*args, return_states=True)
    assert torch.equal(y, serve_y) and torch.equal(h_t, serve_h)
    torch.testing.assert_close(states, want_states, rtol=4e-5, atol=4e-5)
    gen = torch.Generator().manual_seed(s)
    dy = torch.randn((b, s, di), generator=gen).to(cuda_device)
    dh = torch.randn((b, di, n), generator=gen).to(cuda_device) if dht \
        else None
    before = tms.mamba_scan_bwd.launches
    got = tms.mamba_scan_bwd(*args[:6], states, dy, dh)
    torch.cuda.synchronize()
    assert tms.mamba_scan_bwd.launches == before + 1
    want = tms.mamba_scan_bwd_plain(*args[:6], states, dy, dh)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = float((g - w).abs().max())
        assert err <= SCAN_BWD_TOL * float(w.abs().max()), err
    again = tms.mamba_scan_bwd(*args[:6], states, dy, dh)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    kernels = _one_call_kernels(lambda: tms.mamba_scan_bwd(
        *args[:6], states, dy, dh))
    assert len(kernels) == 2 and all("mamba_scan_bwd" in k for k in kernels)


# every branch of the backward's launch plan: each built (N, SPL, L) at
# each K (channels a warp) and W (warps a block) the plan can choose
SCAN_BWD_BRANCHES = [(n, spl, seg, k, w) for (n, spl, seg), ks in
                     sorted(tms.SCAN_BWD_BUILT.items()) for k in ks
                     for w in (1, 2, 4, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dht", [True, False])
@pytest.mark.parametrize("branch", SCAN_BWD_BRANCHES)
def test_mamba_scan_bwd_every_plan_branch_matches_plain(cuda_device, branch,
                                                       dht, monkeypatch):
    """The backward at every plan branch, forced (the forward on the same
    (SPL, L), so that the chunk states line up): S across three chunks,
    ragged, and di ragged against W K (the last block's last warps have no
    channel); the seven gradients within ``SCAN_BWD_TOL`` of
    ``mamba_scan_bwd_plain``'s, a second call bit for bit."""
    n, spl, seg, k, warps = branch
    chunk = 32 // (n // spl) * seg
    b, s, di = 2, 2 * chunk + 5, 2 * warps * k + 3
    fwd = tms.ScanPlan.of(b, di, n, spl, seg, 8)
    plan = tms.ScanBwdPlan.of(b, di, n, spl, seg, warps, k)
    monkeypatch.setattr(tms, "scan_plan", lambda *_: fwd)
    monkeypatch.setattr(tms, "scan_bwd_plan", lambda *_: plan)
    args = _scan(b, s, di, n, cuda_device, sum(branch))
    _, _, states = tms.mamba_scan_fwd(*args)
    gen = torch.Generator().manual_seed(s + k)
    dy = torch.randn((b, s, di), generator=gen).to(cuda_device)
    dh = torch.randn((b, di, n), generator=gen).to(cuda_device) if dht \
        else None
    got = tms.mamba_scan_bwd(*args[:6], states, dy, dh)
    again = tms.mamba_scan_bwd(*args[:6], states, dy, dh)
    torch.cuda.synchronize()
    want = tms.mamba_scan_bwd_plain(*args[:6], states, dy, dh)
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        assert err <= SCAN_BWD_TOL * float(w.abs().max()), (branch, err)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.cuda
def test_mamba_scan_bwd_plan_holds_two_blocks_an_sm(cuda_device):
    """Every built instance of the backward, at 8 warps a block, fits two
    blocks on one SM of the card (the runtime's occupancy calculator)."""
    for (n, spl, seg), ks in tms.SCAN_BWD_BUILT.items():
        for k in ks:
            plan = tms.ScanBwdPlan.of(1, 4096, n, spl, seg, 8, k)
            assert tms.scan_bwd_occupancy(plan) >= 2, (n, spl, seg, k)


@pytest.mark.cuda
def test_mamba_scan_under_grad_runs_its_backward(cuda_device):
    """Under grad, ``ops.mamba_scan`` launches the training forward and, on
    backward, ``mamba_scan_bwd`` once: every input's gradient (A's through
    a = -exp(A_log) too) is autograd's of the plain version, and an input
    that needs no gradient gets none."""
    args = _scan(2, 100, 24, 16, cuda_device, 4)
    a_log = torch.log(-args[2])
    runs = []
    for fn in (ops.mamba_scan, tms.mamba_scan_plain):
        live = [t.clone().requires_grad_() for t in args]
        log_a = a_log.clone().requires_grad_()
        f0, b0 = tms.mamba_scan.launches, tms.mamba_scan_bwd.launches
        y, h_t = fn(live[0], live[1], -torch.exp(log_a), *live[3:])
        (y.square().sum() + h_t.sum()).backward()
        runs.append(([t.grad for t in live[:2]] + [log_a.grad]
                     + [t.grad for t in live[3:]],
                     (tms.mamba_scan.launches - f0,
                      tms.mamba_scan_bwd.launches - b0)))
    assert runs[0][1] == (1, 1) and runs[1][1] == (0, 0), runs
    for g, w in zip(runs[0][0], runs[1][0]):
        assert float((g - w).abs().max()) <= SCAN_BWD_TOL * float(
            w.abs().max())
    x = args[0].clone().requires_grad_()
    y, _ = ops.mamba_scan(x, *args[1:])
    y.sum().backward()
    assert x.grad is not None and all(t.grad is None for t in args[1:])


def _recorded(monkeypatch, module):
    """Spy on ``module._launch_forward``: each call's thread and a copy of
    its outputs, in order."""
    import threading

    calls, real = [], module._launch_forward

    def spy(*args, **kwargs):
        outs = real(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append((threading.get_ident(),
                      [None if t is None else t.clone() for t in outs]))
        return outs

    monkeypatch.setattr(module, "_launch_forward", spy)
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("kernel", ["attention_d128", "attention_d64",
                                    "scan"])
def test_kernels_7_and_6_recompute_inside_the_backward_on_card(
        cuda_device, kernel, policy, monkeypatch):
    """Kernel 7's LSE instance (bf16) and kernel 6's training instance
    under ``model.checkpointed`` inside ``torch.autograd.grad``: the
    recompute launches the kernel again, on autograd's device thread (not
    the caller's), with outputs bit for bit the first forward's, and the
    gradients are the unwrapped call's bit for bit (kernel 7's dQ too: its
    pieces add in ascending key-block order).  Counts: two forward
    launches and one backward."""
    import threading

    from repro_torch.kernels import flash_attention as fa

    if kernel == "scan":
        module, bwd = tms, tms.mamba_scan_bwd
        inputs = _scan(2, 200, 64, 16, cuda_device, 5)
        grad_out = torch.randn((2, 200, 64), generator=torch.Generator()
                               .manual_seed(6)).to(cuda_device)
        fn = lambda *t: ops.mamba_scan(*t)[0]           # noqa: E731
    else:
        d = 128 if kernel == "attention_d128" else 64
        module, bwd = fa, fa.flash_attention_bwd
        *inputs, grad_out = _bwd_case((2, 300, 300, 8, 4, d, True),
                                      torch.bfloat16, cuda_device, d)
        fn = lambda *t: ops.flash_attention(*t, causal=True)  # noqa: E731
    from repro_torch.models.model import checkpointed

    fwd = module.mamba_scan if kernel == "scan" else module.flash_attention
    calls = _recorded(monkeypatch, module)
    runs = []
    for call in (fn, lambda *t: checkpointed(policy, fn, *t)):
        leaves = [t.clone().requires_grad_() for t in inputs]
        f0, b0 = fwd.launches, bwd.launches
        grads = torch.autograd.grad(call(*leaves), leaves, grad_out)
        torch.cuda.synchronize()
        runs.append((grads, (fwd.launches - f0, bwd.launches - b0)))
    assert [r[1] for r in runs] == [(1, 1), (2, 1)], runs
    main = threading.get_ident()
    assert [c[0] == main for c in calls] == [True, True, False]
    for first, again in zip(calls[1][1], calls[2][1]):
        assert (first is None and again is None) or torch.equal(first, again)
    for i, (got, want) in enumerate(zip(runs[1][0], runs[0][0])):
        assert torch.equal(got, want), i


@pytest.mark.cuda
def test_kernels_without_a_backward_refuse_grad_on_card(cuda_device):
    """Kernels 1-5 and 8 raise under grad mode when an input requires grad
    (their raw launches would drop the gradient); kernel 6, which has a
    backward, runs outside grad mode as before."""
    cfg, state, params, pods = _case(300, 4, cuda_device, 7)
    live = {k: p.clone().requires_grad_() for k, p in params.items()}
    with pytest.raises(ValueError, match="requires grad"):
        ops.sdqn_score_afterstate(state, pods, cfg, live)
    with pytest.raises(ValueError, match="requires grad"):
        ops.sdqn_topk_afterstate(state, pods, cfg, live, k=4)
    feats = torch.rand((64, 6), device=cuda_device)
    with pytest.raises(ValueError, match="requires grad"):
        ops.sdqn_score(feats, live)
    cols = tuple(torch.rand(64, device=cuda_device) for _ in range(6))
    deltas = torch.rand((2, 6), device=cuda_device)
    with pytest.raises(ValueError, match="requires grad"):
        ops.sdqn_score_delta(cols, deltas, live)
    with pytest.raises(ValueError, match="requires grad"):
        ops.sdqn_topk_delta(cols, deltas, live, k=4)
    q = torch.randn((2, 4, 64), device=cuda_device, requires_grad=True)
    kv = torch.randn((2, 2, 32, 64), device=cuda_device)
    with pytest.raises(ValueError, match="requires grad"):
        ops.decode_attention(q, kv, kv, 32)
    args = list(_scan(1, 32, 8, 4, cuda_device, 3))
    args[0] = args[0].clone().requires_grad_()
    with torch.no_grad():                      # outside grad mode: fine
        ops.sdqn_score_afterstate(state, pods, cfg, live)
        ops.mamba_scan(*args)
        ops.decode_attention(q, kv, kv, 32)


@pytest.mark.cuda
def test_lm_gradients_through_the_kernels_match_plain_on_card(cuda_device):
    """The loss and every gradient leaf of smoke OLMo-1B in float32 at head
    width 64, through kernel 7 and its backward and through the plain
    versions: within 1e-5, a leaf relative to its largest element."""
    import dataclasses as dc

    from repro_torch.configs import base as tbase
    from repro_torch.data import synthetic
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import steps
    from repro_torch.optim import tree_leaves

    cfg = dc.replace(tbase.get_config("olmo-1b", smoke=True), head_dim=64,
                     dtype="float32", param_dtype="float32")
    params, _ = steps.init_train_state(torch.Generator().manual_seed(0),
                                       cfg, device=cuda_device)
    batch = {k: x.to(cuda_device) for k, x in next(
        synthetic.synthetic_batches(0, 4, 64, cfg.vocab_size)).items()}
    runs, bwd = {}, {}
    for mode in ("cuda", "plain"):
        b0 = fa.flash_attention_bwd.launches
        runs[mode] = steps.value_and_grad(cfg, params, batch, attn_mode=mode)
        bwd[mode] = fa.flash_attention_bwd.launches - b0
    assert bwd == {"cuda": cfg.num_layers, "plain": 0}
    torch.testing.assert_close(runs["cuda"][0]["loss"],
                               runs["plain"][0]["loss"], rtol=1e-5, atol=1e-5)
    for a, b in zip(tree_leaves(runs["cuda"][1]),
                    tree_leaves(runs["plain"][1])):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch,shape,micro", [("olmo-1b", "train_4k", 256),
                                              ("falcon-mamba-7b",
                                               "long_500k", 0)])
def test_check_cell_runs_the_planned_step_on_card(cuda_device, arch, shape,
                                                  micro, remat):
    """``launch.dryrun.check_cell`` at smoke widths (head width 64, the
    backward's): the arguments it allocates are the plan's to the byte,
    the step runs through the kernels (kernel 7 and its backward once a
    layer a microbatch a step in training, the forward twice under "full",
    its recompute inside the backward, as the plan's launches say) and
    the loss is finite."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import dryrun

    cfg = dataclasses.replace(get_config(arch, smoke=True), head_dim=64,
                              remat=remat)
    plan = dryrun.run_cell(arch, shape, micro=micro, cfg=cfg)
    assert plan["fits_hbm_80g"]
    before = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    got = dryrun.check_cell(arch, shape, micro=micro, device=cuda_device,
                            cfg=cfg, n_steps=2)
    assert got["argument_bytes"] == plan["memory"]["traced_argument_bytes"]
    assert got["peak_bytes"] >= got["argument_bytes"] > 0
    runs = (fa.flash_attention.launches - before[0],
            fa.flash_attention_bwd.launches - before[1])
    if plan["kind"] == "train":
        assert np.isfinite(got["loss"])
        want = cfg.num_layers * got["microbatches"] * 2
        assert runs == ((1 if remat == "none" else 2) * want, want)
        planned = plan["memory"]["launches"]
        assert (2 * planned["flash_attention"],
                2 * planned["flash_attention_bwd"]) == runs
    else:
        assert runs == (0, 0) and got["loss"] is None
