"""The PyTorch port's serving slice against the JAX reference daemon.

Both daemons serve the same 64-request trace over the same 300-node
cluster and Q-net (made in JAX, carried across through numpy) with the
same injected clock; the decision sequences must be identical and the
final live buffers must agree.  The reference scores through the Pallas
kernel in interpret mode, the port through its fused path (the plain twin
of the CUDA kernel on the CPU).
"""
import ast
import dataclasses
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.core import dqn as jdqn, env as jenv
from repro.core.types import fleet_cluster as j_fleet_cluster
from repro.scenarios import arrivals as jarrivals
from repro.sched import daemon as jdaemon
from repro_torch import convert
from repro_torch.core import env as tenv, policy as tpolicy
from repro_torch.core.types import NO_PLACEMENT, fleet_cluster
from repro_torch.scenarios import arrivals as tarrivals
from repro_torch.sched import daemon as tdaemon

REPO = pathlib.Path(__file__).resolve().parents[1]
N_NODES = 300
N_REQUESTS = 64
TIE_TOL = 1e-5      # two candidates closer than this could swap places


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class BreachTimer:
    """Deadline stopwatch: the scoring launch of batch ``breach`` appears to
    take 10 s, every other launch 0 s."""

    def __init__(self, breach):
        self.calls = 0
        self.breach = breach

    def __call__(self):
        c = self.calls
        self.calls += 1
        return 10.0 if (c // 2 == self.breach and c % 2 == 1) else 0.0


def _cluster(seed):
    """A reference reset with tight CPU headroom: node i fits only k_i more
    pods (k_i in 1..3), so identical pods of one batch collide."""
    cfg = dataclasses.replace(j_fleet_cluster(N_NODES), unhealthy_prob=0.1,
                              randomize_workload=True)
    state = jax.tree.map(np.asarray, jenv.reset(jax.random.PRNGKey(seed), cfg))
    k = np.random.default_rng(seed).integers(1, 4, N_NODES)
    cols = state._asdict()
    cols["cpu_requested"] = (cols["cpu_capacity"]
                             - np.float32(cfg.pod_cpu_request) * k
                             ).astype(np.float32)
    return cfg, cols


def _spy_reference(daemon, log):
    inner = daemon._scorer

    def scorer(params, snap, pods, carry, n_real):
        q, ok, c = inner(params, snap, pods, carry, n_real)
        log.append((np.asarray(q)[:n_real], np.asarray(ok)[:n_real]))
        return q, ok, c

    daemon._scorer = scorer


def _spy_port(daemon, log):
    """The port's scorer has the reference's contract; this spy logs the
    pad rows too."""
    inner = daemon._scorer

    def scorer(params, snap, pods, carry, n_real):
        q, ok, c = inner(params, snap, pods, carry, n_real)
        log.append((q.numpy(), ok.numpy()))
        return q, ok, c

    daemon._scorer = scorer


def _drive(daemon, clock, trace, fail_after):
    """Submit the trace on its own schedule, polling after each arrival;
    fail the node of the first bound decision after ``fail_after``
    requests, then drain."""
    for i, (t, pod) in enumerate(zip(trace.t_s, trace.pods)):
        clock.t = float(t)
        daemon.submit(pod, now=float(t))
        daemon.poll()
        if i == fail_after:
            bound = [d.node for d in daemon.decisions if d.node != NO_PLACEMENT]
            daemon.fail_node(bound[0])
    clock.t = float(trace.t_s[-1]) + 1.0
    daemon.drain()


def _min_gap(log):
    gaps = []
    for q, ok in log:
        for row, okr in zip(q, ok):
            top = np.sort(row[okr])[::-1][:8]
            if top.size > 1:
                gaps.append(np.min(top[:-1] - top[1:]))
    return min(gaps)


@pytest.mark.parametrize("conflict_policy", ["requeue", "next-best"])
def test_daemon_slice_matches_reference(conflict_policy):
    seed = 3
    jcfg, cols = _cluster(seed)
    jparams = jdqn.init_qnet(jax.random.PRNGKey(seed + 100))
    kw = dict(batch_size=8, max_wait_s=0.005, conflict_policy=conflict_policy,
              score_deadline_s=1.0, degrade_batches=2, max_retries=3)
    trace = jarrivals.arrival_trace(jax.random.PRNGKey(0), jcfg, N_REQUESTS,
                                    rate_per_s=500.0)

    j_clock = FakeClock()
    jd = jdaemon.PlacementDaemon(
        jdaemon.ClusterSubstrate(jenv.ClusterState(**cols), jcfg), jparams,
        jdaemon.DaemonConfig(fused="interpret", **kw), clock=j_clock,
        timer=BreachTimer(2))
    j_log = []
    _spy_reference(jd, j_log)
    _drive(jd, j_clock, trace, fail_after=40)

    cfg = dataclasses.replace(fleet_cluster(N_NODES), unhealthy_prob=0.1,
                              randomize_workload=True)
    t_clock = FakeClock()
    td = tdaemon.PlacementDaemon(
        tdaemon.ClusterSubstrate(convert.state_from_numpy(cols, device="cpu"),
                                 cfg, device="cpu"),
        convert.qnet_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu"),
        tdaemon.DaemonConfig(fused=True, **kw), clock=t_clock,
        timer=BreachTimer(2))
    t_log = []
    _spy_port(td, t_log)
    t_trace = tarrivals.arrival_trace(torch.Generator().manual_seed(0), cfg,
                                      N_REQUESTS, rate_per_s=500.0)
    _drive(td, t_clock, t_trace, fail_after=40)

    # an exact match of argmax decisions means something only without ties
    assert _min_gap(j_log) > TIE_TOL
    assert len(j_log) == len(t_log)
    for (jq, jok), (tq, tok) in zip(j_log, t_log):
        n_real = len(jq)             # the port's log keeps the pad rows
        np.testing.assert_array_equal(jok, tok[:n_real])
        np.testing.assert_allclose(tq[:n_real], jq, rtol=1e-5, atol=1e-5)

    assert td.decisions == jd.decisions
    jm, tm = jd.metrics, td.metrics
    for f in ("submitted", "bound", "dropped", "shed", "conflicts",
              "requeued", "evictions", "batches", "device_launches",
              "fallback_batches"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert tm.conflicts > 0 and tm.evictions > 0
    assert tm.fallback_batches >= 1
    assert tm.bound + tm.dropped + tm.shed == tm.submitted
    for f, jx, tx in zip(jenv.ClusterState._fields, jd._sub.live,
                         td._sub.live):
        assert np.asarray(tx).dtype == np.asarray(jx).dtype, f
        np.testing.assert_allclose(np.asarray(tx, np.float64),
                                   np.asarray(jx, np.float64),
                                   rtol=1e-5, atol=1e-5, err_msg=f)


def test_replay_trace_serves_everything():
    """Real-time replay on an auto-advancing clock: every request resolves
    and each batch is one scoring call."""
    cfg = fleet_cluster(64)
    gen = torch.Generator().manual_seed(1)
    state = tenv.reset(gen, cfg, device="cpu")
    from repro_torch.core import dqn

    params = dqn.init_qnet(gen, device="cpu")
    ticks = iter(np.arange(0, 1e6) * 1e-4)
    d = tdaemon.PlacementDaemon(
        tdaemon.ClusterSubstrate(state, cfg, device="cpu"), params,
        tdaemon.DaemonConfig(batch_size=8, max_wait_s=0.005, fused=True),
        clock=lambda: float(next(ticks)))
    d.warmup()
    trace = tarrivals.arrival_trace(gen, cfg, 40, rate_per_s=4000.0)
    tdaemon.replay_trace(d, trace.t_s, trace.pods)
    m = d.metrics
    assert m.bound + m.dropped == m.submitted == 40
    assert m.device_launches == m.batches


def test_replay_trace_applies_node_events():
    """A ``fail`` event mid-replay evicts the node's pods, which rebind
    elsewhere; ``recover`` makes it Ready again."""
    cfg = fleet_cluster(32)
    gen = torch.Generator().manual_seed(4)
    from repro_torch.core import dqn

    sub = tdaemon.ClusterSubstrate(tenv.reset(gen, cfg, device="cpu"), cfg,
                                   device="cpu")
    clock = FakeClock()
    d = tdaemon.PlacementDaemon(sub, dqn.init_qnet(gen, device="cpu"),
                                tdaemon.DaemonConfig(batch_size=4,
                                                     max_wait_s=0.0),
                                clock=clock)
    pods = [tenv.default_pod(cfg)] * 12
    t_s = np.arange(12) * 0.01
    d.submit(pods[0], now=0.0)
    d.flush()
    victim = d.decisions[0].node

    def tick():
        clock.t += 0.001
        return clock.t

    d._clock = tick
    tdaemon.replay_trace(d, t_s, pods, events=[(0.05, "fail", victim),
                                               (0.2, "recover", victim)])
    m = d.metrics
    assert m.evictions >= 1
    assert m.bound + m.dropped == m.submitted == 13 + m.evictions
    assert bool(sub.live.healthy[victim])
    with pytest.raises(ValueError, match="chaos event"):
        tdaemon.replay_trace(d, t_s[:1], pods[:1], events=[(0.0, "melt", 0)])


def test_host_pull_cost_matches_device():
    cfg = dataclasses.replace(fleet_cluster(500), randomize_workload=True)
    state = tenv.reset(torch.Generator().manual_seed(2), cfg, device="cpu")
    sub = tdaemon.ClusterSubstrate(state, cfg, device="cpu")
    host = tdaemon.host_pull_cost(sub.live, cfg)
    assert host.dtype == np.float32
    assert host == np.float32(tenv.pull_cost_now(state, cfg))
    assert host > cfg.image_pull_cost        # randomized starts pull in flight


@pytest.mark.parametrize("node", [0, 7, 15])
def test_bind_matches_reference_place(node):
    jcfg, cols = _cluster(5)
    jstate = jenv.ClusterState(**cols)
    cfg = fleet_cluster(N_NODES)
    sub = tdaemon.ClusterSubstrate(convert.state_from_numpy(cols, device="cpu"),
                                   dataclasses.replace(cfg), device="cpu")
    pod = tenv.default_pod(cfg)
    sub.bind(node, pod)
    want = jenv.place(jstate, node, jenv.default_pod(jcfg), jcfg)
    for f, got, ref in zip(jenv.ClusterState._fields, sub.live, want):
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(ref, np.float64),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("rate", [None, 500.0, 4000.0])
def test_arrival_trace_matches_reference(rate):
    jtr = jarrivals.arrival_trace(jax.random.PRNGKey(0), j_fleet_cluster(64),
                                  50, rate_per_s=rate)
    ttr = tarrivals.arrival_trace(torch.Generator().manual_seed(0),
                                  fleet_cluster(64), 50, rate_per_s=rate)
    np.testing.assert_allclose(ttr.t_s, jtr.t_s, rtol=1e-12)
    assert [tuple(p) for p in ttr.pods] == [tuple(p) for p in jtr.pods]
    assert ttr.offered_rate_per_s == pytest.approx(jtr.offered_rate_per_s)


def test_latency_reservoir_matches_reference():
    xs = np.random.default_rng(0).exponential(size=300)
    ours, ref = tdaemon.LatencyReservoir(64), jdaemon.LatencyReservoir(64)
    assert np.isnan(ours.p50())
    for x in xs:
        ours.append(float(x))
        ref.append(float(x))
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))
    assert ours.seen == ref.seen == 300 and len(ours) == 64
    assert ours.p99() == ref.p99()


@pytest.mark.parametrize("bad", [
    dict(batch_size=0), dict(conflict_policy="random"), dict(queue_cap=-1),
    dict(backoff_base_s=-1.0), dict(degrade_batches=-1), dict(fused="xla"),
])
def test_daemon_config_validation(bad):
    with pytest.raises(ValueError):
        tdaemon.DaemonConfig(**bad)


@pytest.mark.parametrize("kw", [dict(layout=object()), dict(policy=object()),
                                dict(score_fn=lambda p, f: f)])
def test_unported_substrate_options_raise(kw):
    """Layouts and registered policy classes are ported: what is not a
    FleetLayout or a registered PolicySpec is rejected.  A custom score_fn
    (the paper's LSTM baseline) is ported: the daemon over it decides as
    the reference's does on the same trace (a parity case of its own)."""
    cfg = fleet_cluster(8)
    state = tenv.reset(torch.Generator().manual_seed(0), cfg, device="cpu")
    if "layout" in kw:
        with pytest.raises(TypeError, match="FleetLayout"):
            tdaemon.ClusterSubstrate(state, cfg, device="cpu", **kw)
        return
    if "policy" in kw:
        with pytest.raises(TypeError, match="PolicySpec"):
            tdaemon.ClusterSubstrate(state, cfg, device="cpu", **kw)
        return
    with pytest.raises(ValueError, match="either"):
        tdaemon.ClusterSubstrate(state, cfg, device="cpu",
                                 policy=tpolicy.get("attention"), **kw)
    _score_fn_daemons_agree()


def _score_fn_daemons_agree():
    """Both daemons serve one trace with the LSTM scorer (reference params
    through ``convert``): identical decisions and live buffers."""
    from repro.core import baselines as jbase
    from repro_torch.core import baselines as tbase

    jcfg, cols = _cluster(4)
    jl = jbase.init_lstm(jax.random.PRNGKey(9))
    kw = dict(batch_size=8, max_wait_s=0.005)
    trace = jarrivals.arrival_trace(jax.random.PRNGKey(0), jcfg, N_REQUESTS,
                                    rate_per_s=500.0)
    j_clock, t_clock = FakeClock(), FakeClock()
    jd = jdaemon.PlacementDaemon(
        jdaemon.ClusterSubstrate(jenv.ClusterState(**cols), jcfg,
                                 score_fn=jbase.lstm_score), jl,
        jdaemon.DaemonConfig(**kw), clock=j_clock)
    j_log = []
    _spy_reference(jd, j_log)
    _drive(jd, j_clock, trace, fail_after=N_REQUESTS)
    cfg = dataclasses.replace(fleet_cluster(N_NODES), unhealthy_prob=0.1,
                              randomize_workload=True)
    td = tdaemon.PlacementDaemon(
        tdaemon.ClusterSubstrate(convert.state_from_numpy(cols, device="cpu"),
                                 cfg, device="cpu",
                                 score_fn=tbase.lstm_score),
        convert.baseline_params_from_numpy(jax.tree.map(np.asarray, jl),
                                           "lstm", device="cpu"),
        tdaemon.DaemonConfig(**kw), clock=t_clock)
    t_log = []
    _spy_port(td, t_log)
    _drive(td, t_clock, trace, fail_after=N_REQUESTS)
    assert _min_gap(j_log) > TIE_TOL
    assert td.decisions == jd.decisions
    assert td.metrics.bound > 0
    for f, jx, tx in zip(jenv.ClusterState._fields, jd._sub.live,
                         td._sub.live):
        np.testing.assert_allclose(np.asarray(tx, np.float64),
                                   np.asarray(jx, np.float64),
                                   rtol=1e-5, atol=1e-5, err_msg=f)


def test_entry_points_default_to_the_card():
    """``device=None`` means CUDA; without a card it raises, never runs on
    the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: device=None resolves to it")
    cfg = fleet_cluster(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tenv.reset(torch.Generator().manual_seed(0), cfg)
    state = tenv.reset(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdaemon.ClusterSubstrate(state, cfg)


def _port_files():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (
                f"{path.name}:{node.lineno} imports {name}")
