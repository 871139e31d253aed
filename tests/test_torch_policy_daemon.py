"""The port's placement daemon serving the attention and Mamba policy
classes, against the JAX reference daemon.

Both daemons serve the same numpy-made request stream over the same fleet
with the same params (made by the reference's ``init_*``) and injected
clocks, so they cut the same batches.  One batch is scored with NaN params:
both must degrade it to the heuristic and discard its scores AND its
history-carry advance.  The decision sequences must be identical (after
asserting that no scored row has two best candidates within 1e-5), the
metrics equal, and the Mamba carry after the run equal within 1e-5.  The
reference scans ``encode_step`` over each batch; the port encodes the
batch with one launch of kernel 6's plain version, pad rows with dt = 0.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import env as jenv, policy as jpol, types as jtypes
from repro.launch import mesh as jmesh
from repro.sched import daemon as jdaemon, placement as jpl
from repro_torch import convert
from repro_torch.core import dqn as tdqn, env as tenv, policy as tpol
from repro_torch.core import types as ttypes
from repro_torch.launch.mesh import plan_fleet_layout
from repro_torch.sched import daemon as tdaemon, placement as tpl
from torch_parity import FakeClock, drive, fleet_np, job_stream

N = 300
TIE_TOL = 1e-5
CLASSES = ("attention", "mamba")
NAN_BATCH = 2       # the batch scored with NaN params
DAEMON_KW = dict(batch_size=8, max_wait_s=0.005, max_retries=3,
                 degrade_batches=2)


def _params(name, seed):
    jp = jpol.get(name).init(jax.random.PRNGKey(seed))
    jbad = jax.tree.map(lambda x: jnp.full_like(x, jnp.nan), jp)
    tp, tbad = (convert.policy_params_from_numpy(jax.tree.map(np.asarray, p),
                                                 "cpu") for p in (jp, jbad))
    return jp, jbad, tp, tbad


def _spy(daemon, log, bad_params, reference):
    """Log every scored batch's real rows; score batch ``NAN_BATCH`` with
    ``bad_params``."""
    inner, calls = daemon._scorer, [0]

    def scorer(params, snap, pods, carry, n_real):
        if calls[0] == NAN_BATCH:
            params = bad_params
        calls[0] += 1
        a, b, c = inner(params, snap, pods, carry, n_real)
        log.append(tuple(np.asarray(x if reference else x.numpy())[:n_real]
                         for x in (a, b)))
        return a, b, c

    daemon._scorer = scorer


def _min_gap(log, candidates):
    """The smallest gap between the two best candidates of any finite
    scored row (flat rows masked by feasibility)."""
    gaps = [np.inf]
    for a, b in log:
        for row, other in zip(a, b):
            top = row[np.isfinite(row)] if candidates else row[other]
            if top.size > 1 and np.all(np.isfinite(top)):
                top = np.sort(top)[::-1]
                gaps.append(top[0] - top[1])
    return min(gaps)


def _assert_same_run(jd, j_log, td, t_log, candidates):
    assert _min_gap(j_log, candidates) > TIE_TOL
    assert len(j_log) == len(t_log) > NAN_BATCH + 1
    assert td.decisions == jd.decisions
    for f in ("submitted", "bound", "dropped", "conflicts", "requeued",
              "evictions", "batches", "device_launches", "fallback_batches"):
        assert getattr(td.metrics, f) == getattr(jd.metrics, f), f
    m = td.metrics
    assert m.conflicts > 0 and m.fallback_batches >= 1
    assert m.bound + m.dropped + m.shed == m.submitted
    if isinstance(jd._carry, tuple):            # stateless: ()
        assert td._carry is None
    else:
        assert bool(torch.isfinite(td._carry).all())   # the NaN batch's went
        np.testing.assert_allclose(td._carry.numpy(), np.asarray(jd._carry),
                                   rtol=1e-5, atol=1e-5)


def _requests(n, seed):
    """Arrival offsets at ~500/s and pods of varied demands (numpy)."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1 / 500.0, n))
    pods = np.c_[rng.uniform(50, 300, n), rng.uniform(20, 400, n),
                 rng.uniform(64, 512, n), rng.uniform(32, 400, n)]
    return t - t[0], [tuple(float(x) for x in p) for p in pods]


def _tight_cluster(seed):
    """Node i fits only k_i in 1..3 more default-size pods: collisions."""
    cfg = dataclasses.replace(jtypes.fleet_cluster(N), unhealthy_prob=0.1,
                              randomize_workload=True)
    cols = jax.tree.map(np.asarray,
                        jenv.reset(jax.random.PRNGKey(seed), cfg))._asdict()
    k = np.random.default_rng(seed).integers(1, 4, N)
    cols["cpu_requested"] = (cols["cpu_capacity"]
                             - np.float32(cfg.pod_cpu_request) * k
                             ).astype(np.float32)
    return cfg, cols


@pytest.mark.parametrize("name", CLASSES)
@pytest.mark.parametrize("conflict_policy", ["requeue", "next-best"])
@pytest.mark.parametrize("shards", [None, 4])
def test_cluster_daemon_matches_reference(name, conflict_policy, shards):
    jcfg, cols = _tight_cluster(seed=3)
    tcfg = dataclasses.replace(ttypes.fleet_cluster(N), unhealthy_prob=0.1,
                               randomize_workload=True)
    # params seeds whose runs keep every row's two best candidates apart
    jp, jbad, tp, tbad = _params(name, seed={"attention": 101,
                                             "mamba": 103}[name])
    kw = dict(DAEMON_KW, conflict_policy=conflict_policy)
    t_s, reqs = _requests(64, seed=1)
    jlay = None if shards is None else jmesh.plan_fleet_layout(N,
                                                               shards=shards)
    tlay = None if shards is None else plan_fleet_layout(N, shards=shards)

    jd = jdaemon.PlacementDaemon(
        jdaemon.ClusterSubstrate(jenv.ClusterState(**cols), jcfg,
                                 policy=jpol.get(name), layout=jlay),
        jp, jdaemon.DaemonConfig(**kw), clock=FakeClock())
    td = tdaemon.PlacementDaemon(
        tdaemon.ClusterSubstrate(convert.state_from_numpy(cols, "cpu"), tcfg,
                                 device="cpu", policy=tpol.get(name),
                                 layout=tlay),
        tp, tdaemon.DaemonConfig(**kw), clock=FakeClock())
    j_log, t_log = [], []
    _spy(jd, j_log, jbad, reference=True)
    _spy(td, t_log, tbad, reference=False)
    drive(jd, jd._clock, t_s, [jtypes.PodSpec(*r) for r in reqs], 40)
    drive(td, td._clock, t_s, [ttypes.PodSpec(*r) for r in reqs], 40)
    _assert_same_run(jd, j_log, td, t_log, candidates=shards is not None)


@pytest.mark.parametrize("name", CLASSES)
@pytest.mark.parametrize("shards", [None, 4])
def test_fleet_daemon_matches_reference(name, shards):
    cols = fleet_np(N, seed=13, tight=True)
    jp, jbad, tp, tbad = _params(name, seed=101)
    t_s, jobs = job_stream(64, seed=2)
    jlay = None if shards is None else jmesh.plan_fleet_layout(N,
                                                               shards=shards)
    tlay = None if shards is None else plan_fleet_layout(N, shards=shards)
    jd = jdaemon.PlacementDaemon(
        jdaemon.FleetSubstrate(jpl.FleetState(**{
            k: jnp.asarray(v) for k, v in cols.items()}),
            policy=jpol.get(name), layout=jlay),
        jp, jdaemon.DaemonConfig(**DAEMON_KW), clock=FakeClock())
    td = tdaemon.PlacementDaemon(
        tdaemon.FleetSubstrate(convert.fleet_from_numpy(cols, "cpu"),
                               policy=tpol.get(name), layout=tlay,
                               device="cpu"),
        tp, tdaemon.DaemonConfig(**DAEMON_KW), clock=FakeClock())
    j_log, t_log = [], []
    _spy(jd, j_log, jbad, reference=True)
    _spy(td, t_log, tbad, reference=False)
    drive(jd, jd._clock, t_s, [jpl.JobSpec(*j) for j in jobs], 30)
    drive(td, td._clock, t_s, [tpl.JobSpec(*j) for j in jobs], 30)
    _assert_same_run(jd, j_log, td, t_log, candidates=shards is not None)


def test_warmup_and_degraded_batches_leave_the_carry():
    """Warmup scores pad rows only; a NaN-scored batch degrades and its
    carry advance is discarded; a served batch advances the carry."""
    cfg = ttypes.fleet_cluster(64)
    gen = torch.Generator().manual_seed(0)
    state = tenv.reset(gen, cfg, device="cpu")
    spec = tpol.get("mamba")
    params = spec.init(gen, device="cpu")
    d = tdaemon.PlacementDaemon(
        tdaemon.ClusterSubstrate(state, cfg, device="cpu", policy=spec),
        params, tdaemon.DaemonConfig(batch_size=4, max_wait_s=0.0,
                                     degrade_batches=1), clock=FakeClock())
    zero = spec.carry_init(params)
    d.warmup()
    assert torch.equal(d._carry, zero)
    d._params = dict(params, enc=dict(params["enc"], dt_bias=torch.full(
        (tpol.MAMBA_DI,), float("nan"))))
    d.submit(tenv.default_pod(cfg), now=0.0)
    d.flush()
    assert d.metrics.fallback_batches == 1 and torch.equal(d._carry, zero)
    d._params = params        # degrade_batches=1 was the NaN batch itself
    d.submit(tenv.default_pod(cfg), now=0.0)
    d.flush()
    assert d.metrics.device_launches == 2 and d.metrics.fallback_batches == 1
    assert not torch.equal(d._carry, zero)
    assert d.metrics.bound + d.metrics.dropped == d.metrics.submitted == 2


@pytest.mark.parametrize("substrate", ["cluster", "fleet"])
def test_mlp_policy_serves_through_the_sdqn_kernels(substrate):
    """The "mlp" class is the Table-4 net: a substrate given it scores
    exactly as one given no policy, on the fused path, with no carry."""
    gen = torch.Generator().manual_seed(2)
    params = tdqn.init_qnet(gen, device="cpu")
    if substrate == "cluster":
        cfg = ttypes.fleet_cluster(40)
        state = tenv.reset(gen, cfg, device="cpu")

        def make(policy):
            return tdaemon.ClusterSubstrate(state, cfg, device="cpu",
                                            policy=policy)
        reqs = [tenv.default_pod(cfg)] * 5
    else:
        fleet = convert.fleet_from_numpy(fleet_np(40, seed=1), "cpu")

        def make(policy):
            return tdaemon.FleetSubstrate(fleet, policy=policy, device="cpu")
        reqs = [tpl.JobSpec(3.0, 1.0)] * 5
    runs = []
    for policy in (None, tpol.get("mlp")):
        d = tdaemon.PlacementDaemon(make(policy), params,
                                    tdaemon.DaemonConfig(batch_size=4,
                                                         fused=True),
                                    clock=FakeClock())
        assert d._carry is None
        for r in reqs:
            d.submit(r, now=0.0)
        d.drain()
        runs.append(d.decisions)
    assert runs[0] == runs[1]
