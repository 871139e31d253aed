"""Online learning in the port's serving path (``repro_torch.sched.online``,
the daemon's ``decision_hook`` and ``set_params``) against the JAX
reference (``repro.sched.online``), with the cases of its
``tests/test_online.py``.

The recorders' rings are held bit for bit to the reference's recorders
fed the same ``(pod, action)`` stream (the port daemon's own decisions,
a dropped arrival included), chunk by chunk, with the reference run op by
op (``jax.disable_jit``).  Jitted, XLA turns the divisions by the feature
scale into multiplications by reciprocals, one ulp away: against the
jitted reference the rings agree within 1e-6.  The serving invariants are
the reference's: one params read per batch cut, a refresher that
publishes its back buffer (and nothing on warmup), a recorder that
changes no decision and adds no scoring launch, and the ledger
``bound + dropped + shed == submitted`` with refresh cycles interleaved.
torch tensors are mutable, so the port adds one: a refresh step never
writes the front params the daemon serves with (nor does ``adam_update``
write anything in place).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import env as jenv, rewards as jrewards, types as jtypes
from repro.sched import online as jonline
from repro.sched.placement import JobSpec as JJob, fresh_fleet as jfresh
from repro_torch import convert
from repro_torch.core import dqn as tdqn, env as tenv, policy as tpol
from repro_torch.core import rewards as trewards, types as ttypes
from repro_torch.core.types import NO_PLACEMENT, PodSpec
from repro_torch.optim import adam_update, tree_leaves
from repro_torch.sched import online
from repro_torch.sched.daemon import (ClusterSubstrate, DaemonConfig,
                                      FleetSubstrate, PlacementDaemon)
from repro_torch.sched.placement import JobSpec

CFG_J, CFG_T = jtypes.paper_cluster(), ttypes.paper_cluster()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jstate():
    return jenv.reset(jax.random.PRNGKey(1), CFG_J)


@pytest.fixture()
def state(jstate):
    return convert.state_from_numpy(_np(jstate), "cpu")


@pytest.fixture(scope="module")
def qparams():
    return tdqn.init_qnet(torch.Generator().manual_seed(0), device="cpu")


def _pods(n, seed=7):
    table = jenv.sample_pod_table(jax.random.PRNGKey(seed), CFG_J, n)
    return [PodSpec(*(float(x[i]) for x in table.specs)) for i in range(n)]


OVERSIZED = PodSpec(1e9, 1e9, 1e9, 1e9)


def _daemon(state, params, hook=None, batch=4, **kw):
    sub = ClusterSubstrate(state, CFG_T, device="cpu")
    return sub, PlacementDaemon(sub, params, DaemonConfig(
        batch_size=batch, max_wait_s=0.0, **kw), decision_hook=hook)


def _same_ring(got, want, jitted=None):
    assert got.ptr == int(want.ptr) and got.size == int(want.size)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    if jitted is not None:
        np.testing.assert_allclose(got.data.numpy(), np.asarray(jitted.data),
                                   rtol=1e-6, atol=1e-7)


def _drain_both(rec, refs, max_chunks):
    """One drain of the port's recorder and of the reference's, op by op
    (``refs[0]``) and jitted (``refs[1]``)."""
    n = rec.drain(max_chunks=max_chunks)
    with jax.disable_jit():
        assert refs[0].drain(max_chunks=max_chunks) == n
    assert refs[1].drain(max_chunks=max_chunks) == n
    _same_ring(rec.buffer, refs[0].buffer, refs[1].buffer)


# ---------------------------------------------------------------------------
# the recorders' rings against the reference's
# ---------------------------------------------------------------------------


def test_recorder_ring_matches_reference_bit_for_bit(jstate, state, qparams):
    """A served daemon's recorder and the reference's recorder, fed the
    same stream in chunks of 8 (a weight-0 dropped row and a partial last
    chunk included): the same ring and shadow, bit for bit."""
    stream = []
    rec = online.TransitionRecorder(
        state, CFG_T, capacity=64, chunk=8, device="cpu",
        reward_fn=trewards.make_reward_fn("sdqn_n", efficiency_weight=50.0))

    def hook(pod, action):
        stream.append((pod, action))
        rec.record(pod, action)

    _, d = _daemon(state, qparams, hook)
    pods = _pods(20)
    pods.insert(5, OVERSIZED)                 # a drop -> a weight-0 row
    for pod in pods:
        d.submit(pod)
    d.drain()
    assert len(stream) == rec.pending == 21
    assert any(a == NO_PLACEMENT for _, a in stream)
    refs = [jonline.TransitionRecorder(
        jstate, CFG_J, capacity=64, chunk=8,
        reward_fn=jrewards.make_reward_fn("sdqn_n", efficiency_weight=50.0))
        for _ in range(2)]
    for ref in refs:
        for pod, a in stream:
            ref.record(jtypes.PodSpec(*(jnp.float32(x) for x in pod)), a)
    while rec.pending:
        _drain_both(rec, refs, 1)
    assert rec.buffer.size == 21
    for f, a, b in zip(jtypes.ClusterState._fields, rec._shadow,
                       refs[0]._shadow):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


def test_fleet_recorder_ring_matches_reference_bit_for_bit():
    jf = jfresh(6, jax.random.PRNGKey(2))
    tf = convert.fleet_from_numpy(_np(jf), "cpu")
    rec = online.FleetTransitionRecorder(tf, capacity=16, chunk=4,
                                         device="cpu")
    refs = [jonline.FleetTransitionRecorder(jf, capacity=16, chunk=4)
            for _ in range(2)]
    sub = FleetSubstrate(tf, device="cpu")
    d = PlacementDaemon(sub, tdqn.init_qnet(torch.Generator().manual_seed(1),
                                            device="cpu"),
                        DaemonConfig(batch_size=3, max_wait_s=0.0),
                        decision_hook=rec.record)
    jobs = [JobSpec(cpu_pct_demand=c) for c in (10.0, 30.0, 95.0, 20.0,
                                                 5.0, 40.0, 12.0)] * 3
    for job in jobs:
        d.submit(job)
    d.drain()
    stream = list(rec._pending)
    assert any(a == NO_PLACEMENT for _, a in stream)
    for ref in refs:
        for job, a in stream:
            ref.record(JJob(cpu_pct_demand=job.cpu_pct_demand), a)
    while rec.pending:
        _drain_both(rec, refs, 2)
    for a, b in zip(rec._shadow, refs[0]._shadow):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_recorder_warmup_is_a_bitwise_noop(state):
    for rec in (online.TransitionRecorder(state, CFG_T, capacity=32, chunk=8,
                                          device="cpu"),
                online.FleetTransitionRecorder(
                    convert.fleet_from_numpy(_np(jfresh(4)), "cpu"),
                    capacity=32, chunk=8, device="cpu")):
        rec.record(tenv.default_pod(CFG_T)
                   if isinstance(rec, online.TransitionRecorder)
                   else JobSpec(), 1)
        rec.drain()
        before = [x.clone() for x in (*rec._shadow, rec.buffer.data)]
        ptr = rec.buffer.ptr
        rec.warmup()
        after = [*rec._shadow, rec.buffer.data]
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        assert rec.buffer.ptr == ptr and rec.pending == 0


def test_recorder_bounded_drain(state):
    rec = online.TransitionRecorder(state, CFG_T, capacity=64, chunk=4,
                                    device="cpu")
    pod = tenv.default_pod(CFG_T)
    for _ in range(11):
        rec.record(pod, 0)
    assert rec.drain(max_chunks=2) == 8       # two chunks of 4
    assert rec.pending == 3
    assert rec.drain() == 3                   # the tail on the next cycle
    assert rec.drained == 11 and rec.buffer.size == 11
    assert online.DRAIN_CHUNK == jonline.DRAIN_CHUNK == 64


def test_resync_rebases_shadow_on_live(state, qparams):
    rec = online.TransitionRecorder(state, CFG_T, device="cpu")
    sub, d = _daemon(state, qparams, rec.record, batch=2)
    for pod in _pods(4):
        d.submit(pod)
    d.drain()
    sub.live.healthy[2] = False               # churn the stream never carried
    rec.resync(sub.live)
    assert rec.pending == 0 and rec.buffer.size == 4
    for a, b in zip(rec._shadow, sub.live):
        np.testing.assert_array_equal(a.numpy(), b)


# ---------------------------------------------------------------------------
# double-buffered params, swapped at batch cuts
# ---------------------------------------------------------------------------


def test_param_swap_is_atomic_at_batch_cuts(state, qparams):
    """A publish from inside a batch (the hook fires between its
    decisions) takes effect at the next cut, never within the batch."""
    p2 = tdqn.init_qnet(torch.Generator().manual_seed(9), device="cpu")
    _, d = _daemon(state, qparams, lambda pod, node: d.set_params(p2))
    real, seen = d._scorer, []

    def spy(params, snap, pods, carry, n):
        seen.append(params)
        return real(params, snap, pods, carry, n)

    d._scorer = spy
    pod = tenv.default_pod(CFG_T)
    for _ in range(4):
        d.submit(pod)
    d.flush()                                 # p2 published 4x mid-batch
    for _ in range(4):
        d.submit(pod)
    d.flush()
    assert len(seen) == 2, "one params read per batch"
    assert seen[0] is qparams, "a mid-batch publish leaked into its batch"
    assert seen[1] is p2, "the publish missed the next cut"


def test_refresher_publishes_back_buffer(state, qparams):
    rec = online.TransitionRecorder(state, CFG_T, device="cpu")
    _, d = _daemon(state, qparams, rec.record, batch=2)
    ref = online.OnlineRefresher(d, rec, batch_size=8, seed=3)
    assert ref.step() is None                 # empty ring: nothing to learn
    assert (ref.steps, ref.swaps) == (0, 0)
    for pod in _pods(4):
        d.submit(pod)
    d.drain()
    loss = ref.step()
    assert loss is not None and np.isfinite(loss)
    assert (ref.steps, ref.swaps) == (1, 1)
    assert d._params is ref.params and d._params is not qparams
    # the next batch scores with the published params
    real, seen = d._scorer, []
    d._scorer = lambda p, *a: (seen.append(p), real(p, *a))[1]
    d.submit(_pods(1, seed=3)[0])
    d.drain()
    assert seen == [ref.params]


def test_refresher_warmup_publishes_nothing(state, qparams):
    rec = online.TransitionRecorder(state, CFG_T, device="cpu")
    _, d = _daemon(state, qparams, rec.record, batch=2)
    ref = online.OnlineRefresher(d, rec)
    back, opt, gen = ref._back, ref._opt, ref._gen.get_state()
    ref.warmup()
    assert d._params is qparams and ref._back is back and ref._opt is opt
    assert torch.equal(ref._gen.get_state(), gen)
    assert ref.steps == 0 and rec.buffer.size == 0


def test_refresh_never_writes_the_front_params(state, qparams):
    """The front tree the daemon serves with keeps its values and its
    tensors' version counters through refresh steps."""
    front = {k: v.clone() for k, v in qparams.items()}
    rec = online.TransitionRecorder(state, CFG_T, device="cpu")
    _, d = _daemon(state, front, rec.record, batch=2)
    ref = online.OnlineRefresher(d, rec, batch_size=8)
    versions = {k: v._version for k, v in front.items()}
    for pod in _pods(6):
        d.submit(pod)
    d.drain()
    for _ in range(3):
        ref.step()
    assert d._params is ref.params and d._params is not front
    for k, v in front.items():
        assert torch.equal(v, qparams[k]), k
        assert v._version == versions[k], k
    assert all(not torch.equal(ref.params[k], front[k]) for k in front)


def test_adam_update_writes_nothing_in_place():
    gen = torch.Generator().manual_seed(0)
    spec = tpol.get("mlp")
    params = spec.init(gen, device="cpu")
    opt = tpol.make_opt_state(params)
    grads = {k: torch.randn(v.shape, generator=gen) for k, v in params.items()}
    trees = (params, grads, opt["m"], opt["v"])
    snap = [[x.clone() for x in tree_leaves(t)] for t in trees]
    vers = [[x._version for x in tree_leaves(t)] for t in trees]
    step = opt["step"].clone()
    new_params, new_opt, _ = adam_update(params, grads, opt, tpol.ADAM)
    for t, s, v in zip(trees, snap, vers):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(t), s))
        assert [x._version for x in tree_leaves(t)] == v
    assert torch.equal(opt["step"], step)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(
        tree_leaves(new_params), tree_leaves(params)))
    # the learner step on top of it, too
    step_fn = tpol.make_train_step(spec)
    feats = torch.ones(4, 6)
    p2, _, loss, _ = step_fn(params, opt, feats, torch.ones(4),
                             torch.ones(4))
    assert np.isfinite(float(loss))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 snap[0]))


# ---------------------------------------------------------------------------
# the serving path with the online plumbing attached
# ---------------------------------------------------------------------------


def test_refresher_disabled_is_bit_identical(state, qparams):
    """A daemon with a recorder and a warmed, never-stepped refresher
    serves the decisions of a bare daemon, with as many scoring launches
    (the recorder adds none)."""

    def run(with_online):
        rec = (online.TransitionRecorder(state, CFG_T, device="cpu")
               if with_online else None)
        sub, d = _daemon(state, qparams, rec.record if rec else None)
        calls = []
        real = d._scorer
        d._scorer = lambda *a: (calls.append(1), real(*a))[1]
        if with_online:
            online.OnlineRefresher(d, rec).warmup()
        for pod in _pods(16, seed=11):
            d.submit(pod)
        d.drain()
        if rec is not None:
            assert rec.recorded == len(d.decisions)
        return ([(x.req_id, x.node) for x in d.decisions], sub.live,
                len(calls), d.metrics.device_launches)

    bare, with_rec = run(False), run(True)
    assert bare[0] == with_rec[0]
    for a, b in zip(bare[1], with_rec[1]):
        np.testing.assert_array_equal(a, b)
    assert bare[2:] == with_rec[2:] and bare[2] == bare[3] > 0


@pytest.mark.parametrize("seed,ops", [
    (0, [("submit", 0.2), ("submit", 1.4), ("flush", 0.0), ("submit", 0.3),
         ("advance", 0.06), ("flush", 0.0)]),
    (3, [("submit", 0.2)] * 9 + [("flush", 0.0), ("submit", 0.4),
                                 ("flush", 0.0)]),
    (7, [("submit", 0.25), ("advance", 0.06)] * 6)])
def test_online_ledger_conservation(seed, ops):
    """bound + dropped + shed == submitted with a refresh cycle after
    every other op; shed requests never reach the recorder."""
    js = jenv.reset(jax.random.PRNGKey(seed), CFG_J)
    st = convert.state_from_numpy(_np(js), "cpu")
    sub = ClusterSubstrate(st, CFG_T, device="cpu")
    rec = online.TransitionRecorder(st, CFG_T, capacity=64, chunk=4,
                                    device="cpu")
    t = [0.0]
    d = PlacementDaemon(
        sub, tdqn.init_qnet(torch.Generator().manual_seed(0), device="cpu"),
        DaemonConfig(batch_size=3, max_wait_s=0.05, max_retries=2,
                     queue_cap=5),
        clock=lambda: t[0], decision_hook=rec.record)
    ref = online.OnlineRefresher(d, rec, batch_size=8,
                                 drain_chunks_per_step=1)
    cap = float(np.min(sub.live.cpu_capacity))
    mem_cap = float(np.min(sub.live.mem_capacity))
    for i, (op, arg) in enumerate(ops):
        if op == "submit":
            d.submit(PodSpec(arg * cap, 0.5 * arg * cap, arg * mem_cap,
                             0.2 * arg * mem_cap))
        elif op == "advance":
            t[0] += arg
            d.poll()
        elif op == "flush":
            d.flush()
        if i % 2 == 1:
            ref.step()
    d.drain()
    ref.step()
    m = d.metrics
    assert m.bound + m.dropped + m.shed == m.submitted
    assert len(d.decisions) == m.submitted
    assert rec.recorded == m.bound + m.dropped
    rec.drain()
    assert rec.drained == rec.recorded
    assert rec.buffer.size == min(rec.recorded, 64)


def test_refresher_thread_starts_and_stops(state, qparams):
    rec = online.TransitionRecorder(state, CFG_T, device="cpu")
    _, d = _daemon(state, qparams, rec.record, batch=2)
    for pod in _pods(4):
        d.submit(pod)
    d.drain()
    ref = online.OnlineRefresher(d, rec, batch_size=4, min_interval_s=0.001)
    ref.start()
    ref.start()                               # idempotent
    import time
    deadline = time.monotonic() + 10.0
    while ref.steps == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    ref.stop()
    ref.stop()
    assert ref.steps > 0 and d._params is ref.params
