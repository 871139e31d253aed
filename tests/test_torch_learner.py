"""The port's stateless learner modules against the JAX reference on
identical inputs: Adam (``optim/adam.py``), the MSE loss and its
gradients (``core/dqn.py``, ``core/policy.py``), the Table 3/5 rewards
(``core/rewards.py``), the fused replay ring (``core/replay.py``), the
episode primitives and loop of ``core/env.py`` under fixed action traces,
and the kube-scheduler and epsilon-greedy selections on given draws.

Inputs are made with numpy from fixed seeds (the shapes of
``tests/strategies.py``'s action traces and pod events, drawn here without
hypothesis) or by the reference from a ``PRNGKey``, and carried across
with ``repro_torch.convert``.  Tolerances: the Adam step, the loss and its
gradients 1e-6 (``tests/test_train_engine.py``'s trainer tolerance);
rewards, states and features 1e-5 relative (float32 rounding of the same
arithmetic); replay contents, actions and selections bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase, dqn as jdqn, env as jenv
from repro.core import policy as jpol, replay as jrep, rewards as jrew
from repro.core import schedulers as jsched, types as jtypes
from repro.optim import adam as jadam
from repro_torch import convert
from repro_torch.core import baselines as tbase, dqn as tdqn, env as tenv
from repro_torch.core import policy as tpol, replay as trep, rewards as trew
from repro_torch.core import schedulers as tsched, types as ttypes
from repro_torch.core.draws import ArrayDraws
from repro_torch.optim import adam as tadam

STEP_TOL = 1e-6
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
ADAM_CONFIGS = {
    "paper": (jdqn.ADAM, tdqn.ADAM),
    "master": (jadam.AdamConfig(), tadam.AdamConfig()),
    "clip-decay": (jadam.AdamConfig(grad_clip_norm=0.5, weight_decay=0.01),
                   tadam.AdamConfig(grad_clip_norm=0.5, weight_decay=0.01)),
    "bf16-moments": (jadam.AdamConfig(moment_dtype="bfloat16"),
                     tadam.AdamConfig(moment_dtype="bfloat16")),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return convert.lm_params_from_numpy(_np(tree), device="cpu")


def _close(got, want, tol=STEP_TOL):
    np.testing.assert_allclose(
        np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                   np.float64),
        np.asarray(np.asarray(want, np.float32), np.float64),
        rtol=tol, atol=tol)


def _close_tree(got, want, tol=STEP_TOL):
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for p in path:
            g = g[p.key]
        _close(g, w, tol)


def _grads_like(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(rng.normal(0, 2.0, p.shape), p.dtype), params)


# ---------------------------------------------------------------------------
# Adam
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(ADAM_CONFIGS))
def test_adam_steps_match_reference(name):
    jcfg, tcfg = ADAM_CONFIGS[name]
    jp = jdqn.init_qnet(jax.random.PRNGKey(0))
    js = jadam.adam_init(jp, jcfg)
    tp = _t(jp)
    ts = tadam.adam_init(tp, tcfg)
    assert set(ts) == set(js)
    for step in range(3):          # bias correction past the first step
        g = _grads_like(jp, step)
        jp, js, jstats = jadam.adam_update(jp, g, js, jcfg)
        tp, ts, tstats = tadam.adam_update(tp, _t(g), ts, tcfg)
        _close_tree(tp, jp)
        _close_tree(ts["m"], js["m"])
        _close_tree(ts["v"], js["v"])
        if "master" in js:
            _close_tree(ts["master"], js["master"])
        assert int(ts["step"]) == int(js["step"])
        _close(tstats["grad_norm"], jstats["grad_norm"], 1e-5)


def test_adam_per_seed_clip_matches_vmapped_reference():
    """Three seeds side by side: each clipped by its OWN global norm."""
    jcfg, tcfg = ADAM_CONFIGS["clip-decay"]
    keys = jnp.stack([jax.random.PRNGKey(s) for s in range(3)])
    jp = jax.vmap(jdqn.init_qnet)(keys)
    js = jax.vmap(lambda p: jadam.adam_init(p, jcfg))(jp)
    tp = _t(jp)
    ts = tadam.adam_init(tp, tcfg)
    for step in range(2):
        g = _grads_like(jp, 10 + step)
        g = jax.tree.map(lambda x: x * jnp.asarray([0.01, 1.0, 30.0]).reshape(
            (3,) + (1,) * (x.ndim - 1)), g)        # one seed under the clip
        jp, js, jstats = jax.jit(jax.vmap(
            lambda p, gg, s: jadam.adam_update(p, gg, s, jcfg)))(jp, g, js)
        tp, ts, tstats = tadam.adam_update(tp, _t(g), ts, tcfg, seeds=True)
        _close_tree(tp, jp)
        _close(tstats["grad_norm"], jstats["grad_norm"], 1e-5)
    assert tadam.global_norm(tp, seeds=True).shape == (3,)


# ---------------------------------------------------------------------------
# the Table-4 loss and its gradients
# ---------------------------------------------------------------------------


def _batch(f, n=64, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.uniform(-0.5, 1.5, (n, f)).astype(np.float32)
    targets = rng.normal(0.5, 1.0, n).astype(np.float32)
    weights = (rng.random(n) > 0.2).astype(np.float32)
    return feats, targets, weights


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["mlp", "attention", "mamba"])
def test_mse_loss_and_grads_match_reference(name, weighted):
    jspec, tspec = jpol.get(name), tpol.get(name)
    jp = jspec.init(jax.random.PRNGKey(4))
    feats, targets, weights = _batch(jspec.feature_dim)
    w = weights if weighted else None
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jpol.mse_loss(jspec, p, feats, targets, w)))(jp)
    tp = _t(jp)
    tw = torch.tensor(weights) if weighted else None
    live = tadam.tree_map(lambda x: x.clone().requires_grad_(True), tp)
    tl = tpol.mse_loss(tspec, live, torch.tensor(feats),
                       torch.tensor(targets), tw)
    leaves = tadam.tree_leaves(live)
    tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    _close(tl, loss)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, tg))
    _close_tree(tadam.tree_map(lambda _: next(it), tp), grads)
    if name == "mlp":
        _close(tdqn.mse_loss(tp, torch.tensor(feats), torch.tensor(targets),
                             tw), jdqn.mse_loss(jp, feats, targets, w))


@pytest.mark.parametrize("name", ["mlp", "attention", "mamba"])
def test_train_step_per_seed_matches_vmapped_reference(name):
    """``make_train_step`` on 2 stacked seeds == the reference vmapped: the
    summed loss gives each seed its own gradients."""
    jspec, tspec = jpol.get(name), tpol.get(name)
    keys = jnp.stack([jax.random.PRNGKey(s) for s in (5, 6)])
    jp = jax.vmap(jspec.init)(keys)
    js = jax.vmap(lambda p: jadam.adam_init(p, jpol.ADAM))(jp)
    data = [_batch(jspec.feature_dim, 32, s) for s in (1, 2)]
    feats, targets, weights = (np.stack(x) for x in zip(*data))
    step = jpol.make_train_step(jspec)
    jp2, js2, jloss, _ = jax.jit(jax.vmap(step))(jp, js, feats, targets,
                                                 weights)
    tp = _t(jp)
    tp2, ts2, tloss, _ = tpol.make_train_step(tspec)(
        tp, tpol.make_opt_state(tp), torch.tensor(feats),
        torch.tensor(targets), torch.tensor(weights))
    _close(tloss, jloss)
    _close_tree(tp2, jp2)
    _close_tree(ts2["m"], js2["m"])
    if name == "mlp":
        tp3, _, tl3, _ = tdqn.train_step(tp, tpol.make_opt_state(tp),
                                         torch.tensor(feats),
                                         torch.tensor(targets),
                                         torch.tensor(weights))
        _close(tl3, jloss)
        _close_tree(tp3, jp2)


def test_init_train_state_shapes_match_reference():
    for name in ("mlp", "attention", "mamba"):
        jp, js = jpol.init_train_state(jpol.get(name), jax.random.PRNGKey(0))
        tp, ts = tpol.init_train_state(tpol.get(name),
                                       torch.Generator().manual_seed(0),
                                       device="cpu")
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jp),
                                [None] * 0 or _leaves_by_path(tp, jp)):
            assert tuple(g.shape) == w.shape, path
        assert set(ts) == set(js) and int(ts["step"]) == 0
    tp, ts = tdqn.init_train_state(torch.Generator().manual_seed(0), "cpu")
    assert "master" not in ts and tdqn.ADAM.lr == jdqn.ADAM.lr


def _leaves_by_path(tree, like):
    out = []
    for path, _ in jax.tree_util.tree_leaves_with_path(like):
        g = tree
        for p in path:
            g = g[p.key]
        out.append(g)
    return out


# ---------------------------------------------------------------------------
# rewards (Tables 3 and 5)
# ---------------------------------------------------------------------------


def _reward_inputs(b=24, n=4, seed=0):
    """(before, after) feature rows, feasible masks, actions and pod
    counts that reach every band of Tables 3/5: CPU and memory below 40%,
    in the band and above 70%, unhealthy nodes, the pod-utilization band,
    young and old nodes, ties in the running pods, masks with fewer
    candidates than n, and dropped actions."""
    rng = np.random.default_rng(seed)
    before = np.stack([
        rng.uniform(5.0, 95.0, (b, n)),           # cpu %
        rng.uniform(5.0, 95.0, (b, n)),           # mem %
        rng.uniform(30.0, 100.0, (b, n)),         # pod util %
        (rng.random((b, n)) > 0.15).astype(float),
        rng.uniform(1.0, 48.0, (b, n)),           # uptime h
        rng.integers(0, 3, (b, n)).astype(float),  # exp pods (ties)
    ], axis=-1).astype(np.float32)
    action = rng.integers(-1, n, b).astype(np.int32)
    after = before.copy()
    for i, a in enumerate(action):
        if a >= 0:
            after[i, a, 0] += 3.5
            after[i, a, 5] += 1.0
    ok = rng.random((b, n)) > 0.35
    ok[0] = [True, False, False, False]            # fewer than n candidates
    return before, after, ok, action


def test_node_points_and_rewards_match_reference():
    before, after, ok, action = _reward_inputs()
    tb, ta, tok = (torch.tensor(x) for x in (before, after, ok))
    ta_act = torch.tensor(action)
    exp_b, exp_a = before[..., 5].astype(np.int32), after[..., 5].astype(np.int32)
    _close(trew.node_points(ta),
           jax.jit(jax.vmap(jax.vmap(jrew.node_points)))(after), 1e-5)
    for w in (0.0, 5.0):
        want = jax.jit(jax.vmap(lambda af, a, e, bf: jrew.sdqn_reward(
            af, a, exp_pods=e, efficiency_weight=w, before_feats=bf)))(
                after, action, exp_a, before)
        _close(trew.sdqn_reward(ta, ta_act, torch.tensor(exp_a), w, tb), want,
               1e-5)
        want = jax.jit(jax.vmap(lambda af, bf, m, a, e: jrew.sdqn_n_reward(
            af, bf, m, a, 2, exp_pods_before=e, efficiency_weight=w)))(
                after, before, ok, action, exp_b)
        _close(trew.sdqn_n_reward(ta, tb, tok, ta_act, 2,
                                  torch.tensor(exp_b), w), want, 1e-5)
    want = jax.jit(jax.vmap(jrew.sdqn_reward))(after, action)
    _close(trew.sdqn_reward(ta, ta_act), want, 1e-5)
    _close(trew.energy_term(torch.tensor(exp_b), torch.tensor(exp_a)),
           jax.vmap(jrew.energy_term)(exp_b, exp_a))


@pytest.mark.parametrize("variant", ["sdqn", "sdqn_n"])
@pytest.mark.parametrize("energy", [0.0, 15.0])
def test_make_reward_fn_matches_reference(variant, energy):
    before, after, ok, action = _reward_inputs(seed=3)
    exp_b, exp_a = before[..., 5].astype(np.int32), after[..., 5].astype(np.int32)
    jfn = jrew.make_reward_fn(variant, 2, 10.0, energy)
    tfn = trew.make_reward_fn(variant, 2, 10.0, energy)
    want = jax.jit(jax.vmap(jfn))(after, before, ok, action, exp_b, exp_a)
    got = tfn(*(torch.tensor(x) for x in (after, before, ok, action, exp_b,
                                          exp_a)))
    _close(got, want, 1e-5)


def test_make_reward_fn_rejects_what_the_reference_rejects():
    for bad in (True, torch.tensor(1.0), np.float32(1.0), "1"):
        with pytest.raises(TypeError):
            trew.make_reward_fn(energy_weight=bad)
        with pytest.raises(TypeError):
            jrew.make_reward_fn(energy_weight=bad)
    with pytest.raises(ValueError, match=">= 0"):
        trew.make_reward_fn(energy_weight=-1.0)
    with pytest.raises(ValueError, match="variant"):
        trew.make_reward_fn("greedy")


# ---------------------------------------------------------------------------
# the fused replay ring
# ---------------------------------------------------------------------------


def _rows(b, f=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, f)).astype(np.float32),
            rng.normal(size=b).astype(np.float32),
            (rng.random(b) > 0.3).astype(np.float32))


def _same_ring(t: trep.Replay, j: jrep.Replay):
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    assert (t.ptr, t.size) == (int(j.ptr), int(j.size))


@pytest.mark.parametrize("case", ["lane-slot", "lane-wide", "lane1",
                                  "wider-than-ring", "n_valid"])
def test_replay_add_matches_reference_bit_for_bit(case):
    cap, lane = (12, 3) if case.startswith("lane-") else (10, 1)
    widths = {"lane-slot": [3] * 7, "lane-wide": [6, 3, 6, 6],
              "lane1": [1, 4, 7, 2, 5], "wider-than-ring": [3, 23, 4],
              "n_valid": [6, 6, 6]}[case]
    jb = jrep.replay_init(cap, lane=lane)
    tb = trep.replay_init(cap, lane=lane, device="cpu")
    for i, b in enumerate(widths):
        f, y, w = _rows(b, seed=i)
        nv = {"n_valid": [2, 6, 0][i % 3]}.get(case)
        jb = jrep.replay_add(jb, jnp.asarray(f), jnp.asarray(y),
                             jnp.asarray(w),
                             n_valid=None if nv is None else jnp.int32(nv))
        tb = trep.replay_add(tb, torch.tensor(f), torch.tensor(y),
                             torch.tensor(w), n_valid=nv)
        _same_ring(tb, jb)
    for view in ("feats", "targets", "weights"):
        np.testing.assert_array_equal(getattr(tb, view).numpy(),
                                      np.asarray(getattr(jb, view)))


def test_replay_add_refuses_what_the_reference_refuses():
    tb = trep.replay_init(12, lane=3, device="cpu")
    f, y, w = _rows(4)
    with pytest.raises(ValueError, match="multiples of the lane"):
        trep.replay_add(tb, torch.tensor(f), torch.tensor(y))
    with pytest.raises(ValueError, match="lane-1"):
        trep.replay_add(tb, torch.tensor(f[:3]), torch.tensor(y[:3]),
                        n_valid=1)
    with pytest.raises(ValueError, match="must divide"):
        trep.replay_init(10, lane=3, device="cpu")
    with pytest.raises(ValueError, match="exceeds capacity"):
        big = _rows(14)
        trep.replay_add(trep.replay_init(10, device="cpu"),
                        torch.tensor(big[0]), torch.tensor(big[1]),
                        n_valid=3)


@pytest.mark.parametrize("n_adds", [0, 1, 5])
def test_replay_sample_on_given_indices_matches_reference(n_adds):
    jb = jrep.replay_init(16, lane=4)
    tb = trep.replay_init(16, lane=4, device="cpu")
    for i in range(n_adds):
        f, y, w = _rows(4, seed=20 + i)
        jb = jrep.replay_add(jb, jnp.asarray(f), jnp.asarray(y), jnp.asarray(w))
        tb = trep.replay_add(tb, torch.tensor(f), torch.tensor(y),
                             torch.tensor(w))
    key = jax.random.PRNGKey(n_adds)
    idx = jax.random.randint(key, (9,), 0, jnp.maximum(jb.size, 1))
    want = jrep.replay_sample(jb, key, 9)
    got = trep.replay_sample(tb, torch.tensor(np.asarray(idx)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # one ring per seed: the same rows from each seed's own ring
    two = trep.Replay(torch.stack([tb.data, tb.data + 1.0]), tb.ptr, tb.size)
    both = trep.replay_sample(two, torch.tensor(np.stack([idx, idx])))
    np.testing.assert_array_equal(both[0][1].numpy(), got[0].numpy() + 1.0)


# ---------------------------------------------------------------------------
# the episode primitives under fixed action traces
# ---------------------------------------------------------------------------


def _pair(n=4, seed=0, **kw):
    jcfg = dataclasses.replace(jtypes.fleet_cluster(n), **kw)
    tcfg = dataclasses.replace(ttypes.fleet_cluster(n), **kw)
    js = jenv.reset(jax.random.PRNGKey(seed), jcfg)
    ts = convert.state_from_numpy(_np(js), device="cpu")
    return js, ts, jcfg, tcfg


def _same_state(t, j, tol=STATE_TOL):
    for f, g, w in zip(ttypes.ClusterState._fields, t, j):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), err_msg=f, **tol)


def _trace(seed, n_pods, n_nodes, drops=True):
    """An action trace as ``strategies.action_traces`` draws them, with
    drop sentinels mixed in."""
    rng = np.random.default_rng(seed)
    return rng.integers(-1 if drops else 0, n_nodes, n_pods).astype(np.int32)


@functools.partial(jax.jit, static_argnums=(3,))
def _reference_step(js, a, dt, cfg):
    """One arrival of the reference: the afterstate row of node max(a, 0),
    the pull cost, the bind, the tick and the energy readings."""
    pod = jenv.default_pod(cfg)
    row = jenv.hypothetical_place_one(js, pod, cfg, jnp.maximum(a, 0))
    pull = jenv.pull_cost_now(js, cfg)
    js = jenv.tick(jenv.place(js, a, pod, cfg), cfg, dt)
    return (row, pull, js, jenv.average_cpu_utilization(js, cfg),
            jenv.fleet_power_w(js, cfg), jenv.nodes_active(js))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_place_tick_and_afterstates_follow_a_trace(seed):
    js, ts, jcfg, tcfg = _pair(6, seed, randomize_workload=True)
    pod_t = tenv.default_pod(tcfg)
    rng = np.random.default_rng(seed)
    for a in _trace(seed, 12, 6):
        dt = np.float32(rng.choice([2.0, 0.7, 5.3]))
        row, pull, js, cpu, watts, active = _reference_step(
            js, jnp.int32(a), jnp.float32(dt), jcfg)
        _close(tenv.hypothetical_place_one(ts, pod_t, tcfg,
                                           torch.tensor(max(int(a), 0))),
               row, 1e-5)
        _close(tenv.pull_cost_now(ts, tcfg), pull)
        ts = tenv.tick(tenv.place(ts, torch.tensor(a), pod_t, tcfg), tcfg,
                       torch.tensor(dt))
        _same_state(ts, js)
        _close(tenv.average_cpu_utilization(ts, tcfg), cpu, 1e-5)
        _close(tenv.fleet_power_w(ts, tcfg), watts, 1e-5)
        assert int(tenv.nodes_active(ts)) == int(active)


def test_batched_bind_equals_one_cluster_at_a_time():
    """(3, 2) clusters bound at once, a drop among them, == each alone."""
    tcfg = dataclasses.replace(ttypes.fleet_cluster(5), randomize_workload=True)
    ts = tenv.reset(torch.Generator().manual_seed(3), tcfg, device="cpu")
    batch = ttypes.ClusterState(*(x.expand((3, 2) + x.shape).clone()
                                  for x in ts))
    actions = torch.tensor([[0, 4], [-1, 2], [3, 3]])
    got = tenv.place(batch, actions, tenv.default_pod(tcfg), tcfg)
    for i in range(3):
        for k in range(2):
            one = tenv.place(ts, int(actions[i, k]), tenv.default_pod(tcfg),
                             tcfg)
            for f, g, w in zip(ttypes.ClusterState._fields, got, one):
                torch.testing.assert_close(g[i, k], w, rtol=0, atol=0,
                                           msg=f)
    pull = tenv.pull_cost_now(batch, tcfg)
    assert pull.shape == (3, 2)
    torch.testing.assert_close(pull[1, 1], tenv.pull_cost_now(ts, tcfg))


def _events(seed, n_events, n_nodes):
    """Pod events as ``strategies.pod_events`` draws them: (node,
    lifetime_s, advance_s)."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, n_nodes)), float(rng.uniform(0.5, 600.0)),
             float(rng.uniform(0.0, 120.0))) for _ in range(n_events)]


@functools.partial(jax.jit, static_argnums=(6,))
def _reference_event(js, jl, slot, node, life, adv, cfg):
    pod = jenv.default_pod(cfg)
    js = jenv.place(js, node, pod, cfg)
    jl = jenv.ledger_record(jl, slot, node, js.time_s + life, pod)
    return jenv.retire_expired(jenv.tick(js, cfg, adv), jl)


@pytest.mark.parametrize("seed", [0, 1])
def test_ledger_trio_follows_pod_events(seed):
    js, ts, jcfg, tcfg = _pair(4, seed)
    events = _events(seed, 16, 4)
    jl, tl = jenv.ledger_init(len(events)), tenv.ledger_init(len(events),
                                                             device="cpu")
    pod_t = tenv.default_pod(tcfg)
    for slot, (node, life, adv) in enumerate(events):
        node = -1 if slot % 7 == 3 else node         # a dropped arrival
        life, adv = np.float32(life), np.float32(adv)
        js, jl, jn = _reference_event(js, jl, jnp.int32(slot),
                                      jnp.int32(node), jnp.float32(life),
                                      jnp.float32(adv), jcfg)
        ts = tenv.place(ts, torch.tensor(node), pod_t, tcfg)
        tl = tenv.ledger_record(tl, slot, torch.tensor(node),
                                ts.time_s + float(life), pod_t)
        ts = tenv.tick(ts, tcfg, torch.tensor(adv))
        ts, tl, tn = tenv.retire_expired(ts, tl)
        assert int(tn) == int(jn)
        _same_state(ts, js)
        np.testing.assert_array_equal(tl.node.numpy(), np.asarray(jl.node))
        _close(tl.expiry_s, jl.expiry_s, 1e-5)


def _reference_trace_episode(key, cfg, trace, table):
    """The reference's ``run_episode`` driven by a fixed action trace (a
    step counter rides the selector carry), with a supplied pod table, so
    its ledger records and retires."""
    def select(k, state, pod, i):
        return trace[i], i + 1

    return jenv.run_episode(key, cfg, select, trace.shape[0], pod_table=table,
                            select_carry=jnp.int32(0))


@pytest.mark.parametrize("finite", [False, True])
def test_run_episode_follows_fixed_traces(finite):
    """Three trials, each its own reset and trace (drops included), with
    infinite or finite lifetimes, in one batched episode of the port."""
    jcfg, tcfg = jtypes.paper_cluster(), ttypes.paper_cluster()
    n_pods, trials = 20, 3
    keys = jnp.stack([jax.random.PRNGKey(40 + t) for t in range(trials)])
    traces = np.stack([_trace(t, n_pods, 4) for t in range(trials)])
    rng = np.random.default_rng(9)
    life = (rng.uniform(5.0, 60.0, (trials, n_pods)) if finite
            else np.full((trials, n_pods), np.inf)).astype(np.float32)
    base = jenv.sample_pod_table(jax.random.PRNGKey(0), jcfg, n_pods)

    def table(lt):
        return base._replace(lifetime_s=lt)

    want = jax.jit(jax.vmap(lambda k, tr, lt: _reference_trace_episode(
        k, jcfg, tr, table(lt))))(keys, jnp.asarray(traces), jnp.asarray(life))
    resets = jax.vmap(lambda k: jenv.reset(jax.random.split(k, 3)[0], jcfg))(
        keys)
    tables = jax.tree.map(lambda x: np.broadcast_to(
        np.asarray(x), (trials, n_pods))[None], table(jnp.asarray(life)))
    draws = ArrayDraws(reset=jtypes.ClusterState(*(np.asarray(x)[None]
                                                   for x in resets)),
                       pod_tables=tables, device="cpu")
    tr = torch.tensor(traces)

    def select(step, state, pod, i):
        return tr[:, int(i[0])], i + 1

    got = tenv.run_episode(draws, tcfg, select, n_pods,
                           select_carry=torch.zeros((), dtype=torch.int32),
                           device="cpu")
    _same_state(got.state, want.state)
    np.testing.assert_array_equal(got.placements.numpy(),
                                  np.asarray(want.placements))
    _close(got.metric, want.metric, 1e-5)
    assert got.dropped.tolist() == np.asarray(want.dropped).tolist()
    for f in ("nodes_active_mean", "node_seconds", "energy_wh"):
        _close(getattr(got.stats, f), getattr(want.stats, f), 1e-5)
    for f in ("nodes_active_final", "nodes_active_peak", "retired"):
        assert (getattr(got.stats, f).tolist()
                == np.asarray(getattr(want.stats, f)).tolist()), f
    if finite:
        assert int(got.stats.retired.sum()) > 0


# ---------------------------------------------------------------------------
# selections on given draws
# ---------------------------------------------------------------------------


class _Step:
    """One arrival's draws, given as arrays."""

    def __init__(self, u=None, noise=None, tiebreak=None):
        self._u, self._noise, self._tie = u, noise, tiebreak

    def explore(self):
        return self._u

    def noise(self, n):
        return self._noise

    def tiebreak(self, n):
        return self._tie


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_kube_select_matches_reference_on_given_draws(seed):
    js, ts, jcfg, tcfg = _pair(6, seed, unhealthy_prob=0.2)
    if seed % 2:      # identical nodes: every score ties, the draw decides
        js = jax.tree.map(lambda x: jnp.broadcast_to(x[..., :1], x.shape)
                          if x.ndim else x, js)
        ts = convert.state_from_numpy(_np(js), device="cpu")
    for i, d in enumerate([(140.0, 20.0, 128.0, 100.0),
                           (900.0, 600.0, 2048.0, 1500.0),
                           (99999.0, 1.0, 1.0, 1.0)]):
        key = jax.random.PRNGKey(100 * seed + i)
        want = int(jbase.kube_select(key, js, jtypes.PodSpec(
            *(jnp.float32(x) for x in d)), jcfg))
        tie = torch.tensor(np.asarray(jax.random.uniform(key, (6,))))
        got = tbase.kube_select(_Step(tiebreak=tie), ts, ttypes.PodSpec(*d),
                                tcfg)
        assert int(got) == want
        _close(tbase.kube_scores(ts, ttypes.PodSpec(*d), tcfg),
               jbase.kube_scores(js, jtypes.PodSpec(*(jnp.float32(x)
                                                      for x in d)), jcfg),
               1e-5)


@pytest.mark.parametrize("epsilon", [0.0, 0.3, 1.0])
def test_masked_argmax_matches_reference_on_given_draws(epsilon):
    rng = np.random.default_rng(int(epsilon * 10))
    scores = rng.normal(size=(16, 7)).astype(np.float32)
    ok = rng.random((16, 7)) > 0.4
    ok[3] = False                                  # nothing feasible
    scores[5, 2] = scores[5, 4] = 9.0              # a tie: first occurrence
    ok[5, 2] = ok[5, 4] = True
    keys = [jax.random.PRNGKey(i) for i in range(16)]
    want = [int(jsched.masked_argmax(k, s, m, epsilon))
            for k, s, m in zip(keys, scores, ok)]
    u, noise = [], []
    for k in keys:
        ke, kr = jax.random.split(k)
        u.append(np.asarray(jax.random.uniform(ke)))
        noise.append(np.asarray(jax.random.uniform(kr, (7,))))
    got = tsched.masked_argmax(None, torch.tensor(scores), torch.tensor(ok),
                               epsilon, u=torch.tensor(np.stack(u)),
                               noise=torch.tensor(np.stack(noise)))
    assert got.dtype == torch.int32 and got.tolist() == want
    assert want[3] == ttypes.NO_PLACEMENT
