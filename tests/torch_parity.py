"""Shared inputs and replay helpers of the port's parity tests.

Fleets and request streams are made with numpy, so both packages get the
same ones; the clock and the deadline stopwatch are injected so both
daemons cut the same batches.

torch cannot reproduce JAX's threefry streams, so ``reference_train_draws``,
``seeded_train_draws``, ``reference_mixture_draws``,
``reference_trial_draws``, ``reference_chaos_draws``,
``reference_scenario_trial_draws`` and ``reference_supervised_draws``
rebuild every draw the reference takes from its key (resets, arrival
tables, explore uniforms, noise rows, replay indices, kube-scheduler
tie-breaks, failure traces) by calling the reference's own
``env.reset``, ``env.sample_pod_table`` and ``jax.random`` under the key
derivation of ``repro/core/train_rl.py`` and ``repro/core/env.py``, as
numpy arrays for the port's ``core.draws.ArrayDraws``.  They are the one
copy: the parity tests and ``scripts/trained_spread.py`` load them from
here.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import dqn as jdqn, env as jenv, policy as jpol
from repro.core import types as jtypes
from repro_torch.core.types import NO_PLACEMENT


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


def fleet_np(n, seed, tight=False):
    """Job-fleet columns with infeasible hosts: unhealthy ones, cpu and mem
    near their ceilings, job slots nearly full (``tight``: 0-3 slots left
    on every host, so a batch's jobs collide)."""
    rng = np.random.default_rng(seed)
    jobs = rng.integers(22 if tight else 0, 26, n)
    return dict(cpu_pct=rng.uniform(2.0, 92.0, n).astype(np.float32),
                mem_pct=rng.uniform(2.0, 96.0, n).astype(np.float32),
                job_util_pct=(jobs * 4.0).astype(np.float32),
                healthy=(rng.random(n) > 0.15).astype(np.float32),
                uptime_hours=rng.uniform(1.0, 200.0, n).astype(np.float32),
                num_jobs=jobs.astype(np.int32))


def job_stream(n, seed):
    """(arrival offsets at ~500/s, [(cpu %, mem %)]) of ``n`` jobs."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1 / 500.0, n))
    return t - t[0], list(zip(rng.uniform(1, 10, n).tolist(),
                              rng.uniform(0.5, 5, n).tolist()))


def drive(daemon, clock, t_s, reqs, fail_after=-1):
    """Submit ``reqs`` on their schedule, polling after each; after request
    ``fail_after`` fail the node of the first bound decision; then drain."""
    for i, (t, req) in enumerate(zip(t_s, reqs)):
        clock.t = float(t)
        daemon.submit(req, now=float(t))
        daemon.poll()
        if i == fail_after:
            bound = [d.node for d in daemon.decisions if d.node != NO_PLACEMENT]
            daemon.fail_node(bound[0])
    clock.t = float(t_s[-1]) + 1.0
    daemon.drain()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _key_bytes(k) -> bytes:
    return np.asarray(k, np.uint32).tobytes()


@functools.partial(jax.jit, static_argnames=("n_envs", "n_nodes", "batch"))
def _step_draws(k_steps, t, size, n_envs, n_nodes, batch):
    """Arrival ``t``'s draws as ``_make_episode_fn.pod_step`` takes them:
    per env ``split(key)`` -> explore uniform, noise row; the last key's
    replay sample; and the per-env keys (to name recorded actions)."""
    keys = jax.random.split(jax.random.fold_in(k_steps, t), n_envs + 2)

    def env(k):
        ke, kr = jax.random.split(k)
        return jax.random.uniform(ke), jax.random.uniform(kr, (n_nodes,))

    u, noise = jax.vmap(env)(keys[:n_envs])
    idx = jax.random.randint(keys[-1], (batch,), 0, jnp.maximum(size, 1))
    return u, noise, idx, keys[:n_envs]


def reference_train_draws(key, cfg, rl):
    """Every draw of ``train_rl.train(key, cfg, rl)``: a dict of numpy
    arrays for ``ArrayDraws`` (batch ``(E,)``, params with a seed axis of
    1) and ``{key bytes: (episode, step, env)}``."""
    k_init, k_train = jax.random.split(key)
    params = jpol.get(rl.policy).init(k_init)
    e, t_n, n = rl.n_envs, rl.pods_per_episode, cfg.n_nodes
    resets, tables, explore, noise, idx, names = [], [], [], [], [], {}
    size = 0
    for ep in range(rl.episodes):
        key_ep = jax.random.fold_in(k_train, ep)
        k_reset, k_pods, k_steps = jax.random.split(key_ep, 3)
        resets.append(_np(jax.vmap(lambda k: jenv.reset(k, cfg))(
            jax.random.split(k_reset, e))))
        tables.append(_np(jax.vmap(
            lambda k: jenv.sample_pod_table(k, cfg, t_n))(
                jax.random.split(k_pods, e))))
        us, ns, ids = [], [], []
        for t in range(t_n):
            size = min(size + e, rl.buffer_capacity)
            u, nz, ix, keys = _step_draws(k_steps, t, jnp.int32(size), e, n,
                                          rl.batch_size)
            us.append(u), ns.append(nz), ids.append(ix)
            for env_i, k in enumerate(np.asarray(keys)):
                names[_key_bytes(k)] = (ep, t, env_i)
        explore.append(np.stack(us)), noise.append(np.stack(ns))
        idx.append(np.stack(ids))
    reset = jtypes.ClusterState(*(np.stack(col) for col in zip(*resets)))
    return dict(params=jax.tree.map(lambda x: np.asarray(x)[None], params),
                reset=reset, pod_tables=_stack_tables(tables),
                explore=np.stack(explore), noise=np.stack(noise),
                replay_idx=np.stack(idx)), names


def _stack_tables(tables, axis=0):
    """Reference ``PodTable``s stacked on a new ``axis``."""
    return jax.tree.map(lambda *x: np.stack(x, axis=axis), *tables)


def seeded_train_draws(key, cfg, rl, n_seeds, names=None):
    """``train_seeds``' draws: seed s is ``train(fold_in(key, s))``'s,
    stacked behind the episode and step axes.  A dict given as ``names``
    is filled with ``{key bytes: (seed, episode, step, env)}``."""
    per = []
    for s in range(n_seeds):
        draws, keys = reference_train_draws(jax.random.fold_in(key, s), cfg,
                                            rl)
        per.append(draws)
        if names is not None:
            names.update({k: (s,) + v for k, v in keys.items()})
    return dict(
        params=jax.tree.map(lambda *x: np.concatenate(x), *[d["params"]
                                                            for d in per]),
        reset=jtypes.ClusterState(*(np.stack(c, axis=1) for c in
                                    zip(*[d["reset"] for d in per]))),
        pod_tables=_stack_tables([d["pod_tables"] for d in per], axis=1),
        explore=np.stack([d["explore"] for d in per], axis=2),
        noise=np.stack([d["noise"] for d in per], axis=2),
        replay_idx=np.stack([d["replay_idx"] for d in per], axis=2))


def reference_trial_draws(keys, cfg, n_pods):
    """The draws of ``run_episode(k, ...)`` for each trial key: the reset
    and, per arrival, the kube-scheduler's tie-break row (its step key's
    ``uniform(key, (N,))``), batch ``(trials,)``."""
    def one(k):
        k_reset, k_pods, k_act = jax.random.split(k, 3)
        steps = jax.random.split(k_act, n_pods)
        tie = jax.vmap(lambda s: jax.random.uniform(s, (cfg.n_nodes,)))(steps)
        return (jenv.reset(k_reset, cfg),
                jenv.sample_pod_table(k_pods, cfg, n_pods), tie)

    states, tables, tie = jax.jit(jax.vmap(one))(keys)
    return dict(reset=jtypes.ClusterState(*(np.asarray(x)[None]
                                            for x in states)),
                pod_tables=jax.tree.map(lambda x: np.asarray(x)[None], tables),
                tiebreak=np.swapaxes(np.asarray(tie), 0, 1)[None])


def reference_failure_units(key, cfg, cycles=None):
    """The unit exponentials ``repro.core.env.sample_failure_trace(key,
    cfg)`` draws, in ``env.failure_draws``' layout ``(cycles, 2, N)``."""
    cycles = cfg.chaos_cycles if cycles is None else cycles
    n = cfg.n_nodes
    return jnp.stack([jnp.stack([
        jax.random.exponential(jax.random.fold_in(key, 2 * c), (n,),
                               jnp.float32),
        jax.random.exponential(jax.random.fold_in(key, 2 * c + 1), (n,),
                               jnp.float32)]) for c in range(cycles)])


def reference_chaos_draws(keys, cfg, n_pods):
    """``reference_trial_draws`` plus what a chaos episode of
    ``run_episode(k, ...)`` draws: the trace's exponentials from
    ``fold_in(k, 13)`` and, per arrival, the re-placement attempt's kube
    tie-break row from ``fold_in(step_key, 17)``."""
    base = reference_trial_draws(keys, cfg, n_pods)

    def one(k):
        _, _, k_act = jax.random.split(k, 3)
        steps = jax.random.split(k_act, n_pods)
        tie = jax.vmap(lambda s: jax.random.uniform(
            jax.random.fold_in(s, 17), (cfg.n_nodes,)))(steps)
        return reference_failure_units(jax.random.fold_in(k, 13), cfg), tie

    e, tie = jax.jit(jax.vmap(one))(keys)
    base["failure"] = np.asarray(e)[None]
    base["reschedule"] = {"tiebreak": np.swapaxes(np.asarray(tie), 0, 1)[None]}
    return base


def reference_scenario_trial_draws(keys, cfg, n_pods):
    """The draws of ``run_episode(k, cfg, ...)`` for each trial key:
    ``reference_chaos_draws`` where the config's nodes fail (a node class
    of finite MTBF), else ``reference_trial_draws``."""
    chaos = cfg.scenario is not None and any(
        np.isfinite(c.mtbf_s) for c in cfg.scenario.node_classes)
    return (reference_chaos_draws if chaos else reference_trial_draws)(
        keys, cfg, n_pods)


def reference_mixture_draws(key, cfgs, rl, rounds):
    """Every draw of ``train_rl.train_mixture(key, cfgs, rl, rounds)``, one
    ``ArrayDraws`` block a segment (each with its own config's node count),
    indexed by the global episode the reference folds into its key; and
    ``{key bytes: (episode, step, env)}``."""
    k_init, k_train = jax.random.split(key)
    params = jax.tree.map(lambda x: np.asarray(x)[None],
                          jdqn.init_qnet(k_init))
    e, t_n = rl.n_envs, rl.pods_per_episode
    chunk = max(rl.episodes // (len(cfgs) * rounds), 1)
    blocks, names, size, ep0 = [], {}, 0, 0
    cycle, fns = 0, {}
    while ep0 < rl.episodes:
        cfg = cfgs[cycle % len(cfgs)]
        cycle += 1
        if cfg not in fns:
            fns[cfg] = (jax.jit(jax.vmap(lambda k, c=cfg: jenv.reset(k, c))),
                        jax.jit(jax.vmap(lambda k, c=cfg: jenv.sample_pod_table(
                            k, c, t_n))))
        reset_fn, table_fn = fns[cfg]
        resets, tables, explore, noise, idx = [], [], [], [], []
        for ep in range(ep0, ep0 + chunk):
            k_reset, k_pods, k_steps = jax.random.split(
                jax.random.fold_in(k_train, ep), 3)
            resets.append(_np(reset_fn(jax.random.split(k_reset, e))))
            tables.append(_np(table_fn(jax.random.split(k_pods, e))))
            us, ns, ids = [], [], []
            for t in range(t_n):
                size = min(size + e, rl.buffer_capacity)
                u, nz, ix, keys = _step_draws(k_steps, t, jnp.int32(size), e,
                                              cfg.n_nodes, rl.batch_size)
                us.append(u), ns.append(nz), ids.append(ix)
                for env_i, k in enumerate(np.asarray(keys)):
                    names[_key_bytes(k)] = (ep, t, env_i)
            explore.append(np.stack(us)), noise.append(np.stack(ns))
            idx.append(np.stack(ids))
        blocks.append((ep0, dict(
            params=params,
            reset=jtypes.ClusterState(*(np.stack(c) for c in zip(*resets))),
            pod_tables=_stack_tables(tables), explore=np.stack(explore),
            noise=np.stack(noise), replay_idx=np.stack(idx))))
        ep0 += chunk
    return blocks, names


def reference_supervised_draws(key, cfg, init_fn, episodes, pods, n_envs):
    """Every draw of ``train_rl.train_supervised_scorer(key, cfg, init_fn,
    ..., episodes, pods, n_envs)``: the initial params (a seed axis of 1),
    each episode's resets and each step's kube tie-break rows."""
    params = jax.tree.map(lambda x: np.asarray(x)[None], init_fn(key))

    @jax.jit
    def episode(ep):
        key_ep = jax.random.fold_in(key, ep)
        resets = jax.vmap(lambda k: jenv.reset(k, cfg))(
            jax.random.split(key_ep, n_envs))

        def tie(t):
            kt = jax.random.split(jax.random.fold_in(key_ep, 1000 + t),
                                  n_envs)
            return jax.vmap(lambda k: jax.random.uniform(
                k, (cfg.n_nodes,)))(kt)

        return resets, jax.vmap(tie)(jnp.arange(pods))

    out = [episode(ep) for ep in range(episodes)]
    return dict(params=params,
                reset=jtypes.ClusterState(*(np.stack(c) for c in zip(
                    *[_np(r) for r, _ in out]))),
                tiebreak=np.stack([np.asarray(t) for _, t in out]))
