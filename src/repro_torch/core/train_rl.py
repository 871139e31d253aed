"""RL training for SDQN / SDQN-n (port of ``repro.core.train_rl``).

The loop — environment stepping, afterstate scoring, epsilon-greedy action
selection, reward shaping (Tables 3/5), replay and the Adam/MSE learner
(Table 4) — runs every candidate seed and every parallel simulated cluster
as ONE batch: env states are ``(S, E, N)``, params lead with ``S``, the
replay holds one ring per seed, and the loss is the sum of the per-seed
losses, so autograd gives each seed its own gradients.  A pod step is a
fixed sequence of device operations with no value read back to the host:
the replay's pointer and size, the epsilon schedule and the target-net
refresh are host integers and floats known without the device.  (At
``N >= FUSED_SCORE_MIN_NODES`` the MLP scores through kernel 1, which
takes the pull-contention scalar by value: one read a launch, and one
launch per cluster, 2·S·E a pod step.)

Randomness comes from a ``core.draws`` object: ``TorchDraws`` for
standalone runs, ``ArrayDraws`` to replay the reference's own draws.  The
key derivation they stand for is the reference's: per episode a reset and
a pod table per env, per arrival an explore uniform and a noise row per
env and one replay sample per seed.

The default is full DQN semantics: targets r + γ·Q_target(s′, argmax_a
Q_online(s′, a)) (double DQN) with a periodically refreshed target network;
``bootstrap=False`` recovers the literal Table-4 "target rewards" update.
On scenarios whose pods finish (``env.has_lifecycle``) every env keeps an
expiry ledger and retires due pods each step, as evaluation does.

``train_mixture`` trains ONE Q-net across a scenario mixture: segments of
``chunk`` episodes, one scenario each, visited in cycle, with one carry
(params, target, replay ring, Adam, learn step and the epsilon schedule)
threaded through segments whose node counts differ (the ring stores
6-feature afterstates).  ``train_supervised_scorer`` regresses the
LSTM / Transformer baselines onto Table-3 rewards along kube-scheduler
trajectories.  On a scenario with failing node classes the trainer's
episodes run without a failure trace, as the reference's do.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import dqn, env as kenv, policy as policy_mod, rewards
from repro_torch.core.replay import Replay, replay_add, replay_init, replay_sample
from repro_torch.core.schedulers import (make_kube_selector, masked_argmax,
                                         pod_rows, score_states)
from repro_torch.core.types import ClusterState, EnvConfig, PodSpec, PodTable
from repro_torch.device import resolve_device
from repro_torch.optim import adam_init, tree_map

# Rewards are ~100-point scale (Table 3 base = 100); scale them down so the
# bootstrapped Q (~ r/(1-gamma)) stays O(1-10) under Adam(1e-3) + MSE.
REWARD_SCALE = 0.01


@dataclasses.dataclass(frozen=True)
class RLConfig:
    """Field for field ``repro.core.train_rl.RLConfig``."""

    variant: str = "sdqn"          # "sdqn" | "sdqn_n"
    consolidation_n: int = 2       # the paper's n (n=2)
    episodes: int = 60
    pods_per_episode: int = 50
    n_envs: int = 8                # parallel simulated clusters
    buffer_capacity: int = 4096
    batch_size: int = 128
    eps_start: float = 0.5
    eps_end: float = 0.02
    learn_every: int = 1
    bootstrap: bool = True
    gamma: float = 0.9
    target_update_every: int = 200
    efficiency_weight: float = 10.0
    energy_weight: float = 0.0
    policy: str = "mlp"


class TrainCarry(NamedTuple):
    """The learner's state, every tensor leading with the seed dimension;
    ``learn_step`` counts pod steps on the host (the reference's ``key``
    is the draws object)."""

    params: dict
    opt_state: dict
    target_params: dict
    buffer: Replay
    learn_step: int


def epsilon_at(step: int, n_steps_total: int, rl: RLConfig) -> float:
    """The linear epsilon schedule, in float32 as the reference computes it
    (so that ``u < eps`` cannot flip between the packages)."""
    f32 = np.float32
    frac = f32(step) / f32(max(n_steps_total, 1))
    return float(f32(rl.eps_start)
                 + f32(rl.eps_end - rl.eps_start) * np.minimum(frac, f32(1.0)))


def realized_transition(env_state, pod, action, env_cfg: EnvConfig,
                        reward_fn):
    """Bind a REALIZED action per cluster, shape the reward, build the
    stored replay row: (new_env_state, stored feats (..., 6), scaled
    reward (...)).  A dropped arrival (action -1) clamps the stored row's
    gather to node 0; the caller zero-weights it."""
    before_feats = kenv.features(env_state, env_cfg)
    ok = kenv.feasible(env_state, pod_rows(pod, env_state.base_cpu), env_cfg)
    new_state = kenv.place(env_state, action, pod, env_cfg)
    after_feats = kenv.features(new_state, env_cfg)
    r = reward_fn(after_feats, before_feats, ok, action,
                  env_state.exp_pods, new_state.exp_pods)
    stored = kenv.normalize_features(
        kenv.hypothetical_place_one(env_state, pod, env_cfg,
                                    torch.clamp(action, min=0)))
    return new_state, stored, r * REWARD_SCALE


def transition_step(step, select, env_state, pod, dt_s, env_cfg: EnvConfig,
                    reward_fn):
    """One pod arrival per cluster: act via ``select(step, state, pod)``,
    bind, shape the reward, advance wall-clock.  Returns (new_env_state,
    stored feats, scaled reward, action)."""
    action = select(step, env_state, pod)
    new_state, stored, r = realized_transition(env_state, pod, action,
                                               env_cfg, reward_fn)
    new_state = kenv.tick(new_state, env_cfg, dt_s)
    return new_state, stored, r, action


def _transition(step, qparams, env_state, pod, dt_s, env_cfg: EnvConfig,
                epsilon, reward_fn, spec=None, embed=None, fused="auto"):
    """One RL pod arrival: epsilon-greedy over ``schedulers.score_states``
    plus the common transition body; sequence specs append their history
    ``embed`` to the stored row."""

    def select(sd, st, p):
        ok = kenv.feasible(st, pod_rows(p, st.base_cpu), env_cfg)
        q = score_states(qparams, st, p, env_cfg, fused=fused, policy=spec,
                         embed=embed)
        return masked_argmax(None, q, ok, epsilon, u=sd.explore(),
                             noise=sd.noise(st.n_nodes))

    new_state, stored, r, action = transition_step(
        step, select, env_state, pod, dt_s, env_cfg, reward_fn)
    if embed is not None:
        stored = torch.cat([stored, embed], dim=-1)
    return new_state, stored, r, action


def _bootstrap_bonus(online_params, target_params, env_state, pod, env_cfg,
                     rl: RLConfig, spec=None, embed=None, fused="auto"):
    """Double-DQN bonus per cluster: gamma * Q_target(s', argmax_a
    Q_online(s', a)); 0 where s' has no feasible action."""
    ok = kenv.feasible(env_state, pod_rows(pod, env_state.base_cpu), env_cfg)
    q_online = score_states(online_params, env_state, pod, env_cfg,
                            fused=fused, policy=spec, embed=embed)
    a_star = torch.argmax(torch.where(ok, q_online,
                                      torch.full_like(q_online, -torch.inf)),
                          dim=-1)
    after_star = kenv.normalize_features(
        kenv.hypothetical_place_one(env_state, pod, env_cfg, a_star))
    if embed is not None:
        after_star = torch.cat([after_star, embed], dim=-1)
    qfn = dqn.qvalues if spec is None else spec.qvalues
    q_tgt = qfn(target_params, after_star)
    return torch.where(torch.any(ok, dim=-1), rl.gamma * q_tgt,
                       torch.zeros_like(q_tgt))


def _make_episode_fn(env_cfg: EnvConfig, rl: RLConfig, n_steps_total: int,
                     device, fused="auto"):
    """``episode(carry, ep_idx, draws) -> (carry, metrics)``: one episode
    of every (seed, env) cluster; ``n_steps_total`` anchors the epsilon
    schedule."""
    reward_fn = rewards.make_reward_fn(rl.variant, rl.consolidation_n,
                                       rl.efficiency_weight, rl.energy_weight)
    spec = policy_mod.get(rl.policy)
    seq = spec.embed_dim > 0
    step_fn = policy_mod.make_train_step(spec)
    n_pods = rl.pods_per_episode
    # an expiry ledger only where pods can finish, as in the reference
    use_ledger = kenv.has_lifecycle(env_cfg)

    def episode(c: TrainCarry, ep: int, draws):
        env_states = draws.reset(env_cfg, ep, device=device)    # (S, E, N)
        table = draws.pod_table(env_cfg, n_pods, ep, device=device)
        batch = tuple(env_states.time_s.shape)
        ledgers = (kenv.ledger_init(n_pods, batch, device=device)
                   if use_ledger else None)
        carries = None
        if seq:
            carries = torch.zeros(batch + tuple(spec.carry_init(c.params)
                                                .shape[-2:]),
                                  dtype=torch.float32, device=device)
        losses, rews = [], []
        for t in range(n_pods):
            sd = draws.step(ep, t)
            eps = epsilon_at(ep * n_pods + t, n_steps_total, rl)
            pod = PodSpec(*(x[..., t] for x in table.specs))
            # the arrival after this one, for the bootstrapped Q(s') (the
            # last row wraps, but its bonus is masked out below)
            pod_next = PodSpec(*(x[..., (t + 1) % n_pods]
                                 for x in table.specs))
            embeds = None
            if seq:
                carries, embeds = spec.encode_step(
                    c.params, carries, policy_mod.pod_workload_features(pod))
            expiry = env_states.time_s + table.lifetime_s[..., t]
            new_states, stored, r, actions = _transition(
                sd, c.params, env_states, pod, table.dt_s[..., t], env_cfg,
                eps, reward_fn, spec=spec, embed=embeds, fused=fused)
            if use_ledger:
                ledgers = kenv.ledger_record(ledgers, t, actions, expiry, pod)
                new_states, ledgers, _ = kenv.retire_expired(new_states,
                                                             ledgers)
            targets = r
            if rl.bootstrap:
                embeds_next = None
                if seq:
                    # peek the next arrival's embedding; the carry is not
                    # committed (the real advance happens next arrival)
                    _, embeds_next = spec.encode_step(
                        c.params, carries,
                        policy_mod.pod_workload_features(pod_next))
                bonus = _bootstrap_bonus(c.params, c.target_params,
                                         new_states, pod_next, env_cfg, rl,
                                         spec=spec, embed=embeds_next,
                                         fused=fused)
                targets = r + (bonus if t + 1 < n_pods
                               else torch.zeros_like(bonus))
            # dropped arrivals store with weight 0: their row describes a
            # placement that never happened
            buf = replay_add(c.buffer, stored, targets,
                             (actions >= 0).to(torch.float32))
            idx = draws.replay_indices(ep, t, buf.size,
                                       (batch[0], rl.batch_size))
            feats_b, targets_b, w = replay_sample(buf, idx)
            params_, opt_, loss, _ = step_fn(c.params, c.opt_state, feats_b,
                                             targets_b, w)
            learn_step = c.learn_step + 1
            target = (params_ if learn_step % rl.target_update_every == 0
                      else c.target_params)
            c = TrainCarry(params_, opt_, target, buf, learn_step)
            env_states = new_states
            losses.append(loss)
            rews.append(torch.mean(r, dim=-1))
        metric = kenv.average_cpu_utilization(env_states, env_cfg)
        return c, {"loss": torch.stack(losses).mean(dim=0),
                   "reward": torch.stack(rews).mean(dim=0),
                   "avg_cpu": metric.mean(dim=-1)}

    return episode


def init_carry(draws, rl: RLConfig, n_seeds: int, device=None) -> TrainCarry:
    """Fresh params from ``draws`` (leading seed dimension), Adam moments,
    a target net equal to the online one and an empty ring per seed."""
    device = resolve_device(device)
    spec = policy_mod.get(rl.policy)
    params = draws.init_params(spec, n_seeds, device=device)
    opt_state = adam_init(params, policy_mod.ADAM)
    lane = rl.n_envs if rl.buffer_capacity % rl.n_envs == 0 else 1
    buffer = replay_init(rl.buffer_capacity, n_features=spec.feature_dim,
                         lane=lane, batch=(n_seeds,), device=device)
    target = tree_map(torch.clone, params)
    return TrainCarry(params, opt_state, target, buffer, 0)


def train_carry(draws, env_cfg: EnvConfig, rl: RLConfig, n_seeds: int,
                carry: TrainCarry = None, device=None, fused="auto",
                on_episode=None) -> Tuple[TrainCarry, dict]:
    """Every seed's training run as one batch; returns the final carry and
    the metrics dict of ``(S, episodes)`` tensors.  ``fused`` is the
    scoring dispatch's (``"plain"`` holds the kernels to their plain
    versions); ``on_episode(ep, carry)``, if given, is called after each
    episode (timing, logging)."""
    return _run_segments(draws, [(env_cfg, 0, rl.episodes)], rl, n_seeds,
                         rl.episodes * rl.pods_per_episode, carry, device,
                         fused, on_episode)


def _run_segments(draws, segments, rl: RLConfig, n_seeds: int,
                  n_steps_total: int, carry, device, fused, on_episode):
    """Run ``segments`` — ``(env_cfg, first global episode, episodes)`` —
    in order on one carry; the episode functions are built once per
    config."""
    device = resolve_device(device)
    if carry is None:
        carry = init_carry(draws, rl, n_seeds, device=device)
    episode_fns = {}
    per_ep = []
    for env_cfg, ep0, n_eps in segments:
        if env_cfg not in episode_fns:
            episode_fns[env_cfg] = _make_episode_fn(env_cfg, rl,
                                                    n_steps_total, device,
                                                    fused)
        for ep in range(ep0, ep0 + n_eps):
            carry, m = episode_fns[env_cfg](carry, ep, draws)
            per_ep.append(m)
            if on_episode is not None:
                on_episode(ep, carry)
    metrics = {k: torch.stack([m[k] for m in per_ep], dim=-1)
               for k in ("loss", "reward", "avg_cpu")}
    return carry, metrics


def mixture_schedule(env_cfgs, episodes: int, rounds: int = 4):
    """``train_mixture``'s segments ``[(env_cfg, ep0, chunk), ...]``:
    ``chunk = max(episodes // (len(cfgs) * rounds), 1)`` episodes a
    segment, the configs visited in cycle until ``episodes`` are
    scheduled (the budget is met to within one chunk)."""
    env_cfgs = list(env_cfgs)
    chunk = max(episodes // (len(env_cfgs) * rounds), 1)
    segments, ep0 = [], 0
    cycle = itertools.cycle(env_cfgs)
    while ep0 < episodes:
        segments.append((next(cycle), ep0, chunk))
        ep0 += chunk
    return segments


class _OneSeed:
    """A single run's draws (batch ``(E,)``) seen with a leading seed axis
    of 1."""

    def __init__(self, draws):
        self._d = draws

    def init_params(self, spec, n_seeds, device=None):
        return self._d.init_params(spec, n_seeds, device=device)

    def reset(self, cfg, episode=0, device=None):
        state = self._d.reset(cfg, episode, device=device)
        return ClusterState(*(x[None] for x in state))

    def pod_table(self, cfg, n_pods, episode=0, device=None):
        tb = self._d.pod_table(cfg, n_pods, episode, device=device)
        return PodTable(PodSpec(*(x[None] for x in tb.specs)), tb.dt_s[None],
                        tb.type_idx[None], tb.lifetime_s[None])

    def step(self, episode, t):
        return _OneSeedStep(self._d.step(episode, t))

    def replay_indices(self, episode, t, size, shape):
        return self._d.replay_indices(episode, t, size, shape[1:])[None]


class _OneSeedStep:
    def __init__(self, step):
        self._s = step

    def explore(self):
        return self._s.explore()[None]

    def noise(self, n):
        return self._s.noise(n)[None]

    def tiebreak(self, n):
        return self._s.tiebreak(n)[None]


def train(draws, env_cfg: EnvConfig, rl: RLConfig, carry: TrainCarry = None,
          device=None) -> Tuple[dict, dict]:
    """Train one SDQN/SDQN-n policy on ``rl.n_envs`` clusters.  ``draws``
    has batch ``(n_envs,)``; ``carry`` (leading seed dimension 1, e.g. the
    reference's initial carry through ``convert``) replaces the fresh
    one.  Returns (qparams, metrics dict of per-episode tensors).  Runs on
    the card unless ``device="cpu"``."""
    carry, metrics = train_carry(_OneSeed(draws), env_cfg, rl, 1, carry=carry,
                                 device=device)
    return (tree_map(lambda x: x[0], carry.params),
            {k: v[0] for k, v in metrics.items()})


def train_mixture(draws, env_cfgs, rl: RLConfig, rounds: int = 4,
                  carry: TrainCarry = None, device=None) -> Tuple[dict, dict]:
    """Train ONE SDQN/SDQN-n policy across a scenario mixture
    (``mixture_schedule``); returns (qparams, metrics dict of per-episode
    tensors in training order).  ``draws`` (batch ``(n_envs,)``) answer
    for every config at its global episode indices: a
    ``core.draws.SegmentDraws`` of per-segment blocks, or ``TorchDraws``.
    The epsilon schedule spans the episodes actually scheduled.  Runs on
    the card unless ``device="cpu"``."""
    segments = mixture_schedule(env_cfgs, rl.episodes, rounds)
    total = sum(n for _, _, n in segments)
    carry, metrics = _run_segments(_OneSeed(draws), segments, rl, 1,
                                   total * rl.pods_per_episode, carry,
                                   device, "auto", None)
    return (tree_map(lambda x: x[0], carry.params),
            {k: v[0] for k, v in metrics.items()})


# ---------------------------------------------------------------------------
# supervised training for the LSTM / Transformer baselines (Tables 6/7)
# ---------------------------------------------------------------------------


class _Scorer(NamedTuple):
    """A baseline scorer's init in the place of a policy class's, for
    ``draws.init_params``."""

    init: Callable


def train_supervised_scorer(draws, env_cfg: EnvConfig, init_fn: Callable,
                            score_fn: Callable, episodes: int = 40,
                            pods_per_episode: int = 50, n_envs: int = 8,
                            efficiency_weight: float = 10.0,
                            device=None) -> dict:
    """Train a scorer by regression onto Table-3 rewards along
    kube-scheduler trajectories (the paper's LSTM / Transformer are
    behaviour-cloning value estimators, not RL agents): per pod step the
    ``transition_step`` of the RL loop with ``kube_select``, then one MSE
    step on the ``n_envs`` stored afterstates, dropped arrivals weighted
    0.  ``draws`` (batch ``(n_envs,)``) give the initial params (one
    seed), each episode's resets and each step's kube tie-breaks; every
    arrival is the default pod every ``schedule_dt_s`` seconds.  Runs on
    the card unless ``device="cpu"``."""
    from repro_torch.core import baselines

    device = resolve_device(device)
    params = tree_map(lambda x: x[0], draws.init_params(_Scorer(init_fn), 1,
                                                        device=device))
    opt_state = adam_init(params, baselines.ADAM)
    step_fn = baselines.make_regression_trainer(score_fn)
    pod = kenv.default_pod(env_cfg)
    select = make_kube_selector(env_cfg)
    reward_fn = rewards.make_reward_fn("sdqn",
                                       efficiency_weight=efficiency_weight)
    for ep in range(episodes):
        env_states = draws.reset(env_cfg, ep, device=device)    # (E, N)
        if tuple(env_states.time_s.shape) != (n_envs,):
            raise ValueError(f"draws give {tuple(env_states.time_s.shape)} "
                             f"envs, want ({n_envs},)")
        for t in range(pods_per_episode):
            env_states, feats, targets, actions = transition_step(
                draws.step(ep, t), select, env_states, pod,
                env_cfg.schedule_dt_s, env_cfg, reward_fn)
            params, opt_state, _ = step_fn(params, opt_state, feats, targets,
                                           (actions >= 0).to(torch.float32))
    return params
