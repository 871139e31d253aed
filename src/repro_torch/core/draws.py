"""The random draws of training and evaluation, behind one small interface.

torch cannot reproduce JAX's threefry streams, so every draw the reference
takes goes through this seam: a run gets its randomness from a ``Draws``
object and from nothing else.  Two implementations:

  * ``TorchDraws(generator, batch)`` — standalone runs: each draw comes
    from the generator, on the generator's device;
  * ``ArrayDraws(...)`` — built from numpy arrays (the parity tests make
    them with the reference's own functions and keys), so that the port
    replays the reference's exact episodes.

The interface covers exactly what the reference draws, and no more:

  * ``init_params(spec, n_seeds, device)`` — initial policy params, with a
    leading seed dimension;
  * ``reset(cfg, episode, device)`` — the episode's initial clusters,
    ``(*batch, N)``;
  * ``pod_table(cfg, n_pods, episode, device)`` — the episode's arrival
    streams, fields ``(*batch, n_pods)`` (no draw without a scenario);
  * ``failure(cfg, episode, device)`` — the episode's failure-trace unit
    exponentials, ``(*batch, cycles, 2, N)`` (``env.failure_draws``'
    layout), for scenarios whose nodes fail;
  * ``step(episode, t)`` — the draws of arrival ``t``: ``explore()``, the
    epsilon-greedy uniform ``(*batch,)``; ``noise(n)``, its random
    argmax's uniforms ``(*batch, n)``; ``tiebreak(n)``, the
    kube-scheduler's tie-break uniforms ``(*batch, n)``; ``reschedule()``,
    the draws of the step's re-placement attempt (chaos episodes), with
    the same three methods;
  * ``replay_indices(episode, t, size, shape)`` — the learner's sample,
    uniform integers in ``[0, max(size, 1))``.

``TorchDraws`` takes the failure traces and the re-placement draws from
streams of their own, so that a chaos episode's resets, arrivals and
arrival draws are those of the same episode without failures.

``batch`` is the clusters' batch shape: ``(seeds, envs)`` for the trainer,
``(trials,)`` for evaluation.  ``SegmentDraws`` joins ``ArrayDraws`` blocks
that cover consecutive episode ranges: a scenario mixture's segments
differ in node count, so their resets and noise rows cannot share one
array.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import env as kenv
from repro_torch.core.types import ClusterState, EnvConfig, PodSpec, PodTable
from repro_torch.device import resolve_device
from repro_torch.optim import tree_leaves, tree_map


def stack_trees(trees):
    """Nested dicts of tensors stacked leaf by leaf on a new leading dim."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


# salts of TorchDraws' side streams (the reference's fold_in constants)
_FAILURE_STREAM, _RESCHEDULE_STREAM = 13, 17


class _TorchStep:
    def __init__(self, gen: torch.Generator, batch, side=None):
        self._gen, self._batch, self._side = gen, batch, side

    def _rand(self, shape):
        return torch.rand(shape, generator=self._gen, dtype=torch.float32,
                          device=self._gen.device)

    def explore(self) -> torch.Tensor:
        return self._rand(self._batch)

    def noise(self, n: int) -> torch.Tensor:
        return self._rand(self._batch + (n,))

    tiebreak = noise

    def reschedule(self) -> "_TorchStep":
        return _TorchStep(self._side(_RESCHEDULE_STREAM), self._batch)


class TorchDraws:
    """Every draw from ``generator``, on its device, for clusters of batch
    shape ``batch``."""

    def __init__(self, generator: torch.Generator,
                 batch: Tuple[int, ...] = ()):
        self.generator = generator
        self.batch = tuple(batch)
        self._streams = {}

    def _stream(self, salt: int) -> torch.Generator:
        """A generator of its own for ``salt``, seeded from the main
        generator's seed and made on first use (so that it shifts none of
        the main stream's draws)."""
        gen = self._streams.get(salt)
        if gen is None:
            seed = np.random.SeedSequence(
                [self.generator.initial_seed(), salt]).generate_state(1)[0]
            gen = torch.Generator(device=self.generator.device).manual_seed(
                int(seed))
            self._streams[salt] = gen
        return gen

    def init_params(self, spec, n_seeds: int, device=None):
        return stack_trees([spec.init(self.generator, device=device)
                            for _ in range(n_seeds)])

    def reset(self, cfg: EnvConfig, episode: int = 0,
              device=None) -> ClusterState:
        return kenv.reset(self.generator, cfg, device=device,
                          batch=self.batch)

    def pod_table(self, cfg: EnvConfig, n_pods: int, episode: int = 0,
                  device=None) -> PodTable:
        return kenv.sample_pod_table(self.generator, cfg, n_pods,
                                     device=device, batch=self.batch)

    def failure(self, cfg: EnvConfig, episode: int = 0,
                device=None) -> torch.Tensor:
        return kenv.failure_draws(self._stream(_FAILURE_STREAM), cfg,
                                  self.batch).to(resolve_device(device))

    def step(self, episode: int, t: int) -> _TorchStep:
        return _TorchStep(self.generator, self.batch, self._stream)

    def replay_indices(self, episode: int, t: int, size: int,
                       shape) -> torch.Tensor:
        return torch.randint(0, max(size, 1), tuple(shape),
                             generator=self.generator,
                             device=self.generator.device)


class _ArrayStep:
    def __init__(self, draws: "ArrayDraws", episode: int, t: int,
                 prefix: str = ""):
        self._d, self._ep, self._t, self._p = draws, episode, t, prefix

    def explore(self) -> torch.Tensor:
        return self._d._get(self._p + "explore")[self._ep, self._t]

    def noise(self, n: int) -> torch.Tensor:
        return self._d._rows(self._p + "noise", self._ep, self._t, n)

    def tiebreak(self, n: int) -> torch.Tensor:
        return self._d._rows(self._p + "tiebreak", self._ep, self._t, n)

    def reschedule(self) -> "_ArrayStep":
        return _ArrayStep(self._d, self._ep, self._t, "reschedule_")


class ArrayDraws:
    """Draws given as numpy arrays, indexed ``[episode, step, *batch]``.

    ``params``: a params tree with a leading seed dimension; ``reset``: a
    ``ClusterState`` of arrays ``(episodes, *batch, N)``; ``pod_tables``: a
    ``PodTable`` of arrays ``(episodes, *batch, n_pods)``; ``explore``
    ``(episodes, steps, *batch)``, ``noise`` and ``tiebreak`` ``(episodes,
    steps, *batch, N)``; ``replay_idx`` ``(episodes, steps, *shape)``;
    ``failure`` ``(episodes, *batch, cycles, 2, N)``; ``reschedule``, a
    dict of the re-placement attempts' ``explore`` / ``noise`` /
    ``tiebreak`` in the layouts above.  Whatever is given moves to
    ``device`` once; asking for a draw that was not given raises
    ``KeyError``."""

    def __init__(self, *, params=None, reset=None, pod_tables=None,
                 explore=None, noise=None, tiebreak=None, replay_idx=None,
                 failure=None, reschedule=None, device=None):
        device = resolve_device(device)
        self._arrays = {}
        floats = [("explore", explore), ("noise", noise),
                  ("tiebreak", tiebreak), ("failure", failure)]
        floats += [("reschedule_" + k, v)
                   for k, v in (reschedule or {}).items()]
        for name, value in floats:
            if value is not None:
                self._arrays[name] = torch.tensor(np.asarray(value, np.float32),
                                                  device=device)
        if replay_idx is not None:
            self._arrays["replay_idx"] = torch.tensor(
                np.asarray(replay_idx, np.int64), device=device)
        if params is not None:
            self._arrays["params"] = convert.policy_params_from_numpy(
                params, device=device)
        if reset is not None:
            self._arrays["reset"] = convert.state_from_numpy(reset,
                                                             device=device)
        if pod_tables is not None:
            specs = PodSpec(*(torch.tensor(np.asarray(x, np.float32),
                                           device=device)
                              for x in pod_tables.specs))
            self._arrays["pod_tables"] = PodTable(
                specs=specs,
                dt_s=torch.tensor(np.asarray(pod_tables.dt_s, np.float32),
                                  device=device),
                type_idx=torch.tensor(np.asarray(pod_tables.type_idx,
                                                 np.int32), device=device),
                lifetime_s=torch.tensor(np.asarray(pod_tables.lifetime_s,
                                                   np.float32),
                                        device=device))

    def _get(self, name):
        try:
            return self._arrays[name]
        except KeyError:
            raise KeyError(f"ArrayDraws was built without {name!r}") from None

    def _rows(self, name, episode, t, n):
        rows = self._get(name)[episode, t]
        if rows.shape[-1] != n:
            raise ValueError(f"{name} rows have {rows.shape[-1]} nodes, "
                             f"the clusters {n}")
        return rows

    def init_params(self, spec, n_seeds: int, device=None):
        params = self._get("params")
        lead = {x.shape[0] for x in tree_leaves(params)}
        if lead != {n_seeds}:
            raise ValueError(f"ArrayDraws params lead with {lead}, "
                             f"want {n_seeds} seeds")
        return params

    def reset(self, cfg: EnvConfig, episode: int = 0,
              device=None) -> ClusterState:
        return ClusterState(*(x[episode] for x in self._get("reset")))

    def pod_table(self, cfg: EnvConfig, n_pods: int, episode: int = 0,
                  device=None) -> PodTable:
        table = self._get("pod_tables")
        out = PodTable(specs=PodSpec(*(x[episode] for x in table.specs)),
                       dt_s=table.dt_s[episode],
                       type_idx=table.type_idx[episode],
                       lifetime_s=table.lifetime_s[episode])
        if out.dt_s.shape[-1] != n_pods:
            raise ValueError(f"pod tables hold {out.dt_s.shape[-1]} arrivals, "
                             f"want {n_pods}")
        return out

    def failure(self, cfg: EnvConfig, episode: int = 0,
                device=None) -> torch.Tensor:
        e = self._get("failure")[episode]
        if e.shape[-1] != cfg.n_nodes:
            raise ValueError(f"failure draws have {e.shape[-1]} nodes, "
                             f"the clusters {cfg.n_nodes}")
        return e

    def step(self, episode: int, t: int) -> _ArrayStep:
        return _ArrayStep(self, episode, t)

    def replay_indices(self, episode: int, t: int, size: int,
                       shape) -> torch.Tensor:
        idx = self._get("replay_idx")[episode, t]
        if tuple(idx.shape) != tuple(shape):
            raise ValueError(f"replay indices {tuple(idx.shape)}, want "
                             f"{tuple(shape)}")
        return idx


class SegmentDraws:
    """Draws of consecutive episode ranges, one block each:
    ``blocks = [(ep0, draws), ...]`` in ascending ``ep0``; global episode
    ``ep`` is episode ``ep - ep0`` of the last block starting at or before
    it.  Params come from the first block."""

    def __init__(self, blocks):
        self._blocks = sorted(blocks, key=lambda b: b[0])
        if not self._blocks or self._blocks[0][0] != 0:
            raise ValueError("the first block must start at episode 0")

    def _at(self, episode: int):
        ep0, draws = next(b for b in reversed(self._blocks)
                          if b[0] <= episode)
        return draws, episode - ep0

    def init_params(self, spec, n_seeds: int, device=None):
        return self._blocks[0][1].init_params(spec, n_seeds, device=device)

    def reset(self, cfg: EnvConfig, episode: int = 0,
              device=None) -> ClusterState:
        draws, ep = self._at(episode)
        return draws.reset(cfg, ep, device=device)

    def pod_table(self, cfg: EnvConfig, n_pods: int, episode: int = 0,
                  device=None) -> PodTable:
        draws, ep = self._at(episode)
        return draws.pod_table(cfg, n_pods, ep, device=device)

    def failure(self, cfg: EnvConfig, episode: int = 0, device=None):
        draws, ep = self._at(episode)
        return draws.failure(cfg, ep, device=device)

    def step(self, episode: int, t: int):
        draws, ep = self._at(episode)
        return draws.step(ep, t)

    def replay_indices(self, episode: int, t: int, size: int,
                       shape) -> torch.Tensor:
        draws, ep = self._at(episode)
        return draws.replay_indices(ep, t, size, shape)


# ---------------------------------------------------------------------------
# recording: what a run would take from ``draws``, as ``ArrayDraws`` arrays,
# so that one set of draws made on one device replays on any other
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _host_tree(tree):
    return {k: (_host_tree(v) if isinstance(v, dict) else _host(v))
            for k, v in tree.items()}


def _stack_tables(tables) -> PodTable:
    """Port ``PodTable``s as one of numpy arrays, stacked on a new axis."""
    def stack(cols):
        return np.stack([_host(c) for c in cols])

    return PodTable(specs=PodSpec(*(stack(c) for c in
                                    zip(*(t.specs for t in tables)))),
                    dt_s=stack([t.dt_s for t in tables]),
                    type_idx=stack([t.type_idx for t in tables]),
                    lifetime_s=stack([t.lifetime_s for t in tables]))


def record_train_draws(draws, cfg: EnvConfig, rl, n_seeds: int,
                       device=None) -> dict:
    """What ``draws`` gives a ``train_rl.train_carry`` run of (cfg, rl,
    n_seeds), as the numpy arrays of ``ArrayDraws``; every add is
    ``rl.n_envs`` rows, so the replay sizes the indices are drawn against
    are known."""
    from repro_torch.core import policy

    params = draws.init_params(policy.get(rl.policy), n_seeds, device=device)
    resets, tables, explore, noise, idx, size = [], [], [], [], [], 0
    for ep in range(rl.episodes):
        resets.append([_host(x) for x in draws.reset(cfg, ep, device=device)])
        tables.append(draws.pod_table(cfg, rl.pods_per_episode, ep,
                                      device=device))
        us, ns, ids = [], [], []
        for t in range(rl.pods_per_episode):
            step = draws.step(ep, t)
            us.append(_host(step.explore()))
            ns.append(_host(step.noise(cfg.n_nodes)))
            size = min(size + rl.n_envs, rl.buffer_capacity)
            ids.append(_host(draws.replay_indices(ep, t, size,
                                                  (n_seeds, rl.batch_size))))
        explore.append(np.stack(us)), noise.append(np.stack(ns))
        idx.append(np.stack(ids))
    return dict(params=_host_tree(params),
                reset=[np.stack(c) for c in zip(*resets)],
                pod_tables=_stack_tables(tables),
                explore=np.stack(explore), noise=np.stack(noise),
                replay_idx=np.stack(idx))


def record_mixture_draws(draws, env_cfgs, rl, rounds: int = 4,
                         device=None) -> list:
    """What ``draws`` (batch ``(rl.n_envs,)``) gives a
    ``train_rl.train_mixture`` run of (env_cfgs, rl, rounds), one
    ``ArrayDraws`` block of arrays a segment of ``mixture_schedule``, as
    ``[(ep0, arrays), ...]`` for ``SegmentDraws``; the first block holds
    the initial params (a seed axis of 1).  The replay size runs on across
    segments, as the trainer's one carry does."""
    from repro_torch.core import policy, train_rl

    params = draws.init_params(policy.get(rl.policy), 1, device=device)
    blocks, size = [], 0
    for cfg, ep0, n_eps in train_rl.mixture_schedule(env_cfgs, rl.episodes,
                                                     rounds):
        resets, tables, explore, noise, idx = [], [], [], [], []
        for ep in range(ep0, ep0 + n_eps):
            resets.append([_host(x) for x in draws.reset(cfg, ep,
                                                         device=device)])
            tables.append(draws.pod_table(cfg, rl.pods_per_episode, ep,
                                          device=device))
            us, ns, ids = [], [], []
            for t in range(rl.pods_per_episode):
                step = draws.step(ep, t)
                us.append(_host(step.explore()))
                ns.append(_host(step.noise(cfg.n_nodes)))
                size = min(size + rl.n_envs, rl.buffer_capacity)
                ids.append(_host(draws.replay_indices(ep, t, size,
                                                      (rl.batch_size,))))
            explore.append(np.stack(us)), noise.append(np.stack(ns))
            idx.append(np.stack(ids))
        block = dict(reset=[np.stack(c) for c in zip(*resets)],
                     pod_tables=_stack_tables(tables),
                     explore=np.stack(explore), noise=np.stack(noise),
                     replay_idx=np.stack(idx))
        if not blocks:
            block["params"] = _host_tree(params)
        blocks.append((ep0, block))
    return blocks


def record_trial_draws(draws: TorchDraws, cfg: EnvConfig,
                       n_pods: int) -> dict:
    """A trial batch's draws as ``ArrayDraws`` arrays: the reset and each
    arrival's kube tie-break row (greedy SDQN takes no draw); where the
    config's nodes fail (``env.has_chaos``), also the failure trace's
    exponentials and each arrival's re-placement tie-break row."""
    device = draws.generator.device
    reset = [_host(x)[None] for x in draws.reset(cfg, device=device)]
    tables = _stack_tables([draws.pod_table(cfg, n_pods, device=device)])
    tie = np.stack([_host(draws.step(0, t).tiebreak(cfg.n_nodes))
                    for t in range(n_pods)])
    out = dict(reset=reset, pod_tables=tables, tiebreak=tie[None])
    if kenv.has_chaos(cfg):
        out["failure"] = _host(draws.failure(cfg, device=device))[None]
        again = np.stack([_host(draws.step(0, t).reschedule().tiebreak(
            cfg.n_nodes)) for t in range(n_pods)])
        out["reschedule"] = {"tiebreak": again[None]}
    return out


def record_supervised_draws(draws, cfg: EnvConfig, init_fn, episodes: int,
                            pods: int, n_envs: int, device=None) -> dict:
    """What ``draws`` gives ``train_rl.train_supervised_scorer``: the
    initial params (a seed axis of 1), each episode's resets and each
    step's kube tie-break rows, as ``ArrayDraws`` arrays."""
    import types

    params = draws.init_params(types.SimpleNamespace(init=init_fn), 1,
                               device=device)
    resets, ties = [], []
    for ep in range(episodes):
        resets.append([_host(x) for x in draws.reset(cfg, ep, device=device)])
        ties.append(np.stack([_host(draws.step(ep, t).tiebreak(cfg.n_nodes))
                              for t in range(pods)]))
    return dict(params=_host_tree(params),
                reset=[np.stack(c) for c in zip(*resets)],
                tiebreak=np.stack(ties))
