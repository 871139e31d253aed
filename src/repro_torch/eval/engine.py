"""Batched evaluation engine (port of ``repro.eval.engine``).

The paper's claims rest on many-trial comparisons.  Where the reference
vmaps ``env.run_episode`` over trial keys, the port runs every trial as one
batch dimension of the same episode loop (and the candidate seeds of a
selection round as one more, ahead of it):

    batch = make_batch_episode(env_cfg, select, n_pods)
    trials = batch(draws)            # draws: core.draws, batch (trials,)
    summary = summarize(trials)      # mean / std / CI / drops

The trials' randomness (initial clusters, tie-break and exploration
draws) comes from ``draws``; the reference's ``PRNGKey(100 + t)`` trials
are reproduced by ``ArrayDraws`` built from the reference's own draws, and
standalone runs use ``TorchDraws``.  Candidate seeds share the trials'
draws, so they are validated on identical bursts.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import env as kenv
from repro_torch.core.types import EnvConfig
from repro_torch.device import resolve_device
from repro_torch.optim import tree_leaves


class TrialResults(NamedTuple):
    """Per-trial episode outputs, leading dims = (candidates,) trials."""

    metric: torch.Tensor        # (T,) dt-weighted cluster-average CPU%
    distribution: torch.Tensor  # (T, N) final pods per node (tenant + ours)
    exp_pods: torch.Tensor      # (T, N) final experiment pods per node
    dropped: torch.Tensor       # (T,) int32 arrivals with no feasible node
    placed: torch.Tensor        # (T,) int32 admitted arrivals (n - dropped)
    nodes_active: torch.Tensor  # (T,) time-averaged active-node count
    nodes_active_final: torch.Tensor  # (T,) int32 active nodes at the end
    node_seconds: torch.Tensor  # (T,) integral of active nodes over time
    energy_wh: torch.Tensor     # (T,) energy billed to the workload
    retired: torch.Tensor       # (T,) int32 pods completed + released
    moved: torch.Tensor         # (T,) int32 pods consolidation moved
    evicted: torch.Tensor       # (T,) int32 pods killed by node failures
    rescheduled: torch.Tensor   # (T,) int32 evicted pods re-placed
    lost: torch.Tensor          # (T,) int32 evicted pods never re-placed


def _default_n_pods(env_cfg: EnvConfig, n_pods: Optional[int]) -> int:
    """``n_pods``, else the scenario's arrivals, else the paper's 50."""
    if n_pods is not None:
        return n_pods
    return env_cfg.scenario.n_pods if env_cfg.scenario is not None else 50


def _split_carrying(select):
    """A selector, or a ``(select, carry0)`` pair
    (``schedulers.make_policy_selector``), as ``(select, carry0)``."""
    if isinstance(select, tuple):
        return select
    return select, None


def _trials(draws, env_cfg: EnvConfig, select, n: int, lead=(),
            consolidate=None, device=None) -> TrialResults:
    select, carry0 = _split_carrying(select)
    res = kenv.run_episode(draws, env_cfg, select, n, consolidate=consolidate,
                           select_carry=carry0, lead=lead, device=device)
    stats = res.stats
    return TrialResults(
        metric=res.metric,
        distribution=res.placements,
        exp_pods=res.state.exp_pods,
        dropped=res.dropped,
        placed=n - res.dropped,
        nodes_active=stats.nodes_active_mean,
        nodes_active_final=stats.nodes_active_final,
        node_seconds=stats.node_seconds,
        energy_wh=stats.energy_wh,
        retired=stats.retired,
        moved=stats.moved,
        evicted=stats.evicted,
        rescheduled=stats.rescheduled,
        lost=stats.lost,
    )


def make_batch_episode(env_cfg: EnvConfig, select: Callable,
                       n_pods: Optional[int] = None, consolidate=None,
                       device=None) -> Callable:
    """``(draws) -> TrialResults``: every trial of ``draws``' batch in one
    episode loop.  ``consolidate`` threads the in-episode SDQN-n pass
    through to ``run_episode`` (active when ``env_cfg.consolidate_every_s
    > 0``).  Runs on the card unless ``device="cpu"``."""
    n = _default_n_pods(env_cfg, n_pods)
    device = resolve_device(device)
    return lambda draws: _trials(draws, env_cfg, select, n,
                                 consolidate=consolidate, device=device)


def make_param_evaluator(env_cfg: EnvConfig, selector_factory: Callable,
                         n_pods: Optional[int] = None,
                         device=None) -> Callable:
    """``(params, draws) -> TrialResults`` for seed-selection loops:
    ``selector_factory(params)`` gives a selector or a ``(select, carry0)``
    pair."""
    n = _default_n_pods(env_cfg, n_pods)
    device = resolve_device(device)

    def run(params, draws):
        return _trials(draws, env_cfg, selector_factory(params), n,
                       device=device)

    return run


def make_multi_param_evaluator(env_cfg: EnvConfig, selector_factory: Callable,
                               n_pods: Optional[int] = None,
                               device=None) -> Callable:
    """``(stacked_params, draws) -> TrialResults`` with (S, T) leading
    dims: every (candidate, trial) episode of a selection round in one
    loop.  ``stacked_params`` lead with the seed dimension (the output of
    ``train.engine.train_seeds``); the trials' draws are shared across the
    candidates."""
    n = _default_n_pods(env_cfg, n_pods)
    device = resolve_device(device)

    def run(stacked_params, draws):
        s = tree_leaves(stacked_params)[0].shape[0]
        return _trials(draws, env_cfg, selector_factory(stacked_params), n,
                       lead=(s,), device=device)

    return run


def summarize(trials: TrialResults) -> Dict[str, float]:
    """Mean / std / 95% CI of the paper metric, plus drop/placement stats,
    the lifecycle metrics (active nodes, node-seconds, energy, pods
    retired and pods consolidation moved) and the chaos counts (pods
    evicted, rescheduled and lost)."""
    def host(x):
        return np.asarray(x.detach().cpu(), np.float64)

    mets = host(trials.metric)
    dropped = host(trials.dropped)
    t = mets.shape[0]
    std = float(mets.std())
    return {
        "metric_mean": float(mets.mean()),
        "metric_std": std,
        "metric_ci95": float(1.96 * std / np.sqrt(max(t, 1))),
        "dropped_mean": float(dropped.mean()),
        "dropped_max": float(dropped.max()),
        "pods_placed_mean": float(host(trials.placed).mean()),
        "nodes_active_mean": float(host(trials.nodes_active).mean()),
        "nodes_active_final_mean": float(host(trials.nodes_active_final).mean()),
        "node_seconds_mean": float(host(trials.node_seconds).mean()),
        "energy_wh_mean": float(host(trials.energy_wh).mean()),
        "retired_mean": float(host(trials.retired).mean()),
        "moved_mean": float(host(trials.moved).mean()),
        "evicted_mean": float(host(trials.evicted).mean()),
        "rescheduled_mean": float(host(trials.rescheduled).mean()),
        "lost_mean": float(host(trials.lost).mean()),
        "trials": float(t),
    }


def evaluate(draws, env_cfg: EnvConfig, select: Callable,
             n_pods: Optional[int] = None, batch: Optional[Callable] = None,
             consolidate=None, device=None) -> Dict[str, float]:
    """One-call evaluation of ``draws``' trials: batched episodes + the
    summary dict.  A prebuilt ``batch`` (``make_batch_episode``) already
    fixed its consolidation, so it cannot be combined with one here."""
    if batch is not None and consolidate is not None:
        raise ValueError("pass consolidate to make_batch_episode, not to "
                         "evaluate, when supplying a prebuilt batch")
    ep = batch if batch is not None else make_batch_episode(
        env_cfg, select, n_pods, consolidate, device=device)
    out = summarize(ep(draws))
    out["n_pods"] = float(_default_n_pods(env_cfg, n_pods))
    out["n_nodes"] = float(env_cfg.n_nodes)
    return out
