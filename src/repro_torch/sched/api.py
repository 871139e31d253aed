"""The public scheduling API (PyTorch port), ``ClusterState`` arm only.

    from repro_torch.sched import api

    q = api.score(cluster_state, pod, params=qparams, cfg=env_cfg)   # (N,)
    node = api.select(cluster_state, pod, params=qparams, cfg=env_cfg)

``score`` goes through ``schedulers.score_afterstates`` (the CUDA kernel at
fleet scale on the card, its plain twin on the CPU, the unfused path below
``FUSED_SCORE_MIN_NODES``).  The job->host ``FleetState`` arm and sharded
selection are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import env as kenv, schedulers
from repro_torch.core.types import NO_PLACEMENT, ClusterState, EnvConfig, PodSpec

__all__ = ["DIVERGENCE_LIMIT", "NO_PLACEMENT", "heuristic_score", "score",
           "scores_valid", "select"]

# |Q| beyond this is treated as a diverged net (a blown-up training run or a
# corrupted checkpoint), not a preference — the guard swaps in the heuristic
DIVERGENCE_LIMIT = 1e6


def _check_fleet(fleet, cfg) -> None:
    if not isinstance(fleet, ClusterState):
        raise TypeError(f"unsupported fleet type: {type(fleet).__name__} "
                        f"(only ClusterState is ported)")
    if cfg is None:
        raise ValueError("cfg (EnvConfig) is required to score a "
                         "ClusterState fleet")


def heuristic_score(fleet: ClusterState, pod: PodSpec, *,
                    cfg: Optional[EnvConfig] = None) -> torch.Tensor:
    """(N,) kube-style LeastRequested+Balanced scores — no Q-net involved;
    the graceful-degradation fallback."""
    _check_fleet(fleet, cfg)
    cpu_free = ((fleet.cpu_capacity - fleet.cpu_requested - pod.cpu_request)
                / fleet.cpu_capacity)
    mem_free = ((fleet.mem_capacity - fleet.mem_requested - pod.mem_request)
                / fleet.mem_capacity)
    least_requested = 10.0 * (cpu_free + mem_free) / 2.0
    balanced = 10.0 * (1.0 - torch.abs(cpu_free - mem_free))
    return least_requested + balanced


def scores_valid(q: torch.Tensor) -> torch.Tensor:
    """0-d bool: all scores finite and inside ``DIVERGENCE_LIMIT``."""
    return torch.all(torch.isfinite(q) & (torch.abs(q) <= DIVERGENCE_LIMIT))


def score(fleet: ClusterState, pod: PodSpec, *, params: dict,
          cfg: Optional[EnvConfig] = None, fused="auto",
          guard: bool = False) -> torch.Tensor:
    """(N,) Q-scores of placing ``pod`` on each node of ``fleet``.

    ``guard=True`` swaps the WHOLE vector for ``heuristic_score`` when any
    score is NaN/inf or beyond ``DIVERGENCE_LIMIT``."""
    _check_fleet(fleet, cfg)
    q = schedulers.score_afterstates(params, fleet, pod, cfg, fused=fused)
    if not guard:
        return q
    return torch.where(scores_valid(q), q, heuristic_score(fleet, pod, cfg=cfg))


def select(fleet: ClusterState, pod: PodSpec, *, params: dict,
           cfg: Optional[EnvConfig] = None, fused="auto",
           guard: bool = False) -> torch.Tensor:
    """Greedy feasible argmax over ``score``; ``NO_PLACEMENT`` if none fit
    (int32 0-d tensor; ties break to the lowest index)."""
    q = score(fleet, pod, params=params, cfg=cfg, fused=fused, guard=guard)
    return schedulers.masked_argmax(None, q, kenv.feasible(fleet, pod, cfg))
