"""TOPSIS multi-objective placement scorer (port of ``repro.sched.topsis``):
the GreenPod-shaped non-RL baseline of the green Pareto frontier.

Each candidate node's row is its afterstate under the arriving workload,
reduced to four cost criteria:

  * ``cpu``      — the node's CPU% after placement (the paper's objective);
  * ``mem``      — memory% after placement;
  * ``energy``   — wake indicator: 1 where the node runs none of the
                   experiment's pods, so placing there wakes an idle node;
  * ``balance``  — |cpu% - mem%| after placement (resource imbalance).

The procedure is the textbook one: L2 column normalization over the
candidates, weighting, ideal / anti-ideal points (all criteria are costs,
so the ideal is the column minimum), Euclidean distances, and the
closeness ``d- / (d+ + d-)``: higher is better, so the scores go into
``masked_argmax`` / ``api.select`` like Q-scores.  Every function takes
leading batch dimensions (clusters, pods) before the node axis.

Not a ``core.policy`` registry entry: TOPSIS has no params and no learner.
It plugs in as an episode selector (``make_topsis_selector``) and as the
``topsis`` arm of the Pareto rows of ``scripts/scenario_tables.py``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch

from repro_torch.core import env as kenv, schedulers
from repro_torch.core.types import ClusterState, EnvConfig, PodSpec
from repro_torch.sched import placement as _pl
from repro_torch.sched.placement import FleetState, JobSpec

__all__ = ["DEFAULT_WEIGHTS", "closeness", "make_topsis_selector",
           "topsis_scores"]

# (cpu, mem, energy, balance) criterion weights, renormalized inside
# `closeness`: the Pareto sweep scales the energy entry.
DEFAULT_WEIGHTS = (0.40, 0.20, 0.30, 0.10)

_EPS = 1e-9


def closeness(criteria: torch.Tensor,
              weights: Sequence[float] = DEFAULT_WEIGHTS) -> torch.Tensor:
    """TOPSIS closeness of an all-cost criteria matrix ``(..., N, C)``
    (lower = better): ``(..., N)`` in [0, 1], higher = better.  A column on
    which every candidate is equal contributes no distance either way."""
    w = torch.tensor(weights, dtype=torch.float32, device=criteria.device)
    w = w / torch.clamp(torch.sum(w), min=_EPS)
    norm = criteria / (torch.linalg.vector_norm(criteria, dim=-2,
                                                keepdim=True) + _EPS)
    v = norm * w
    ideal = torch.amin(v, dim=-2, keepdim=True)
    anti = torch.amax(v, dim=-2, keepdim=True)
    d_pos = torch.linalg.vector_norm(v - ideal, dim=-1)
    d_neg = torch.linalg.vector_norm(v - anti, dim=-1)
    return d_neg / (d_pos + d_neg + _EPS)


def _criteria(cpu: torch.Tensor, mem: torch.Tensor,
              jobs: torch.Tensor) -> torch.Tensor:
    wake = (jobs == 0).to(torch.float32)
    return torch.stack(torch.broadcast_tensors(
        cpu, mem, wake, torch.abs(cpu - mem)), dim=-1)


def _cluster_criteria(state: ClusterState, pod: PodSpec,
                      cfg: EnvConfig) -> torch.Tensor:
    """``(..., N, 4)`` cost criteria of every candidate afterstate, one pod
    per cluster (fields floats or ``(...)``)."""
    rows = kenv.hypothetical_place(
        state, schedulers.pod_rows(pod, state.base_cpu), cfg)
    return _criteria(rows[..., 0], rows[..., 1], state.exp_pods)


def _fleet_criteria(fleet: FleetState, job: JobSpec) -> torch.Tensor:
    """``(N, 4)`` cost criteria of every candidate afterstate."""
    delta = _pl.job_delta(job, fleet.cpu_pct.device)
    return _criteria(fleet.cpu_pct + delta[0], fleet.mem_pct + delta[1],
                     fleet.num_jobs)


def topsis_scores(fleet: Union[ClusterState, FleetState],
                  pod: Union[PodSpec, JobSpec], *,
                  cfg: Optional[EnvConfig] = None,
                  weights: Sequence[float] = DEFAULT_WEIGHTS) -> torch.Tensor:
    """``(..., N)`` TOPSIS closeness of placing ``pod`` on each target
    (higher = better), dispatched on the fleet's type as
    ``sched.api.heuristic_score`` is; feasibility stays with the caller."""
    if isinstance(fleet, ClusterState):
        if cfg is None:
            raise ValueError("cfg (EnvConfig) is required to score a "
                             "ClusterState fleet")
        return closeness(_cluster_criteria(fleet, pod, cfg), weights)
    if isinstance(fleet, FleetState):
        return closeness(_fleet_criteria(fleet, pod), weights)
    raise TypeError(f"unsupported fleet type: {type(fleet).__name__}")


def make_topsis_selector(cfg: EnvConfig,
                         weights: Sequence[float] = DEFAULT_WEIGHTS
                         ) -> Callable:
    """Episode selector ``(step, state, pod) -> node``, like
    ``make_kube_selector``: greedy over the feasible nodes, no draw."""

    def select(step, state, pod):
        ok = kenv.feasible(state, schedulers.pod_rows(pod, state.base_cpu),
                           cfg)
        q = topsis_scores(state, pod, cfg=cfg, weights=weights)
        return schedulers.masked_argmax(None, q, ok)

    return select
