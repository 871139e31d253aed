"""The public scheduling API (PyTorch port).

    from repro_torch.sched import api

    q = api.score(cluster_state, pod, params=qparams, cfg=env_cfg)   # (N,)
    q = api.score(fleet_state, job, params=qparams)                  # (N,)
    qb = api.score_batch(fleet_state, jobs, params=qparams)          # (B, N)
    node = api.select(cluster_state, pod, params=qparams, cfg=env_cfg)
    q = api.topsis_score(fleet_state, job)                           # (N,)

``score`` dispatches on the fleet's type:

  * ``core.types.ClusterState`` + ``PodSpec`` — the paper's pod scheduler,
    through ``schedulers.score_afterstates`` (the CUDA afterstate kernel
    at fleet scale on the card, its plain twin on the CPU, the unfused path
    below ``FUSED_SCORE_MIN_NODES``).  ``cfg`` is required.
  * ``sched.placement.FleetState`` + ``JobSpec`` — job->host placement:
    the six raw fleet columns + the job's delta through the column kernel
    (``ops.sdqn_score_delta``).

``fused``: ``"auto"`` / ``True`` take the kernel path (plain twin on the
CPU), ``"plain"`` forces the plain twin, ``False`` the unfused reference.
``policy`` (a registered ``core.policy.PolicySpec``) swaps in a policy
class on either fleet type, ``embed`` is its history embedding for
sequence specs.  ``score_fn`` swaps the Table-4 Q-net for a custom scorer
(the LSTM / Transformer baselines): ClusterState fleets only, always the
unfused path.
``shard``: ``"auto"`` resolves to the unsharded program on one card; an
int forces that shard count (two-stage selection, ``sched.shard``); a
``launch.mesh.FleetLayout`` pins a layout; ``False`` disables it.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core import env as kenv, schedulers
from repro_torch.core.types import NO_PLACEMENT, ClusterState, EnvConfig, PodSpec
from repro_torch.kernels import ops
from repro_torch.sched import placement as _pl
from repro_torch.sched.placement import FleetState, JobSpec

__all__ = ["DIVERGENCE_LIMIT", "NO_PLACEMENT", "heuristic_score", "score",
           "score_batch", "scores_valid", "select", "topk", "topsis_score"]

Fleet = Union[ClusterState, FleetState]
Workload = Union[PodSpec, JobSpec]

# |Q| beyond this is treated as a diverged net (a blown-up training run or a
# corrupted checkpoint), not a preference — the guard swaps in the heuristic
DIVERGENCE_LIMIT = 1e6


def _need_cfg(cfg) -> None:
    if cfg is None:
        raise ValueError("cfg (EnvConfig) is required to score a "
                         "ClusterState fleet")


def heuristic_delta_scores(fleet: FleetState,
                           deltas: torch.Tensor) -> torch.Tensor:
    """LeastRequested+Balanced over the fleet's percent columns for (6,)
    or (B, 6) delta rows: (N,) or (B, N)."""
    d = deltas[..., None]
    cpu_free = (100.0 - fleet.cpu_pct - d[..., 0, :]) / 100.0
    mem_free = (100.0 - fleet.mem_pct - d[..., 1, :]) / 100.0
    least_requested = 10.0 * (cpu_free + mem_free) / 2.0
    balanced = 10.0 * (1.0 - torch.abs(cpu_free - mem_free))
    return least_requested + balanced


def heuristic_score(fleet: Fleet, pod: Workload, *,
                    cfg: Optional[EnvConfig] = None) -> torch.Tensor:
    """(N,) kube-style LeastRequested+Balanced scores — no Q-net involved;
    the graceful-degradation fallback.  Pod fields of shape (B, 1) give
    (B, N) on a ClusterState."""
    if isinstance(fleet, ClusterState):
        _need_cfg(cfg)
        cpu_free = ((fleet.cpu_capacity - fleet.cpu_requested
                     - pod.cpu_request) / fleet.cpu_capacity)
        mem_free = ((fleet.mem_capacity - fleet.mem_requested
                     - pod.mem_request) / fleet.mem_capacity)
        least_requested = 10.0 * (cpu_free + mem_free) / 2.0
        balanced = 10.0 * (1.0 - torch.abs(cpu_free - mem_free))
        return least_requested + balanced
    if isinstance(fleet, FleetState):
        return heuristic_delta_scores(
            fleet, _pl.job_delta(pod, fleet.cpu_pct.device))
    raise TypeError(f"unsupported fleet type: {type(fleet).__name__}")


def topsis_score(fleet: Fleet, pod: Workload, *,
                 cfg: Optional[EnvConfig] = None,
                 weights=None) -> torch.Tensor:
    """(N,) TOPSIS closeness coefficients: the multi-objective non-RL
    baseline (``sched.topsis``: CPU / memory / wake-energy / imbalance cost
    columns, distance-to-ideal ranking).  Same substrate dispatch as
    ``heuristic_score``; higher = better, feasibility masked by the
    caller."""
    from repro_torch.sched import topsis as _topsis

    weights = _topsis.DEFAULT_WEIGHTS if weights is None else weights
    return _topsis.topsis_scores(fleet, pod, cfg=cfg, weights=weights)


def scores_valid(q: torch.Tensor) -> torch.Tensor:
    """0-d bool: all scores finite and inside ``DIVERGENCE_LIMIT``."""
    return torch.all(torch.isfinite(q) & (torch.abs(q) <= DIVERGENCE_LIMIT))


def _fleet_mode(fused) -> Optional[str]:
    """Map the uniform ``fused`` knob onto ``ops.sdqn_score_delta`` modes."""
    if fused == "auto" or fused is True:
        return None          # the kernel on the card, its twin on the CPU
    if fused == "plain":
        return "plain"
    if fused is False:
        return "ref"
    raise ValueError(f"fused must be one of {schedulers.FUSED_CHOICES}; "
                     f"got {fused!r}")


def _fleet_policy_score(fleet: FleetState, deltas: torch.Tensor, params: dict,
                        policy, embed=None, fused="auto") -> torch.Tensor:
    """FleetState scoring through a non-fusable policy class: the (B, N, 6)
    afterstate rows the column kernel builds in-kernel, with ``embed``
    appended for sequence specs, through ``policy.score_set`` — (6,) delta
    -> (N,), (B, 6) deltas -> (B, N), one ``score_set`` call."""
    feats = _pl.afterstate_rows(fleet, deltas.reshape(-1, 6))
    q = policy.score_set(params, schedulers.with_embed(feats, embed),
                         mode=schedulers.policy_mode(fused))
    return q[0] if deltas.dim() == 1 else q


def _fleet_scores(fleet: FleetState, deltas: torch.Tensor, params: dict,
                  fused, policy, embed) -> torch.Tensor:
    """The FleetState arm of ``score`` / ``score_batch``."""
    spec = schedulers.check_scorer(fused, None, policy, embed)
    if spec is not None:
        return _fleet_policy_score(fleet, deltas, params, spec, embed, fused)
    return ops.sdqn_score_delta(_pl.fleet_cols(fleet), deltas, params,
                                mode=_fleet_mode(fused))


def _fleet_size(fleet: Fleet) -> int:
    if isinstance(fleet, ClusterState):
        return fleet.n_nodes
    if isinstance(fleet, FleetState):
        return fleet.cpu_pct.shape[0]
    raise TypeError(f"unsupported fleet type: {type(fleet).__name__}")


def _no_fleet_score_fn(score_fn) -> None:
    if score_fn is not None:
        raise ValueError("score_fn is not supported on the FleetState "
                         "column-kernel path")


def _score_raw(fleet: Fleet, pod: Workload, *, params: dict,
               cfg: Optional[EnvConfig] = None, fused="auto", policy=None,
               embed=None, score_fn=None) -> torch.Tensor:
    if isinstance(fleet, ClusterState):
        _need_cfg(cfg)
        return schedulers.score_afterstates(params, fleet, pod, cfg,
                                            fused=fused, score_fn=score_fn,
                                            policy=policy, embed=embed)
    if isinstance(fleet, FleetState):
        _no_fleet_score_fn(score_fn)
        return _fleet_scores(fleet, _pl.job_delta(pod, fleet.cpu_pct.device),
                             params, fused, policy, embed)
    raise TypeError(f"unsupported fleet type: {type(fleet).__name__}")


def score(fleet: Fleet, pod: Workload, *, params: dict,
          cfg: Optional[EnvConfig] = None, fused="auto", shard="auto",
          score_fn=None, policy=None, embed=None,
          guard: bool = False) -> torch.Tensor:
    """(N,) Q-scores of placing ``pod`` on each target in ``fleet``.

    With a resolved ``shard`` layout the vector is computed shard by
    shard (for the "attention" class that is attention within each
    shard, as in the reference).  ``guard=True`` swaps the WHOLE vector
    for ``heuristic_score`` when any score is NaN/inf or beyond
    ``DIVERGENCE_LIMIT``."""
    from repro_torch.sched import shard as _shard

    layout = _shard.resolve_layout(shard, _fleet_size(fleet))
    if layout is None:
        q = _score_raw(fleet, pod, params=params, cfg=cfg, fused=fused,
                       policy=policy, embed=embed, score_fn=score_fn)
    else:
        q = _shard.sharded_scores(fleet, pod, params=params, cfg=cfg,
                                  layout=layout, fused=fused,
                                  score_fn=score_fn, policy=policy,
                                  embed=embed)
    if not guard:
        return q
    return torch.where(scores_valid(q), q, heuristic_score(fleet, pod, cfg=cfg))


def score_batch(fleet: Fleet, pods, *, params: dict,
                cfg: Optional[EnvConfig] = None, fused="auto",
                score_fn=None, policy=None, embed=None) -> torch.Tensor:
    """(B, N) Q-scores for a batch of workloads against ONE fleet: a
    ``PodSpec`` of (B,) fields (ClusterState) or a sequence of B
    ``JobSpec``s (FleetState) — one kernel launch for the batch.
    ``embed``: (E,) or (B, E) for a sequence policy."""
    if isinstance(fleet, ClusterState):
        _need_cfg(cfg)
        return schedulers.score_afterstates_batch(
            params, fleet, pods, cfg, fused=fused, score_fn=score_fn,
            policy=policy, embed=embed)
    if isinstance(fleet, FleetState):
        _no_fleet_score_fn(score_fn)
        return _fleet_scores(fleet, _pl.job_deltas(pods, fleet.cpu_pct.device),
                             params, fused, policy, embed)
    raise TypeError(f"unsupported fleet type: {type(fleet).__name__}")


def _feasible(fleet: Fleet, pod: Workload, cfg, params: dict) -> torch.Tensor:
    if isinstance(fleet, ClusterState):
        return kenv.feasible(fleet, pod, cfg)
    return _pl.PlacementEngine(params).feasible(fleet, pod)


def topk(fleet: Fleet, pod: Workload, *, params: dict,
         cfg: Optional[EnvConfig] = None, k: int = 4, fused="auto",
         shard="auto", score_fn=None, policy=None, embed=None):
    """The ``k`` best feasible targets: ``(values, indices)`` sorted
    descending, ties by ascending index, ``-inf`` / ``-1`` on infeasible
    slots.  With a resolved shard layout this is the two-stage path and
    holds up to ``shards * k`` entries."""
    from repro_torch.sched import shard as _shard

    n = _fleet_size(fleet)
    layout = _shard.resolve_layout(shard, n)
    if layout is not None:
        return _shard.topk(fleet, pod, params=params, cfg=cfg, layout=layout,
                           k=k, fused=fused, score_fn=score_fn, policy=policy,
                           embed=embed)
    q = _score_raw(fleet, pod, params=params, cfg=cfg, fused=fused,
                   policy=policy, embed=embed, score_fn=score_fn)
    ok = _feasible(fleet, pod, cfg, params)
    masked = torch.where(ok, q, -torch.inf)
    vals, pos = torch.sort(masked, descending=True, stable=True)
    k = max(1, min(k, n))
    vals, pos = vals[:k], pos[:k].to(torch.int32)
    return vals, torch.where(torch.isfinite(vals), pos, -1)


def select(fleet: Fleet, pod: Workload, *, params: dict,
           cfg: Optional[EnvConfig] = None, fused="auto", shard="auto",
           score_fn=None, policy=None, embed=None,
           guard: bool = False) -> torch.Tensor:
    """Greedy feasible argmax over ``score``; ``NO_PLACEMENT`` if none fit
    (int32 0-d tensor; ties break to the lowest index).  With a resolved
    ``shard`` layout selection goes through the two-stage candidate merge
    and gives the same winner."""
    from repro_torch.sched import shard as _shard

    layout = _shard.resolve_layout(shard, _fleet_size(fleet))
    if layout is not None:
        return _shard.select_candidates(fleet, pod, params=params, cfg=cfg,
                                        layout=layout, fused=fused,
                                        score_fn=score_fn, policy=policy,
                                        embed=embed, guard=guard)
    q = score(fleet, pod, params=params, cfg=cfg, fused=fused, shard=False,
              score_fn=score_fn, policy=policy, embed=embed, guard=guard)
    return schedulers.masked_argmax(None, q, _feasible(fleet, pod, cfg,
                                                       params))
