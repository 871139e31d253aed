"""Reward functions — paper Tables 3 (SDQN) and 5 (SDQN-n), PyTorch port.

Both operate on the *afterstate*: the cluster right after the pod was
bound.  ``feats`` rows are the Table-2 features in raw units (percentages,
hours, counts).  Every function takes leading batch dimensions (seeds,
envs): ``after_feats (..., N, 6)``, ``action (...)``, masks and pod counts
``(..., N)``, and returns ``(...)``.  ``action == -1`` (a dropped arrival)
reads the LAST node's row, as the reference's negative index does; the
trainer zero-weights such transitions.

Table 5's SDQN-n row is truncated in the paper; the reference implements
the only reading consistent with its goal and Table-10 distributions:
top-2 = the two candidate nodes with the most running pods (ties to the
lower index, as ``jax.lax.top_k``).
"""
from __future__ import annotations

import torch

BASE_POINTS = 100.0


def _resource_points(pct: torch.Tensor) -> torch.Tensor:
    """>70%: -2/percent above; 40–70%: +10; otherwise (<40%): -10."""
    return torch.where(pct > 70.0, -2.0 * (pct - 70.0),
                       torch.where(pct >= 40.0, 10.0,
                              torch.full_like(pct, -10.0)))


def node_points(feats_row: torch.Tensor) -> torch.Tensor:
    """Shared per-node terms of Tables 3/5 (all but distribution):
    ``(..., 6)`` rows -> ``(...)``."""
    cpu, mem, pod_util, health, uptime = (feats_row[..., i] for i in range(5))
    zero = torch.zeros_like(cpu)
    pts = torch.full_like(cpu, BASE_POINTS)
    pts = pts + torch.where(health < 0.5, -100.0, zero)
    pts = pts + _resource_points(cpu)
    pts = pts + _resource_points(mem)
    pts = pts + torch.where((pod_util >= 60.0) & (pod_util <= 90.0), 20.0,
                       torch.full_like(cpu, -10.0))
    pts = pts + torch.where(uptime >= 24.0, 5.0, torch.full_like(cpu, -5.0))
    return pts


def _node_index(action, n: int) -> torch.Tensor:
    """``action (...)`` as a gather index: -1 wraps to the last node."""
    a = torch.as_tensor(action).to(torch.int64)
    return torch.where(a < 0, a + n, a)


def _row(x: torch.Tensor, action) -> torch.Tensor:
    """``x (..., N, F)`` at node ``action (...)`` -> ``(..., F)``."""
    idx = _node_index(action, x.shape[-2])[..., None, None]
    return torch.take_along_dim(x, idx.to(x.device), dim=-2)[..., 0, :]


def _at(x: torch.Tensor, action) -> torch.Tensor:
    """``x (..., N)`` at node ``action (...)`` -> ``(...)``."""
    idx = _node_index(action, x.shape[-1])[..., None]
    return torch.take_along_dim(x, idx.to(x.device), dim=-1)[..., 0]


def _efficiency_delta(after_feats, before_feats) -> torch.Tensor:
    return (torch.mean(after_feats[..., 0], dim=-1)
            - torch.mean(before_feats[..., 0], dim=-1))


def sdqn_reward(after_feats: torch.Tensor, action, exp_pods=None,
                efficiency_weight: float = 0.0,
                before_feats=None) -> torch.Tensor:
    """Table 3: the chosen node's points plus +5 for each node running the
    experiment's pods after the placement.  ``efficiency_weight`` > 0 adds
    the paper's objective (minimize cluster-average CPU) as the shaped term
    ``-w * (mean cpu after - mean cpu before)``."""
    chosen = _row(after_feats, action)
    dist_src = exp_pods if exp_pods is not None else after_feats[..., 5]
    n_distributed = torch.sum(dist_src > 0, dim=-1).to(torch.float32)
    pts = node_points(chosen) + 5.0 * n_distributed
    if efficiency_weight and before_feats is not None:
        pts = pts - efficiency_weight * _efficiency_delta(after_feats,
                                                          before_feats)
    return pts


def sdqn_n_reward(after_feats: torch.Tensor, before_feats: torch.Tensor,
                  feasible_mask: torch.Tensor, action, n: int = 2,
                  exp_pods_before=None,
                  efficiency_weight: float = 0.0) -> torch.Tensor:
    """Table 5 (n=2): with >= n candidate nodes, +20 for a placement on
    one of the top-n candidates by the experiment's running pods, -50
    outside; with fewer, +20 if the chosen node already runs our pods,
    else -10."""
    chosen = _row(after_feats, action)
    pts = node_points(chosen)
    n_candidates = torch.sum(feasible_mask, dim=-1)
    pods_before = (exp_pods_before.to(torch.float32)
                   if exp_pods_before is not None else before_feats[..., 5])
    ranked = torch.where(feasible_mask, pods_before,
                         torch.full_like(pods_before, -torch.inf))
    # top-n with ties to the lower index: a stable descending sort
    top_idx = torch.sort(ranked, dim=-1, descending=True,
                         stable=True).indices[..., :n]
    act = torch.as_tensor(action, device=top_idx.device)
    in_top_n = torch.any(top_idx == act[..., None].to(top_idx.dtype), dim=-1)
    consolidated = torch.where(in_top_n, 20.0, torch.full_like(pts, -50.0))
    fallback = torch.where(_at(pods_before, action) > 0.0, 20.0,
                      torch.full_like(pts, -10.0))
    pts = pts + torch.where(n_candidates >= n, consolidated, fallback)
    if efficiency_weight:
        pts = pts - efficiency_weight * _efficiency_delta(after_feats,
                                                          before_feats)
    return pts


def energy_term(exp_pods_before: torch.Tensor,
                exp_pods_after: torch.Tensor) -> torch.Tensor:
    """Active-node delta of one placement: +1 when it woke an idle node."""
    before = torch.sum(exp_pods_before > 0, dim=-1).to(torch.float32)
    after = torch.sum(exp_pods_after > 0, dim=-1).to(torch.float32)
    return after - before


def _validate_energy_weight(w) -> float:
    """Coerce ``energy_weight`` to a plain float; reject bools, tensors and
    arrays, and values < 0."""
    if isinstance(w, bool) or not isinstance(w, (int, float)):
        raise TypeError(
            f"energy_weight must be a plain Python number, got {type(w).__name__}")
    w = float(w)
    if w < 0.0:
        raise ValueError(f"energy_weight must be >= 0, got {w}")
    return w


def make_reward_fn(variant: str = "sdqn", consolidation_n: int = 2,
                   efficiency_weight: float = 0.0,
                   energy_weight: float = 0.0):
    """Uniform reward interface of the training loop:

        fn(after_feats, before_feats, ok, action, exp_pods_before, exp_pods_after)

    ``energy_weight`` > 0 charges that many points per node a placement
    newly activates (``energy_term``); it must be a plain non-negative
    Python number (0.0 disables the term)."""
    energy_weight = _validate_energy_weight(energy_weight)
    if variant == "sdqn":

        def base_fn(after_feats, before_feats, ok, action, exp_pods_before,
                    exp_pods_after):
            return sdqn_reward(after_feats, action, exp_pods=exp_pods_after,
                               efficiency_weight=efficiency_weight,
                               before_feats=before_feats)

    elif variant == "sdqn_n":

        def base_fn(after_feats, before_feats, ok, action, exp_pods_before,
                    exp_pods_after):
            return sdqn_n_reward(after_feats, before_feats, ok, action,
                                 consolidation_n,
                                 exp_pods_before=exp_pods_before,
                                 efficiency_weight=efficiency_weight)

    else:
        raise ValueError(f"unknown reward variant: {variant!r}")

    if energy_weight == 0.0:
        return base_fn

    def fn(after_feats, before_feats, ok, action, exp_pods_before,
           exp_pods_after):
        pts = base_fn(after_feats, before_feats, ok, action,
                      exp_pods_before, exp_pods_after)
        return pts - energy_weight * energy_term(exp_pods_before,
                                                 exp_pods_after)

    return fn
