"""Comparison schedulers from the paper (PyTorch port), the default
kube-scheduler: the filter phase, then the two classic priorities the
paper's §3.2 describes (LeastRequestedPriority + BalancedResourceAllocation)
with a random tie-break among the top scorers ("selected at random").  The
LSTM and Transformer scorers (Tables 6/7) wait for their slice (ROADMAP.md,
queue 1, 'Paper baselines').
"""
from __future__ import annotations

import torch

from repro_torch.core import env as kenv
from repro_torch.core.schedulers import pod_rows
from repro_torch.core.types import NO_PLACEMENT, ClusterState, EnvConfig, PodSpec


def kube_scores(state: ClusterState, pod: PodSpec, cfg: EnvConfig) -> torch.Tensor:
    """Scoring phase on *requested* resources (what kube-scheduler sees):
    ``(..., N)`` for clusters ``(..., N)``, one pod each."""
    p = pod_rows(pod, state.base_cpu)
    cpu_free = ((state.cpu_capacity - state.cpu_requested - p.cpu_request)
                / state.cpu_capacity)
    mem_free = ((state.mem_capacity - state.mem_requested - p.mem_request)
                / state.mem_capacity)
    least_requested = 10.0 * (cpu_free + mem_free) / 2.0
    balanced = 10.0 * (1.0 - torch.abs(cpu_free - mem_free))
    return least_requested + balanced


def kube_select(step, state: ClusterState, pod: PodSpec,
                cfg: EnvConfig) -> torch.Tensor:
    """Filter, score, and a uniform tie-break (``step.tiebreak``) among the
    scores within 1e-6 of the best; ``NO_PLACEMENT`` where nothing fits
    (the tie-break would otherwise bind to a random infeasible node)."""
    ok = kenv.feasible(state, pod_rows(pod, state.base_cpu), cfg)
    neg = torch.full(ok.shape, -torch.inf, dtype=torch.float32,
                     device=ok.device)
    scores = torch.where(ok, kube_scores(state, pod, cfg), neg)
    top = ok & (scores >= torch.amax(scores, dim=-1, keepdim=True) - 1e-6)
    noise = step.tiebreak(state.n_nodes).to(ok.device)
    choice = torch.argmax(torch.where(top, noise, neg), dim=-1).to(torch.int32)
    return torch.where(torch.any(ok, dim=-1), choice, NO_PLACEMENT)
