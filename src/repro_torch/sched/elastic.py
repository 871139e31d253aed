"""Elastic consolidation: the SDQN-n green pass inside an episode (port of
``repro.sched.elastic.make_consolidator``).

The paper's headline SDQN-n result is that consolidating compute-intensive
pods onto fewer nodes lets idle nodes be powered down (§1 contribution 2,
§6).  ``make_consolidator`` is that policy as a fixed-shape pass
``(state, ledger) -> (state, ledger, moved)`` that ``env.run_episode``
runs every ``cfg.consolidate_every_s`` seconds of episode time, over every
cluster of a batch at once.  The host-side planner of the job->host
substrate (``consolidation_plan``) is not ported yet (ROADMAP.md, queue 1,
'Serving, rest').
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import env as kenv, schedulers
from repro_torch.core.types import ClusterState, EnvConfig, PodLedger, PodSpec

PLAN_QUEUE_ITEM = ("consolidation_plan (job->host drain proposals) is not "
                   "ported yet: see ROADMAP.md, queue 1, 'Serving, rest'")


def _at(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``col[..., idx]`` per cluster: ``col (..., K)``, ``idx (...)``."""
    return torch.take_along_dim(col, idx[..., None], dim=-1)[..., 0]


def make_consolidator(qparams: dict, cfg: EnvConfig, max_migrations: int = 4,
                      idle_threshold: int = 2, score_fn: Callable = None,
                      fused="auto") -> Callable:
    """``consolidate(state, ledger) -> (state, ledger, moved)`` over
    clusters ``(..., N)`` and ledgers ``(..., K)``.  Each of the
    ``max_migrations`` sub-steps, per cluster:

      1. the drain source: the healthy node with the fewest (but > 0)
         experiment pods, at most ``idle_threshold`` of them (the lowest
         index among equals);
      2. the live ledger pod on it with the most remaining runtime
         (migrating a pod about to finish buys nothing);
      3. every candidate target scored through ``schedulers.score_states``
         (kernel 1 from ``FUSED_SCORE_MIN_NODES`` nodes up, or
         ``score_fn``) and the argmax taken among feasible nodes other
         than the source that are at least as loaded as the source was,
         so the pass is monotone and cannot ping-pong;
      4. the pod re-bound there (start costs apply) and its ledger row
         rewritten, keeping its expiry.

    A sub-step with no source, pod or target leaves that cluster as it
    was.  Shapes are fixed and nothing is read back to the host, except
    kernel 1's pull-contention scalar (one per cluster a sub-step at
    fleet scale)."""

    def migrate_once(st: ClusterState, led: PodLedger, moved: torch.Tensor):
        exp = st.exp_pods
        n = st.n_nodes
        nodes = torch.arange(n, device=exp.device)
        drainable = st.healthy & (exp > 0) & (exp <= idle_threshold)
        src = torch.argmin(torch.where(drainable, exp,
                                       torch.iinfo(torch.int32).max), dim=-1)
        on_src = led.node == src[..., None]
        row = torch.argmax(torch.where(on_src, led.expiry_s, -torch.inf),
                           dim=-1)
        pod = PodSpec(*(_at(c, row) for c in led.spec))

        st_rm = kenv.remove_pod(st, src, pod)
        ok = kenv.feasible(st_rm, schedulers.pod_rows(pod, exp), cfg)
        ok = ok & (nodes != src[..., None])
        # monotone: only onto nodes at least as loaded as the source was
        ok = ok & (st_rm.exp_pods >= _at(exp, src)[..., None])
        q = schedulers.score_states(qparams, st_rm, pod, cfg, fused=fused,
                                    score_fn=score_fn)
        tgt = torch.argmax(torch.where(ok, q, -torch.inf), dim=-1)

        do = (torch.any(drainable, dim=-1) & torch.any(on_src, dim=-1)
              & torch.any(ok, dim=-1))
        st = kenv.where_tree(do, kenv.place(st_rm, tgt, pod, cfg), st)
        node = torch.where(do, tgt.to(led.node.dtype), _at(led.node, row))
        led = led._replace(node=led.node.scatter(-1, row[..., None],
                                                 node[..., None]))
        return st, led, moved + do.to(torch.int32)

    def consolidate(state: ClusterState, ledger: PodLedger):
        moved = torch.zeros(state.time_s.shape, dtype=torch.int32,
                            device=state.time_s.device)
        for _ in range(max_migrations):
            state, ledger, moved = migrate_once(state, ledger, moved)
        return state, ledger, moved

    return consolidate


def consolidation_plan(*args, **kwargs):
    raise NotImplementedError(PLAN_QUEUE_ITEM)
