"""Elastic consolidation (port of ``repro.sched.elastic``): SDQN-n-style
packing turned into green scale-down.

The paper's headline SDQN-n result is that consolidating compute-intensive
pods onto fewer nodes lets idle nodes be powered down (§1 contribution 2,
§6).  ``make_consolidator`` is that policy as a fixed-shape pass
``(state, ledger) -> (state, ledger, moved)`` that ``env.run_episode``
runs every ``cfg.consolidate_every_s`` seconds of episode time, over every
cluster of a batch at once.  ``consolidation_plan`` proposes the same at
fleet scale on the job->host substrate: which hosts can be drained and
powered down, where their jobs go, and the projected fleet-average
utilization.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List

import numpy as np
import torch

from repro_torch.core import env as kenv, schedulers
from repro_torch.core.types import ClusterState, EnvConfig, PodLedger, PodSpec
from repro_torch.sched.placement import (JOB_UTIL_DELTA_PCT, FleetState,
                                         JobSpec, PlacementEngine)


@dataclasses.dataclass
class ConsolidationPlan:
    drain_hosts: List[int]                # hosts whose jobs should migrate
    target_hosts: List[int]               # where they go
    migrations: List[tuple]               # (job_host_before, job_host_after)
    projected_avg_cpu_before: float
    projected_avg_cpu_after: float
    hosts_freed: int


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
        pod = PodSpec(*(kenv.take_last(c, row) for c in led.spec))

        st_rm = kenv.remove_pod(st, src, pod)
        ok = kenv.feasible(st_rm, schedulers.pod_rows(pod, exp), cfg)
        ok = ok & (nodes != src[..., None])
        # monotone: only onto nodes at least as loaded as the source was
        ok = ok & (st_rm.exp_pods >= kenv.take_last(exp, src)[..., None])
        q = schedulers.score_states(qparams, st_rm, pod, cfg, fused=fused,
                                    score_fn=score_fn)
        tgt = torch.argmax(torch.where(ok, q, -torch.inf), dim=-1)

        do = (torch.any(drainable, dim=-1) & torch.any(on_src, dim=-1)
              & torch.any(ok, dim=-1))
        st = kenv.where_tree(do, kenv.place(st_rm, tgt, pod, cfg), st)
        node = torch.where(do, tgt.to(led.node.dtype),
                           kenv.take_last(led.node, row))
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


def _host_col(col: torch.Tensor, host: int, value) -> torch.Tensor:
    """``col`` with entry ``host`` set to ``value`` (a new tensor: the
    caller's fleet is never written)."""
    hit = torch.arange(col.shape[0], device=col.device) == host
    return torch.where(hit, torch.as_tensor(value, dtype=col.dtype,
                                            device=col.device), col)


def consolidation_plan(engine: PlacementEngine, fleet: FleetState,
                       job: JobSpec,
                       idle_threshold_jobs: int = 3) -> ConsolidationPlan:
    """Propose migrating jobs off nearly-idle hosts with the engine's
    (SDQN-n) policy.

    Hosts with 1 to ``idle_threshold_jobs`` jobs are drain candidates, in
    host order; each of their jobs is re-placed through ``engine.select``
    (one launch of the column kernel a job on the card) with the candidate
    itself excluded, and the host is freed only if every job found a new
    home.  A host-side loop: each job reads its target and whether its
    score is finite back to the host, as the reference does."""
    before = float(torch.mean(fleet.cpu_pct))
    num_jobs = fleet.num_jobs.cpu().numpy()
    drain = [int(i) for i in np.nonzero(
        (num_jobs > 0) & (num_jobs <= idle_threshold_jobs))[0]]
    n = fleet.cpu_pct.shape[0]
    migrations, freed = [], []
    cur = fleet
    for host in drain:
        jobs_here = int(num_jobs[host])
        moved = []
        # exclude the host itself as a target
        trial = cur._replace(healthy=_host_col(cur.healthy, host, 0.0))
        ok_all = True
        for _ in range(jobs_here):
            tgt, scores = engine.select(trial, job)
            tgt = int(tgt)
            if not bool(torch.isfinite(scores[tgt])):
                ok_all = False
                break
            trial = engine.place(trial, tgt, job)
            moved.append((host, tgt))
        if ok_all and moved:
            # commit: take the jobs off the drained host, restore its flag
            onehot = (torch.arange(n, device=fleet.cpu_pct.device)
                      == host).to(torch.float32)
            trial = trial._replace(
                cpu_pct=trial.cpu_pct
                - onehot * job.cpu_pct_demand * jobs_here,
                mem_pct=trial.mem_pct
                - onehot * job.mem_pct_demand * jobs_here,
                job_util_pct=trial.job_util_pct
                - onehot * JOB_UTIL_DELTA_PCT * jobs_here,
                num_jobs=trial.num_jobs - (onehot * jobs_here).to(torch.int32),
                healthy=cur.healthy,
            )
            cur = trial
            migrations.extend(moved)
            freed.append(host)
    return ConsolidationPlan(
        drain_hosts=freed,
        target_hosts=sorted({t for _, t in migrations}),
        migrations=migrations,
        projected_avg_cpu_before=before,
        projected_avg_cpu_after=float(torch.mean(cur.cpu_pct)),
        hosts_freed=len(freed),
    )
