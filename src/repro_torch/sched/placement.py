"""SDQN-driven job->host placement (PyTorch port of ``repro.sched.placement``).

The Q-network that schedules pods schedules *jobs* (training replicas,
serving replicas, data workers) onto fleet hosts: host state maps onto the
six Table-2 features 1:1, and scoring runs through the column kernel
(``kernels.ops.sdqn_score_delta``, one launch for the whole fleet).

Dtypes: every column is float32 except ``num_jobs`` (int32); ``healthy``
is a float {0, 1}, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import env as kenv
from repro_torch.core.types import NO_PLACEMENT
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

# Job-slot ceiling per host (the Table-2 "pod utilization" analogue):
# ``job_util_pct`` advances by JOB_UTIL_DELTA_PCT per bound job.
MAX_JOBS_PER_HOST = 25.0
JOB_UTIL_DELTA_PCT = 100.0 / MAX_JOBS_PER_HOST

# select() sentinel: no feasible host, the job is not bound
NO_HOST = NO_PLACEMENT

# the three feasibility ceilings (cpu %, mem %, job-util %) as the device
# compares them: rounded to float32, so ``100 + 1e-6`` is exactly 100.0 there
# as in the reference's ``jnp.asarray(ceilings, float32)``
MEM_CEILING_PCT = 95.0
JOB_UTIL_CEILING_PCT = 100.0 + 1e-6


def f32_ceilings(max_host_cpu_pct: float) -> tuple:
    return tuple(float(np.float32(c)) for c in
                 (max_host_cpu_pct, MEM_CEILING_PCT, JOB_UTIL_CEILING_PCT))


class FleetState(NamedTuple):
    """Host fleet, vectorized: every field is (N,)."""

    cpu_pct: torch.Tensor       # current host utilization %
    mem_pct: torch.Tensor
    job_util_pct: torch.Tensor  # jobs / max_jobs * 100
    healthy: torch.Tensor       # {0, 1} float32
    uptime_hours: torch.Tensor
    num_jobs: torch.Tensor      # int32

    def features(self) -> torch.Tensor:
        """(N, 6) float32 raw Table-2 rows."""
        return torch.stack(fleet_cols(self), dim=-1)


@dataclasses.dataclass(frozen=True)
class JobSpec:
    cpu_pct_demand: float = 5.0     # host-% one job replica adds
    mem_pct_demand: float = 2.0
    kind: str = "train"             # train | serve | data


def fleet_cols(fleet: FleetState) -> tuple:
    """The six raw Table-2 feature columns as float32, for the column
    kernels (no copy for columns that are float32 already)."""
    return (fleet.cpu_pct, fleet.mem_pct, fleet.job_util_pct,
            fleet.healthy.to(torch.float32), fleet.uptime_hours,
            fleet.num_jobs.to(torch.float32))


def job_delta(job: JobSpec, device=None) -> torch.Tensor:
    """The (6,) afterstate delta one job adds to the six columns (matches
    ``place``, including the JOB_UTIL_DELTA_PCT advance of feature 3)."""
    return torch.tensor([job.cpu_pct_demand, job.mem_pct_demand,
                         JOB_UTIL_DELTA_PCT, 0.0, 0.0, 1.0],
                        dtype=torch.float32, device=device)


def job_deltas(jobs, device=None) -> torch.Tensor:
    """(B, 6) delta rows of a job sequence, in one host->device copy."""
    rows = np.asarray([[j.cpu_pct_demand, j.mem_pct_demand,
                        JOB_UTIL_DELTA_PCT, 0.0, 0.0, 1.0] for j in jobs],
                      np.float32)
    return torch.from_numpy(rows).to(device)


def afterstate_rows(fleet: FleetState, deltas: torch.Tensor) -> torch.Tensor:
    """(B, N, 6) normalized afterstate rows ``(cols + delta) / FEATURE_SCALE``
    for (B, 6) deltas: what the column kernel builds in-kernel, for the
    policy classes that score whole rows."""
    return ((torch.stack(fleet_cols(fleet), dim=-1)[None] + deltas[:, None, :])
            / kenv.FEATURE_SCALE.to(deltas.device))


def feasible_deltas(fleet: FleetState, deltas: torch.Tensor,
                    max_host_cpu_pct: float = 88.0) -> torch.Tensor:
    """``PlacementEngine.feasible`` for (6,) or (B, 6) deltas: (N,) or
    (B, N) bool."""
    c = f32_ceilings(max_host_cpu_pct)
    d = deltas[..., None]                        # (..., 6, 1)
    return ((fleet.healthy > 0.5)
            & (fleet.cpu_pct + d[..., 0, :] <= c[0])
            & (fleet.mem_pct + d[..., 1, :] <= c[1])
            & (fleet.job_util_pct + d[..., 2, :] <= c[2]))


class PlacementEngine:
    """Scores afterstates with a trained SDQN and binds jobs to hosts."""

    def __init__(self, qparams: dict, consolidate: bool = False,
                 max_host_cpu_pct: float = 88.0,
                 use_kernel: Optional[bool] = None):
        self.qparams = qparams
        self.consolidate = consolidate
        self.max_host_cpu_pct = max_host_cpu_pct
        # None: the default path (the kernel on the card, its plain
        # version on the CPU); True: the kernel path; False: the unfused ref
        self.use_kernel = use_kernel

    def _mode(self):
        return None if self.use_kernel in (None, True) else "ref"

    def _score(self, feats: torch.Tensor) -> torch.Tensor:
        """Q (N,) of built (N, 6) raw feature rows: one launch of the
        ``sdqn_score`` kernel on the card."""
        return ops.sdqn_score(kenv.normalize_features(feats), self.qparams,
                              mode=self._mode())

    def feasible(self, fleet: FleetState, job: JobSpec) -> torch.Tensor:
        """(N,) bool: healthy, and the job's cpu, mem and job slot within
        the host's ceilings (the job-slot one keeps job_util_pct <= 100)."""
        return feasible_deltas(fleet, job_delta(job, fleet.cpu_pct.device),
                               self.max_host_cpu_pct)

    def select(self, fleet: FleetState,
               job: JobSpec) -> Tuple[torch.Tensor, torch.Tensor]:
        """(host, masked scores): the host a 0-d int32 tensor on the
        fleet's device, ``NO_HOST`` when none fits — no host sync."""
        from repro_torch.sched import api  # lazy: api imports this module

        fused = False if self.use_kernel is False else "auto"
        scores = api.score(fleet, job, params=self.qparams, fused=fused)
        ok = self.feasible(fleet, job)
        scores = torch.where(ok, scores, torch.full_like(scores, -torch.inf))
        no_host = torch.tensor(NO_HOST, dtype=torch.int32,
                               device=scores.device)
        return torch.where(ok.any(), torch.argmax(scores).to(torch.int32),
                           no_host), scores

    def place(self, fleet: FleetState, host, job: JobSpec) -> FleetState:
        """Bind one job (``host`` an int or 0-d tensor; ``NO_HOST`` is a
        no-op) without a host sync."""
        onehot = (torch.arange(fleet.cpu_pct.shape[0],
                               device=fleet.cpu_pct.device) == host)
        w = onehot.to(torch.float32)
        return fleet._replace(
            cpu_pct=fleet.cpu_pct + w * job.cpu_pct_demand,
            mem_pct=fleet.mem_pct + w * job.mem_pct_demand,
            job_util_pct=fleet.job_util_pct + w * JOB_UTIL_DELTA_PCT,
            num_jobs=fleet.num_jobs + onehot.to(torch.int32),
        )

    def place_batch(self, fleet: FleetState, jobs: int,
                    job: JobSpec) -> Tuple[FleetState, np.ndarray]:
        hosts = []
        for _ in range(jobs):
            h, _ = self.select(fleet, job)
            fleet = self.place(fleet, h, job)
            hosts.append(h)
        return fleet, torch.stack(hosts).cpu().numpy()


def fresh_fleet(n_hosts: int, gen: torch.Generator,
                device=None) -> FleetState:
    """A healthy, empty fleet: cpu 2-10 %, mem 5 %, uptime 5-105 h, drawn
    from ``gen`` (a CPU generator) and moved to ``device``."""
    device = resolve_device(device)
    f32 = torch.float32
    cpu = 2.0 + 8.0 * torch.rand((n_hosts,), generator=gen, dtype=f32)
    up = 5.0 + 100.0 * torch.rand((n_hosts,), generator=gen, dtype=f32)
    return FleetState(
        cpu_pct=cpu.to(device),
        mem_pct=torch.full((n_hosts,), 5.0, dtype=f32, device=device),
        job_util_pct=torch.zeros((n_hosts,), dtype=f32, device=device),
        healthy=torch.ones((n_hosts,), dtype=f32, device=device),
        uptime_hours=up.to(device),
        num_jobs=torch.zeros((n_hosts,), dtype=torch.int32, device=device),
    )
