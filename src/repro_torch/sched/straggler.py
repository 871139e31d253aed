"""Straggler detection, evacuation and recovery (port of
``repro.sched.straggler``).

A host whose recent step times drift beyond ``threshold`` x the fleet
median is declared a straggler; ``evacuate`` marks it unhealthy and
re-places its jobs through ``sched.api.select`` (the column kernel at
B = 1 on the card): the Table-3 health term keeps unhealthy hosts from
being chosen, so evacuation and avoidance share one mechanism.
Evacuated hosts are tracked, and ``recover`` marks them healthy again once
their fresh step times come back under the straggler line.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from repro_torch.core.types import NO_PLACEMENT
from repro_torch.sched import api
from repro_torch.sched.elastic import _host_col
from repro_torch.sched.placement import (JOB_UTIL_DELTA_PCT, FleetState,
                                         JobSpec, PlacementEngine)


class StragglerMonitor:
    def __init__(self, window: int = 16, threshold: float = 1.8):
        self.window = window
        self.threshold = threshold
        self._times: Dict[int, collections.deque] = {}
        self._evacuated: Set[int] = set()

    def record(self, host: int, step_time_s: float):
        self._times.setdefault(host, collections.deque(
            maxlen=self.window)).append(step_time_s)

    def _medians(self) -> Dict[int, float]:
        return {h: float(np.median(t)) for h, t in self._times.items()
                if len(t) >= 4}

    def stragglers(self) -> List[int]:
        if not self._times:
            return []
        medians = self._medians()
        if len(medians) < 2:
            return []
        fleet_median = float(np.median(list(medians.values())))
        return [h for h, m in medians.items()
                if m > self.threshold * fleet_median]

    @property
    def evacuated(self) -> List[int]:
        """Hosts currently marked unhealthy by an ``evacuate`` call."""
        return sorted(self._evacuated)

    def evacuate(self, engine: PlacementEngine, fleet: FleetState,
                 job: JobSpec, hosts: Optional[List[int]] = None) -> tuple:
        """Mark stragglers (or ``hosts``) unhealthy and re-place their jobs
        through ``api.select`` with the engine's params; returns
        ``(new_fleet, migrations)``.  Jobs that find no feasible host drain
        off with their host (no migration recorded); the host's step
        samples are cleared so that ``recover`` judges it on fresh times
        only."""
        hosts = self.stragglers() if hosts is None else hosts
        migrations = []
        n = fleet.cpu_pct.shape[0]
        for host in hosts:
            n_jobs = int(fleet.num_jobs[host])
            fleet = fleet._replace(healthy=_host_col(fleet.healthy, host,
                                                     0.0))
            self._evacuated.add(int(host))
            self._times.pop(int(host), None)
            for _ in range(n_jobs):
                tgt = int(api.select(fleet, job, params=engine.qparams,
                                     guard=True))
                if tgt == NO_PLACEMENT:
                    break
                fleet = engine.place(fleet, tgt, job)
                migrations.append((host, tgt))
            # the reference's numpy one-hot products, rounded to float32
            onehot = np.arange(n) == host
            dev = fleet.cpu_pct.device

            def off(x):
                return torch.from_numpy(x.astype(np.float32)).to(dev)

            fleet = fleet._replace(
                cpu_pct=fleet.cpu_pct - off(onehot * job.cpu_pct_demand
                                            * n_jobs),
                mem_pct=fleet.mem_pct - off(onehot * job.mem_pct_demand
                                            * n_jobs),
                job_util_pct=fleet.job_util_pct
                - off(onehot * JOB_UTIL_DELTA_PCT * n_jobs),
                num_jobs=fleet.num_jobs - torch.from_numpy(
                    (onehot * n_jobs).astype(np.int32)).to(dev),
            )
        return fleet, migrations

    def recover(self, fleet: FleetState,
                hosts: Optional[List[int]] = None) -> tuple:
        """Mark recovered hosts healthy again; returns ``(new_fleet,
        healed)``.  With ``hosts=None``, heals every evacuated host that
        has reported >= 4 fresh step samples whose median is back under the
        straggler line; explicit ``hosts`` force-heal."""
        if hosts is None:
            bad = set(self.stragglers())
            hosts = [h for h in sorted(self._evacuated)
                     if h in self._medians() and h not in bad]
        healed = []
        for host in hosts:
            fleet = fleet._replace(healthy=_host_col(fleet.healthy, host,
                                                     1.0))
            self._evacuated.discard(int(host))
            healed.append(int(host))
        return fleet, healed
