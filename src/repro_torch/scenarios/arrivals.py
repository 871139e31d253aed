"""Arrival-stream adapter: pod tables -> daemon request traces (port).

Converts a sampled ``PodTable`` into an ``ArrivalTrace`` — absolute arrival
offsets plus per-request ``PodSpec``s of Python floats — optionally
rescaled to a target offered rate, ready for ``daemon.replay_trace``.

    trace = arrival_trace(gen, cfg, n_pods=500, rate_per_s=2000.0)
    replay_trace(daemon, trace.t_s, trace.pods)
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch.core import env as kenv
from repro_torch.core.types import EnvConfig, PodSpec

__all__ = ["ArrivalTrace", "arrival_trace", "trace_from_table"]


class ArrivalTrace(NamedTuple):
    """A serving request trace: request i arrives ``t_s[i]`` seconds after
    the trace starts and asks to place ``pods[i]``."""

    t_s: np.ndarray          # (n,) float64, non-decreasing, t_s[0] == 0
    pods: List[PodSpec]      # n scalar PodSpecs (python floats)

    @property
    def offered_rate_per_s(self) -> float:
        """Mean offered arrival rate over the trace (requests/sec)."""
        span = float(self.t_s[-1]) if len(self.t_s) > 1 else 0.0
        return float(len(self.t_s) - 1) / span if span > 0 else float("inf")


def trace_from_table(table, rate_per_s: float | None = None) -> ArrivalTrace:
    """Turn a sampled ``PodTable`` into an ``ArrivalTrace``.

    Gaps become absolute offsets with the first arrival at t=0;
    ``rate_per_s`` rescales the time axis to that mean offered rate, keeping
    the arrival process's shape (a pure burst is spread at exactly it)."""
    dt = np.asarray(torch.as_tensor(table.dt_s).cpu(), np.float64)
    t = np.cumsum(dt) - float(dt[0])
    if rate_per_s is not None:
        if rate_per_s <= 0:
            raise ValueError("rate_per_s must be positive")
        span = float(t[-1])
        if span > 0:
            t = t * ((len(t) - 1) / (span * rate_per_s))
        else:  # pure burst: spread at exactly the offered rate
            t = np.arange(len(t), dtype=np.float64) / rate_per_s
    specs = PodSpec(*(np.asarray(torch.as_tensor(x).cpu()) for x in table.specs))
    pods = [
        PodSpec(cpu_request=float(specs.cpu_request[i]),
                cpu_demand=float(specs.cpu_demand[i]),
                mem_request=float(specs.mem_request[i]),
                mem_demand=float(specs.mem_demand[i]))
        for i in range(len(t))
    ]
    return ArrivalTrace(t_s=t, pods=pods)


def arrival_trace(gen: torch.Generator, cfg: EnvConfig, n_pods: int,
                  rate_per_s: float | None = None) -> ArrivalTrace:
    """Sample an arrival stream as a daemon request trace (host-side: the
    trace is a list of Python floats whichever device serves it)."""
    return trace_from_table(kenv.sample_pod_table(gen, cfg, n_pods,
                                                  device="cpu"),
                            rate_per_s=rate_per_s)
