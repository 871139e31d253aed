"""Shared inputs and replay helpers of the port's daemon parity tests.

Fleets and request streams are made with numpy, so both packages get the
same ones; the clock and the deadline stopwatch are injected so both
daemons cut the same batches.
"""
import numpy as np

from repro_torch.core.types import NO_PLACEMENT


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class BreachTimer:
    """Deadline stopwatch: the scoring launch of batch ``breach`` appears to
    take 10 s, every other launch 0 s."""

    def __init__(self, breach):
        self.calls = 0
        self.breach = breach

    def __call__(self):
        c = self.calls
        self.calls += 1
        return 10.0 if (c // 2 == self.breach and c % 2 == 1) else 0.0


def fleet_np(n, seed, tight=False):
    """Job-fleet columns with infeasible hosts: unhealthy ones, cpu and mem
    near their ceilings, job slots nearly full (``tight``: 0-3 slots left
    on every host, so a batch's jobs collide)."""
    rng = np.random.default_rng(seed)
    jobs = rng.integers(22 if tight else 0, 26, n)
    return dict(cpu_pct=rng.uniform(2.0, 92.0, n).astype(np.float32),
                mem_pct=rng.uniform(2.0, 96.0, n).astype(np.float32),
                job_util_pct=(jobs * 4.0).astype(np.float32),
                healthy=(rng.random(n) > 0.15).astype(np.float32),
                uptime_hours=rng.uniform(1.0, 200.0, n).astype(np.float32),
                num_jobs=jobs.astype(np.int32))


def job_stream(n, seed):
    """(arrival offsets at ~500/s, [(cpu %, mem %)]) of ``n`` jobs."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.exponential(1 / 500.0, n))
    return t - t[0], list(zip(rng.uniform(1, 10, n).tolist(),
                              rng.uniform(0.5, 5, n).tolist()))


def drive(daemon, clock, t_s, reqs, fail_after=-1):
    """Submit ``reqs`` on their schedule, polling after each; after request
    ``fail_after`` fail the node of the first bound decision; then drain."""
    for i, (t, req) in enumerate(zip(t_s, reqs)):
        clock.t = float(t)
        daemon.submit(req, now=float(t))
        daemon.poll()
        if i == fail_after:
            bound = [d.node for d in daemon.decisions if d.node != NO_PLACEMENT]
            daemon.fail_node(bound[0])
    clock.t = float(t_s[-1]) + 1.0
    daemon.drain()
