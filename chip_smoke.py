#!/usr/bin/env python3
"""Run the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failed check raises and the run exits nonzero):

1. Device: the card's name and power limit (nvidia-smi), then the build of
   every CUDA kernel of the path from ``src/repro_torch/kernels/csrc``.
2. Kernels against their plain PyTorch versions on the card, at
   N in {1, 37, 1000, 5000, 131072} nodes x B in {1, 32} pods, on resets
   with unhealthy nodes and randomized workloads (rtol = atol = 1e-5), and
   up to N = 1000 also against the unfused oracle (``mode="ref"``).
3. Main path: ``PlacementDaemon`` over ``ClusterSubstrate(fleet_cluster(5000))``
   with ``DaemonConfig(batch_size=32, max_wait_s=0.005)`` replays 2,000
   requests from ``arrival_trace`` at 500/s and 4000/s offered.  Kernel
   launch counters are zeroed just before and read just after; every batch
   must be exactly one kernel launch.  Then the same trace, on a
   deterministic clock, through the kernel and through ``fused="plain"``:
   the decisions must agree except after a batch row whose two best
   feasible scores lie within the tolerance (such rows are counted).
4. Timings: kernel and plain-version device time (CUDA events around a
   CUDA graph of many calls) and eager per-call time, beside the least
   time the card could take (``bound_ms``), at N = 5000 and 131072, B = 32.
5. Breakdown: a 500-request replay at 4000/s with host-clock spans around
   each layer of a batch and torch.profiler's device time (busy share).

The line before last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``.  No CUDA device: exit 1, no result.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
RTOL = ATOL = 1e-5
SHAPES_N = (1, 37, 1000, 5000, 131072)
SHAPES_B = (1, 32)
MAIN_N, MAIN_B = 5000, 32
RATES_PER_S = (500.0, 4000.0)
N_REQUESTS = 2000

# H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the tensor cores
# and HBM3 bandwidth.  The PCIe and NVL parts are slower; see peaks().
PEAKS = {"sxm": (67e12, 3.35e12), "pcie": (51e12, 2.0e12),
         "nvl": (60e12, 3.9e12)}

# Operation count of the afterstate kernel, from its source: per (pod,
# node) 19 for the two pod-dependent features, 6 x 32 multiply-adds (384),
# 32 ReLUs, 32 multiply-adds into the output (64) and the b2 add; per node
# 8 for the pod-independent features.
OPS_PER_POD_NODE = 19 + 384 + 32 + 64 + 1
OPS_PER_NODE = 8
# bytes per node read once: 10 four-byte columns + 2 bool columns
BYTES_PER_NODE = 10 * 4 + 2 * 1
WEIGHT_BYTES = (6 * 32 + 32 + 32 + 1) * 4


def peaks(name: str):
    key = "pcie" if "PCIe" in name else "nvl" if "NVL" in name else "sxm"
    return key, PEAKS[key]


def bound_ms(n: int, b: int, name: str):
    """(ms, "bytes" | "operations"): the least time for one launch."""
    _, (flops, bw) = peaks(name)
    nbytes = n * BYTES_PER_NODE + b * 8 + WEIGHT_BYTES + b * n * 4
    ops = b * n * OPS_PER_POD_NODE + n * OPS_PER_NODE
    t_bytes, t_ops = nbytes / bw, ops / flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def cuda_time_ms(fn, iters: int, reps: int = 5) -> float:
    """Median over ``reps`` of (CUDA-event time of ``iters`` calls) / iters."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_time_ms(fn, iters: int, reps: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    replayed ``reps`` times between CUDA events (median / iters).  Unlike
    ``cuda_time_ms`` this leaves out the host's per-call cost, which at
    small N is larger than the kernel itself."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def make_case(n, b, device, seed):
    from repro_torch import convert
    from repro_torch.core import dqn, env
    from repro_torch.core.types import fleet_cluster

    cfg = dataclasses.replace(fleet_cluster(n), unhealthy_prob=0.2,
                              randomize_workload=True)
    gen = torch.Generator().manual_seed(seed)
    state = env.reset(gen, cfg, device=device)
    params = dqn.init_qnet(gen, device=device)
    rng = np.random.default_rng(seed)
    pods = convert.pods_from_numpy(rng.uniform(50, 900, b),
                                   rng.uniform(5, 700, b),
                                   rng.uniform(64, 2048, b),
                                   rng.uniform(32, 1800, b), device=device)
    return cfg, state, params, pods


def phase_kernels(device):
    from repro_torch.kernels import ops

    worst = 0.0
    for n in SHAPES_N:
        for b in SHAPES_B:
            cfg, state, params, pods = make_case(n, b, device, SEED + n + b)
            got = ops.sdqn_score_afterstate(state, pods, cfg, params,
                                            mode="cuda")
            torch.cuda.synchronize()
            want = ops.sdqn_score_afterstate(state, pods, cfg, params,
                                             mode="plain")
            assert got.shape == (b, n) and bool(torch.isfinite(got).all())
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
            err = float((got - want).abs().max())
            worst = max(worst, err)
            print(f"kernel vs plain N={n} B={b}: max_abs_err={err}")
            if n <= 1000:
                # and against the unfused oracle (hypothetical_place + Q-net)
                oracle = ops.sdqn_score_afterstate(state, pods, cfg, params,
                                                   mode="ref")
                torch.testing.assert_close(got, oracle, rtol=RTOL, atol=ATOL)
    return worst


class StepClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _serving_setup(device):
    from repro_torch.core import dqn, env
    from repro_torch.core.types import fleet_cluster

    cfg = fleet_cluster(MAIN_N)
    gen = torch.Generator().manual_seed(SEED)
    state = env.reset(gen, cfg, device=device)
    params = dqn.init_qnet(gen, device=device)
    return cfg, state, params


def check_outcome(daemon, cfg):
    """The repo's own invariants on a finished run."""
    from repro_torch.core.types import NO_PLACEMENT

    m = daemon.metrics
    assert m.bound + m.dropped + m.shed == m.submitted, m
    assert len(daemon.decisions) == m.submitted
    lv = daemon._sub.live
    for d in daemon.decisions:
        assert d.node == NO_PLACEMENT or 0 <= d.node < cfg.n_nodes
    assert np.all(lv.cpu_requested <= lv.cpu_capacity)
    assert np.all(lv.mem_requested <= lv.mem_capacity)
    assert np.all(lv.num_pods <= lv.max_pods)
    for col in lv:
        assert np.all(np.isfinite(np.asarray(col, np.float64)))


def phase_main_path(device):
    from repro_torch.kernels import sdqn_score as ss
    from repro_torch.scenarios import arrival_trace
    from repro_torch.sched.daemon import (ClusterSubstrate, DaemonConfig,
                                          PlacementDaemon, replay_trace)

    cfg, state, params = _serving_setup(device)
    runs = []
    for rate in RATES_PER_S:
        d = PlacementDaemon(ClusterSubstrate(state, cfg, device=device), params,
                            DaemonConfig(batch_size=32, max_wait_s=0.005))
        d.warmup()
        trace = arrival_trace(torch.Generator().manual_seed(SEED + 2), cfg,
                              N_REQUESTS, rate_per_s=rate)
        runs.append((rate, d, trace))

    ss.sdqn_score_afterstate.launches = 0          # the main path starts here
    per_rate = []
    for rate, d, trace in runs:
        before = ss.sdqn_score_afterstate.launches
        dur = replay_trace(d, trace.t_s, trace.pods)
        per_rate.append((rate, d, dur, ss.sdqn_score_afterstate.launches - before))
    launches = ss.sdqn_score_afterstate.launches   # ... and ends here

    for rate, d, dur, n_launch in per_rate:
        m = d.metrics
        assert m.bound + m.dropped == m.submitted == N_REQUESTS, m
        assert m.device_launches == m.batches, m
        assert n_launch == m.device_launches, (n_launch, m.device_launches)
        assert n_launch > 0
        check_outcome(d, cfg)
        lat = np.asarray(m.bind_latencies_s)
        print(f"serve rate={int(rate)}/s: decisions/s={N_REQUESTS / dur} "
              f"p50_ms={np.percentile(lat, 50) * 1e3} "
              f"p99_ms={np.percentile(lat, 99) * 1e3} batches={m.batches} "
              f"kernel_launches={n_launch} bound={m.bound} "
              f"dropped={m.dropped} conflicts={m.conflicts}")
    return launches


def _deterministic_run(device, fused):
    from repro_torch.scenarios import arrival_trace
    from repro_torch.sched.daemon import (ClusterSubstrate, DaemonConfig,
                                          PlacementDaemon)

    cfg, state, params = _serving_setup(device)
    clock = StepClock()
    d = PlacementDaemon(ClusterSubstrate(state, cfg, device=device), params,
                        DaemonConfig(batch_size=32, max_wait_s=0.005,
                                     fused=fused), clock=clock, timer=clock)
    log = []
    inner = d._scorer

    def spy(p, snap, pods):
        q, ok = inner(p, snap, pods)
        log.append((q.cpu().numpy(), ok.cpu().numpy()))
        return q, ok

    d._scorer = spy
    trace = arrival_trace(torch.Generator().manual_seed(SEED + 2), cfg,
                          N_REQUESTS, rate_per_s=RATES_PER_S[0])
    for t, pod in zip(trace.t_s, trace.pods):
        clock.t = float(t)
        d.submit(pod, now=float(t))
        d.poll()
    clock.t = float(trace.t_s[-1]) + 1.0
    d.drain()
    check_outcome(d, cfg)
    return d, log


def phase_decision_parity(device):
    kern, k_log = _deterministic_run(device, "auto")
    plain, p_log = _deterministic_run(device, "plain")
    near_ties = 0
    for q, ok in k_log:
        # distinct rows only: pad rows repeat the batch's last pod (and in
        # this trace every pod is the default pod)
        rows = np.unique(np.concatenate([q, ok.astype(q.dtype)], axis=1),
                         axis=0)
        for row in rows:
            n = q.shape[1]
            score, okr = row[:n], row[n:] > 0.5
            top = np.sort(score[okr])[::-1][:2]
            if top.size == 2 and top[0] - top[1] <= ATOL + RTOL * abs(top[0]):
                near_ties += 1
    k_dec = [(x.req_id, x.node) for x in kern.decisions]
    p_dec = [(x.req_id, x.node) for x in plain.decisions]
    first_diff = next((i for i, (a, b) in enumerate(zip(k_dec, p_dec))
                       if a != b), None)
    if first_diff is None:
        assert len(k_dec) == len(p_dec)
    else:
        assert near_ties > 0, f"decision {first_diff} differs without a tie"
    # the batches both runs scored alike agree within the tolerance
    for (kq, kok), (pq, pok) in zip(k_log, p_log):
        if kq.shape != pq.shape or not np.array_equal(kok, pok):
            break
        np.testing.assert_allclose(kq, pq, rtol=RTOL, atol=ATOL)
    print(f"deterministic replay: decisions={len(k_dec)} identical="
          f"{first_diff is None} first_difference={first_diff} "
          f"distinct_near_tie_rows={near_ties} batches={len(k_log)}")


def phase_timings(device, name):
    from repro_torch.kernels import ops, sdqn_score as ss

    rows = {}
    for n in (MAIN_N, 131072):
        cfg, state, params, pods = make_case(n, MAIN_B, device, SEED + 7)
        inputs = ops._afterstate_inputs(state, pods, cfg, params)
        saved = ss.sdqn_score_afterstate.launches
        ms = graph_time_ms(lambda: ss.sdqn_score_afterstate(*inputs), 200)
        call_ms = cuda_time_ms(lambda: ss.sdqn_score_afterstate(*inputs), 200)
        ss.sdqn_score_afterstate.launches = saved   # timing launches don't count
        plain_iters = 10 if n > 5000 else 50
        plain_ms = graph_time_ms(
            lambda: ss.sdqn_score_afterstate_plain(*inputs), plain_iters)
        plain_call_ms = cuda_time_ms(
            lambda: ss.sdqn_score_afterstate_plain(*inputs), plain_iters)
        b_ms, b_by = bound_ms(n, MAIN_B, name)
        rows[n] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"timing N={n} B={MAIN_B}: kernel_ms={ms} plain_ms={plain_ms} "
              f"(device time, CUDA graph) kernel_call_ms={call_ms} "
              f"plain_call_ms={plain_call_ms} (eager calls, host included) "
              f"bound_ms={b_ms} ({b_by}, {peaks(name)[0]} peaks) "
              f"kernel/bound={ms / b_ms}")
    return rows


class Spans:
    """Host-clock totals of named spans (seconds) and their counts."""

    def __init__(self):
        self.total = {}
        self.count = {}

    def wrap(self, name, fn, sync=False):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            self.total[name] = self.total.get(name, 0.0) + time.perf_counter() - t0
            self.count[name] = self.count.get(name, 0) + 1
            return out
        return timed


def phase_breakdown(device):
    """Where a batch's time goes at 4000/s offered: host spans around each
    layer (the scorer span synchronizes, so it holds the device work), and
    the device's busy share from torch.profiler over the same run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.scenarios import arrival_trace
    from repro_torch.sched.daemon import (ClusterSubstrate, DaemonConfig,
                                          PlacementDaemon, replay_trace)

    cfg, state, params = _serving_setup(device)
    sub = ClusterSubstrate(state, cfg, device=device)
    d = PlacementDaemon(sub, params, DaemonConfig(batch_size=32,
                                                  max_wait_s=0.005))
    d.warmup()
    spans = Spans()
    sub.snapshot = spans.wrap("snapshot_publish", sub.snapshot, sync=True)
    sub.pack = spans.wrap("pack_pods", sub.pack, sync=True)
    d._scorer = spans.wrap("score_kernel_feasible", d._scorer, sync=True)
    sub.feasible_one = spans.wrap("bind_revalidate", sub.feasible_one)
    sub.bind = spans.wrap("bind_commit", sub.bind)
    d._process_batch = spans.wrap("batch_total", d._process_batch)
    trace = arrival_trace(torch.Generator().manual_seed(SEED + 3), cfg, 500,
                          rate_per_s=RATES_PER_S[1])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        replay_trace(d, trace.t_s, trace.pods)
        wall = time.perf_counter() - t0
    batches = d.metrics.batches
    for name in sorted(spans.total, key=spans.total.get, reverse=True):
        print(f"span {name}: total_ms={spans.total[name] * 1e3} "
              f"per_batch_ms={spans.total[name] * 1e3 / batches} "
              f"calls={spans.count[name]}")
    dev_us = {}
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", 0.0)
        if t > 0:
            dev_us[evt.key] = t
    busy = sum(dev_us.values()) / 1e6
    print(f"profiled replay: batches={batches} wall_s={wall} "
          f"device_busy_s={busy} device_busy_share={busy / wall}")
    for key in sorted(dev_us, key=dev_us.get, reverse=True)[:8]:
        print(f"device time {key}: total_us={dev_us[key]}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build, sdqn_score as ss

    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    secs = _build.build([ss.KERNEL_SOURCE])
    print(f"build: {secs} (wall {time.perf_counter() - t0:.2f} s)")
    for src, log in _build.BUILD_LOG.items():
        for line in log["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{src}]: {line.strip()}")

    max_err = phase_kernels(device)
    launches = phase_main_path(device)
    phase_decision_parity(device)
    timing = phase_timings(device, name)[MAIN_N]
    phase_breakdown(device)

    kernels = [{
        "name": "sdqn_score_afterstate", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sdqn_score_afterstate.cu",
        "replaces": "src/repro/kernels/sdqn_score.py:171",
        "launches": launches, "max_abs_err": max_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None,
    }]
    assert launches > 0
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
