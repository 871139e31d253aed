"""Placement daemon (PyTorch port): continuously-serving, batched, optimistic.

Counterpart of ``repro.sched.daemon`` for the pod->node cluster
(``ClusterSubstrate``) and job->host placement (``FleetSubstrate``):

  * **Batched one-launch scoring.**  Pending requests accumulate into
    batches (cut by size OR by the oldest request's wait time); the whole
    batch is scored by ONE launch of a hand-written kernel.  The kernels'
    launch counters take the place of the reference's compilation count.
  * **Double-buffered fleet state.**  Admission and committed binds write
    the *live* buffer, a host numpy mirror, while scoring reads a device
    *snapshot* published at batch cut.
  * **Two-stage candidates.**  With a ``launch.mesh.FleetLayout`` the
    scorer returns each request's merged per-shard top-k, ``(B, shards·k)``
    values and global indices (``sched.shard``): only those are read back
    to the host, never a ``(B, N)`` row.
  * **Optimistic concurrency.**  Every bind re-validates feasibility against
    the live buffer; a request that loses the race re-queues
    (``conflict_policy="requeue"``) or falls to its next-best snapshot
    candidate (``"next-best"``).
  * **Policy classes.**  ``policy=`` (a registered ``core.policy``
    spec) scores through the class's ``score_set``: for "attention" one
    launch of kernel 7 per batch.  A sequence class ("mamba") carries its
    arrival-history state across batches (``PlacementDaemon._carry``):
    each batch's B workloads are encoded by ONE launch of its sequence
    encoder (kernel 6) from that carry, pad rows with ``dt = 0`` so they
    leave it bit-exact.  The reference scans ``encode_step`` over the
    batch inside its one jitted launch; the carries agree, the pad rows'
    embeds (never committed) do not.

    sub = ClusterSubstrate(env.reset(gen, cfg), cfg)
    d = PlacementDaemon(sub, qparams, DaemonConfig(batch_size=32))
    d.submit(pod); ...; d.poll(); decisions = d.decisions

``ClusterSubstrate(score_fn=...)`` scores with a custom scorer (the
paper's LSTM / Transformer baselines, ``core.baselines``) on the unfused
path, flat or sharded.  ``decision_hook(pod, node)`` observes every
served decision (``sched.online``'s recorders attach there) and
``set_params`` swaps the policy's params; the daemon reads them once per
batch cut.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import env as kenv, policy as pol, schedulers
from repro_torch.core.types import NO_PLACEMENT, ClusterState, EnvConfig, PodSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import sdqn_score as _ss
from repro_torch.launch.mesh import FleetLayout
from repro_torch.sched import placement as _pl, shard as _shard
from repro_torch.sched.api import DIVERGENCE_LIMIT as _DIVERGENCE_LIMIT

__all__ = [
    "ClusterSubstrate", "DaemonConfig", "DaemonMetrics", "DaemonStats",
    "Decision", "FleetSubstrate", "LatencyReservoir", "PlacementDaemon",
    "replay_trace",
]

def _init_carry(policy, params):
    """The daemon-lifetime arrival-history carry of a sequence policy class
    (``None`` for stateless scorers)."""
    if policy is not None and policy.embed_dim > 0:
        return policy.carry_init(params)
    return None


def _encoder(policy, fused, workloads: Callable) -> Callable:
    """``encode(params, batch, carry, n_real) -> (embeds (B, E) or None,
    carry)``: ONE launch of a sequence class's encoder per batch over
    ``workloads(batch)`` (B, ENCODER_IN), rows from ``n_real`` on (the pad
    rows) leaving the carry as it was; stateless classes pass the carry
    through and compute nothing."""
    if policy is None or policy.embed_dim == 0:
        return lambda params, batch, carry, n_real: (None, carry)
    mode = schedulers.policy_mode(fused)

    def encode(params, batch, carry, n_real):
        return policy.encode_sequence(params, workloads(batch), h0=carry,
                                      mode=mode, n_real=n_real)

    return encode


def _check_layout(layout, topk: int) -> None:
    """A ``FleetLayout`` or ``None``, and a ``topk`` the top-k kernels take
    (checked when the substrate is built, not at its first batch)."""
    if layout is not None and not isinstance(layout, FleetLayout):
        raise TypeError(f"layout must be a launch.mesh.FleetLayout or None, "
                        f"got {type(layout).__name__}")
    _ss.check_k(topk)


@dataclasses.dataclass(frozen=True)
class DaemonConfig:
    """Serving-loop knobs (see the reference for the full story).

    A batch is cut when ``batch_size`` requests are pending OR the oldest
    has waited ``max_wait_s``.  ``max_retries`` bounds conflict re-queues;
    ``conflict_policy`` picks what a lost optimistic bind does; ``fused``
    threads to ``schedulers.score_afterstates_batch``.  ``queue_cap`` sheds
    the oldest pending request past the cap (0 = unbounded);
    ``backoff_base_s`` holds a conflicted request ``base * 2**(k-1)``;
    ``score_deadline_s`` degrades to the kube heuristic for
    ``degrade_batches`` batches when a launch runs late (NaN / diverged
    scores always degrade); ``heuristic_only`` pins degraded mode on.
    """

    batch_size: int = 32
    max_wait_s: float = 0.02
    max_retries: int = 4
    conflict_policy: str = "requeue"     # "requeue" | "next-best"
    fused: object = "auto"
    queue_cap: int = 0
    backoff_base_s: float = 0.0
    score_deadline_s: Optional[float] = None
    degrade_batches: int = 8
    heuristic_only: bool = False

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if self.conflict_policy not in ("requeue", "next-best"):
            raise ValueError(f"unknown conflict_policy "
                             f"{self.conflict_policy!r}")
        if self.queue_cap < 0:
            raise ValueError("queue_cap must be >= 0 (0 = unbounded)")
        if self.backoff_base_s < 0:
            raise ValueError("backoff_base_s must be >= 0")
        if self.degrade_batches < 0:
            raise ValueError("degrade_batches must be >= 0")
        if self.fused not in schedulers.FUSED_CHOICES:
            raise ValueError(f"fused must be one of "
                             f"{schedulers.FUSED_CHOICES}, got {self.fused!r}")


class Decision(NamedTuple):
    """One served placement decision (``node == NO_PLACEMENT`` = dropped)."""

    req_id: int
    node: int
    latency_s: float       # decision time - submission time
    attempts: int          # 1 + times the request lost an optimistic bind
    shed: bool = False     # evicted from the admission queue (backpressure)


class LatencyReservoir:
    """Fixed-memory uniform sample of the decision-latency stream
    (Algorithm R, deterministically seeded)."""

    __slots__ = ("_buf", "_filled", "_seen", "_rng")

    def __init__(self, capacity: int = 4096, seed: int = 0):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._buf = np.zeros((capacity,), np.float64)
        self._filled = 0
        self._seen = 0
        self._rng = np.random.default_rng(seed)

    def append(self, x: float) -> None:
        cap = self._buf.shape[0]
        if self._filled < cap:
            self._buf[self._filled] = x
            self._filled += 1
        else:
            j = int(self._rng.integers(0, self._seen + 1))
            if j < cap:
                self._buf[j] = x
        self._seen += 1

    @property
    def seen(self) -> int:
        """Total latencies observed (not just the retained sample)."""
        return self._seen

    def __len__(self) -> int:
        return self._filled

    def __array__(self, dtype=None, copy=None):
        arr = self._buf[:self._filled]
        return arr.astype(dtype) if dtype is not None else arr.copy()

    def percentile(self, q: float) -> float:
        if self._filled == 0:
            return float("nan")
        return float(np.percentile(self._buf[:self._filled], q))

    def p50(self) -> float:
        return self.percentile(50.0)

    def p99(self) -> float:
        return self.percentile(99.0)


@dataclasses.dataclass
class DaemonMetrics:
    submitted: int = 0
    bound: int = 0
    dropped: int = 0
    shed: int = 0           # evicted from the admission queue (backpressure)
    conflicts: int = 0      # optimistic binds that failed live re-validation
    requeued: int = 0       # conflicted requests sent back to the queue
    evictions: int = 0      # bound pods auto-requeued off a failed node
    batches: int = 0
    device_launches: int = 0  # scoring calls (degraded batches skip)
    fallback_batches: int = 0  # batches served by the kube heuristic
    # latency of SERVED requests (bound or dropped); shed waits kept apart
    bind_latencies_s: LatencyReservoir = dataclasses.field(
        default_factory=LatencyReservoir)
    shed_wait_s: LatencyReservoir = dataclasses.field(
        default_factory=LatencyReservoir)


# the public name the ops surface documents
DaemonStats = DaemonMetrics


class _Request:
    __slots__ = ("req_id", "pod", "t_submit", "attempts", "not_before")

    def __init__(self, req_id, pod, t_submit):
        self.req_id = req_id
        self.pod = pod
        self.t_submit = t_submit
        self.attempts = 0
        self.not_before = t_submit   # conflict-backoff hold (poll honors it)


# ---------------------------------------------------------------------------
# substrate: live-buffer mirror + batched snapshot scorer
# ---------------------------------------------------------------------------


class Snapshot(NamedTuple):
    """A published scoring snapshot: the device columns plus the global
    pull-contention scalar, reduced on the host from the same live buffer
    (so the kernel gets it by value and the batch needs no device sync
    before its launch)."""

    state: ClusterState
    pull_cost: np.float32


def host_pull_cost(live: ClusterState, cfg: EnvConfig) -> np.float32:
    """``env.pull_cost_now`` over a numpy buffer, in float32 arithmetic as
    the device reduction does it."""
    in_flight = np.float32(np.sum(live.startup_cpu
                                  > np.float32(0.25 * cfg.image_pull_cost)))
    return np.float32(cfg.image_pull_cost) * (
        np.float32(1.0) + np.float32(cfg.pull_concurrency_coeff) * in_flight)


class ClusterSubstrate:
    """The paper's pod->node cluster as a daemon substrate.

    ``live`` is a ``ClusterState`` of *mutable numpy* arrays — the admission
    buffer.  ``snapshot`` publishes it on ``device`` (``None`` = the CUDA
    card) for the scoring launch.  ``bind``/``feasible_one`` mirror
    ``env.place``/``env.feasible`` restricted to the touched row."""

    def __init__(self, state: ClusterState, cfg: EnvConfig, device=None,
                 score_fn: Optional[Callable] = None, policy=None,
                 layout: Optional[FleetLayout] = None, topk: int = 8):
        if score_fn is not None and policy is not None:
            raise ValueError("pass either score_fn or policy, not both")
        _check_layout(layout, topk)
        self.score_fn = score_fn
        self.policy = pol.checked(policy)
        self.cfg = cfg
        self.device = resolve_device(device)
        # a FleetLayout switches the scorer to per-request candidate lists
        # (two-stage top-k, ``topk`` per shard, merged) instead of (B, N) rows
        self.layout = layout
        self.topk = topk
        self.live = ClusterState(*(np.array(torch.as_tensor(x).cpu().numpy())
                                   for x in state))

    def snapshot(self) -> Snapshot:
        state = ClusterState(*(torch.tensor(x, device=self.device)
                               for x in self.live))
        return Snapshot(state, host_pull_cost(self.live, self.cfg))

    def pack(self, pods: Sequence[PodSpec], size: int) -> PodSpec:
        """Stack + pad a request batch to (size,) columns (one host->device
        copy; pad rows repeat the last pod and are never committed)."""
        pods = list(pods) + [pods[-1]] * (size - len(pods))
        cols = np.asarray([[float(x) for x in p] for p in pods],
                          np.float32).T.copy()
        t = torch.from_numpy(cols).to(self.device)
        return PodSpec(*t)

    def init_carry(self, params: dict):
        """The arrival-history carry of a sequence policy (else ``None``)."""
        return _init_carry(self.policy, params)

    def make_scorer(self, fused) -> Callable:
        """``(params, snapshot, pod_batch, carry, n_real) -> (scores,
        feasible, carry)``, scores and feasible (B, N): ONE kernel launch
        for the scores (kernel 1 for the Table-4 net at fleet scale, kernel
        7 for "attention"), and for a sequence class one launch of its
        encoder (kernel 6 for "mamba") that advances ``carry`` over the
        batch's first ``n_real`` rows.

        With a ``layout`` the contract is ``-> (cand_vals, cand_idx,
        carry)``, both (B, shards·topk): the two-stage candidate merge,
        in ONE launch of the afterstate top-k kernel at fleet scale, with
        the snapshot's global pull-contention scalar passed to every
        shard."""
        cfg, policy, score_fn = self.cfg, self.policy, self.score_fn
        encode = _encoder(policy, fused, pol.pod_workload_features)
        if self.layout is not None:
            layout, k = self.layout, self.topk

            def candidates(params, snap, pods, carry, n_real):
                embed, carry = encode(params, pods, carry, n_real)
                vals, idx = _shard.cluster_topk(
                    params, snap.state, pods, cfg, layout, k=k, fused=fused,
                    score_fn=score_fn, policy=policy, embed=embed,
                    pull_cost=snap.pull_cost)
                return vals, idx, carry

            return candidates

        def score(params, snap, pods, carry, n_real):
            embed, carry = encode(params, pods, carry, n_real)
            q = schedulers.score_afterstates_batch(
                params, snap.state, pods, cfg, fused=fused,
                pull_cost=snap.pull_cost, score_fn=score_fn, policy=policy,
                embed=embed)
            batch = PodSpec(*(x[:, None] for x in pods))
            return q, kenv.feasible(snap.state, batch, cfg), carry

        return score

    def dummy(self) -> PodSpec:
        return kenv.default_pod(self.cfg)

    def feasible_one(self, node: int, pod: PodSpec) -> bool:
        """``env.feasible`` row ``node`` against the LIVE buffer."""
        lv = self.live
        return bool(
            lv.healthy[node]
            and lv.cpu_requested[node] + float(pod.cpu_request)
            <= lv.cpu_capacity[node]
            and lv.mem_requested[node] + float(pod.mem_request)
            <= lv.mem_capacity[node]
            and lv.num_pods[node] < lv.max_pods[node]
        )

    def bind(self, node: int, pod: PodSpec) -> None:
        """Commit one bind to the live buffer: ``env.place`` restricted to
        the chosen row, in numpy (no device op on the serving hot path)."""
        lv, cfg = self.live, self.cfg
        in_flight = float(np.sum(lv.startup_cpu > 0.25 * cfg.image_pull_cost))
        pull = cfg.image_pull_cost * (1.0 + cfg.pull_concurrency_coeff
                                      * in_flight)
        start = cfg.warm_start_cost if lv.image_cached[node] else pull
        lv.num_pods[node] += 1
        lv.exp_pods[node] += 1
        lv.cpu_requested[node] += float(pod.cpu_request)
        lv.mem_requested[node] += float(pod.mem_request)
        lv.pods_cpu[node] += float(pod.cpu_demand)
        lv.mem_used[node] += float(pod.mem_demand)
        lv.startup_cpu[node] += start
        lv.image_cached[node] = True

    def unbind(self, node: int, pod: PodSpec) -> None:
        """Release one bound pod from the live buffer (startup transients
        and the cached image stay)."""
        lv = self.live
        lv.num_pods[node] -= 1
        lv.exp_pods[node] -= 1
        lv.cpu_requested[node] -= float(pod.cpu_request)
        lv.mem_requested[node] -= float(pod.mem_request)
        lv.pods_cpu[node] -= float(pod.cpu_demand)
        lv.mem_used[node] -= float(pod.mem_demand)

    def set_health(self, node: int, healthy: bool) -> None:
        """Flip one node's Ready condition in the live buffer."""
        self.live.healthy[node] = bool(healthy)

    def heuristic_batch(self, pods: Sequence[PodSpec]):
        """(B, N) kube LeastRequested+Balanced scores + feasibility against
        the LIVE buffer, pure numpy — the degraded-mode scorer."""
        lv = self.live
        creq = np.asarray([float(p.cpu_request) for p in pods])[:, None]
        mreq = np.asarray([float(p.mem_request) for p in pods])[:, None]
        cpu_free = (lv.cpu_capacity[None, :] - lv.cpu_requested[None, :]
                    - creq) / lv.cpu_capacity[None, :]
        mem_free = (lv.mem_capacity[None, :] - lv.mem_requested[None, :]
                    - mreq) / lv.mem_capacity[None, :]
        q = 10.0 * (cpu_free + mem_free) / 2.0 \
            + 10.0 * (1.0 - np.abs(cpu_free - mem_free))
        ok = (lv.healthy[None, :]
              & (lv.cpu_requested[None, :] + creq <= lv.cpu_capacity[None, :])
              & (lv.mem_requested[None, :] + mreq <= lv.mem_capacity[None, :])
              & (lv.num_pods[None, :] < lv.max_pods[None, :]))
        return q, ok


class FleetSubstrate:
    """Job->host placement (``sched.placement``) as a daemon substrate.

    ``live`` is a ``FleetState`` of float64 numpy arrays, as the reference
    keeps it, so bind-time re-validation compares in the same precision.
    Jobs are packed as (B, 6) afterstate-delta rows and scored in ONE launch
    of the column kernel (flat: ``(B, N)`` scores) or of the column top-k
    kernel (with a ``layout``: ``(B, shards·topk)`` candidates).  A policy
    class other than "mlp" scores the (B, N, 6) afterstate rows through its
    ``score_set``; a sequence class encodes each job's normalized demand
    (``(delta / FEATURE_SCALE)[:ENCODER_IN]``, the job-stream analogue of
    ``pod_workload_features``)."""

    def __init__(self, fleet: _pl.FleetState, max_host_cpu_pct: float = 88.0,
                 policy=None, layout: Optional[FleetLayout] = None,
                 topk: int = 8, device=None):
        _check_layout(layout, topk)
        policy = pol.checked(policy)
        # "mlp": the column kernels ARE its score_set
        self.policy = None if policy is None or policy.fused_kernel else policy
        self.device = resolve_device(device)
        self.live = _pl.FleetState(*(np.array(torch.as_tensor(x).cpu().numpy(),
                                              np.float64) for x in fleet))
        self.max_host_cpu_pct = max_host_cpu_pct
        self.layout = layout
        self.topk = topk

    def snapshot(self) -> _pl.FleetState:
        """The live buffer as float32 device columns, in one host->device
        copy of a (6, N) block (``num_jobs`` too is float32 here, as in the
        reference's snapshot)."""
        block = torch.from_numpy(np.stack(self.live).astype(np.float32))
        return _pl.FleetState(*block.to(self.device))

    def pack(self, jobs: Sequence[_pl.JobSpec], size: int) -> torch.Tensor:
        jobs = list(jobs) + [jobs[-1]] * (size - len(jobs))
        return _pl.job_deltas(jobs, self.device)

    def dummy(self) -> _pl.JobSpec:
        return _pl.JobSpec()

    def init_carry(self, params: dict):
        """The arrival-history carry of a sequence policy (else ``None``)."""
        return _init_carry(self.policy, params)

    def make_scorer(self, fused) -> Callable:
        """``(params, snap, deltas, carry, n_real) -> (q, ok, carry)``
        (B, N), or with a layout ``-> (cand_vals, cand_idx, carry)``
        (B, shards·topk); one scoring launch either way, plus one encoder
        launch for a sequence class (as ``ClusterSubstrate.make_scorer``)."""
        from repro_torch.kernels import ops
        from repro_torch.sched.api import _fleet_mode, _fleet_policy_score

        max_cpu, mode, policy = (self.max_host_cpu_pct, _fleet_mode(fused),
                                 self.policy)
        scale = kenv.FEATURE_SCALE[:pol.ENCODER_IN].to(self.device)
        encode = _encoder(policy, fused,
                          lambda deltas: deltas[:, :pol.ENCODER_IN] / scale)

        if self.layout is not None:
            layout, k = self.layout, self.topk

            def candidates(params, snap, deltas, carry, n_real):
                embed, carry = encode(params, deltas, carry, n_real)
                vals, idx = _shard.fleet_topk(
                    params, snap, None, layout, k=k, fused=fused,
                    policy=policy, embed=embed, delta=deltas,
                    max_host_cpu_pct=max_cpu)
                return vals, idx, carry

            return candidates

        def score(params, snap, deltas, carry, n_real):
            embed, carry = encode(params, deltas, carry, n_real)
            if policy is None:
                q = ops.sdqn_score_delta(_pl.fleet_cols(snap), deltas, params,
                                         mode=mode)
            else:
                q = _fleet_policy_score(snap, deltas, params, policy, embed,
                                        fused)
            return q, _pl.feasible_deltas(snap, deltas, max_cpu), carry

        return score

    def feasible_one(self, node: int, job: _pl.JobSpec) -> bool:
        lv = self.live
        return bool(
            lv.healthy[node] > 0.5
            and lv.cpu_pct[node] + job.cpu_pct_demand <= self.max_host_cpu_pct
            and lv.mem_pct[node] + job.mem_pct_demand <= _pl.MEM_CEILING_PCT
            and lv.job_util_pct[node] + _pl.JOB_UTIL_DELTA_PCT
            <= _pl.JOB_UTIL_CEILING_PCT
        )

    def bind(self, node: int, job: _pl.JobSpec) -> None:
        lv = self.live
        lv.cpu_pct[node] += job.cpu_pct_demand
        lv.mem_pct[node] += job.mem_pct_demand
        lv.job_util_pct[node] += _pl.JOB_UTIL_DELTA_PCT
        lv.num_jobs[node] += 1

    def unbind(self, node: int, job: _pl.JobSpec) -> None:
        lv = self.live
        lv.cpu_pct[node] -= job.cpu_pct_demand
        lv.mem_pct[node] -= job.mem_pct_demand
        lv.job_util_pct[node] -= _pl.JOB_UTIL_DELTA_PCT
        lv.num_jobs[node] -= 1

    def set_health(self, node: int, healthy: bool) -> None:
        self.live.healthy[node] = 1.0 if healthy else 0.0

    def heuristic_batch(self, jobs: Sequence[_pl.JobSpec]):
        """(B, N) percent-utilization LeastRequested+Balanced scores +
        feasibility against the LIVE buffer, pure numpy."""
        lv = self.live
        dc = np.asarray([j.cpu_pct_demand for j in jobs])[:, None]
        dm = np.asarray([j.mem_pct_demand for j in jobs])[:, None]
        cpu_free = (100.0 - lv.cpu_pct[None, :] - dc) / 100.0
        mem_free = (100.0 - lv.mem_pct[None, :] - dm) / 100.0
        q = 10.0 * (cpu_free + mem_free) / 2.0 \
            + 10.0 * (1.0 - np.abs(cpu_free - mem_free))
        ok = ((lv.healthy[None, :] > 0.5)
              & (lv.cpu_pct[None, :] + dc <= self.max_host_cpu_pct)
              & (lv.mem_pct[None, :] + dm <= _pl.MEM_CEILING_PCT)
              & (lv.job_util_pct[None, :] + _pl.JOB_UTIL_DELTA_PCT
                 <= _pl.JOB_UTIL_CEILING_PCT))
        return q, ok


# ---------------------------------------------------------------------------
# the daemon
# ---------------------------------------------------------------------------


class PlacementDaemon:
    """Continuously-serving placement loop over a substrate.

    ``submit`` is admission: O(1) queue append, never touches the device.
    ``poll`` cuts at most one batch when ready (size or max-wait), publishes
    the live buffer as the scoring snapshot, scores the whole batch in one
    launch, and commits binds with bind-time re-validation.
    ``flush``/``drain`` force remaining work through.  ``clock`` and the
    deadline stopwatch ``timer`` are injectable for deterministic tests."""

    def __init__(self, substrate, params: dict,
                 config: DaemonConfig = DaemonConfig(),
                 clock: Callable[[], float] = time.monotonic,
                 timer: Callable[[], float] = time.monotonic,
                 decision_hook: Optional[Callable] = None):
        self._sub = substrate
        # ``decision_hook(pod, node)`` observes every SERVED decision (bound
        # or dropped; shed requests are never scored and produce none)
        self.decision_hook = decision_hook
        self._params = params
        self.config = config
        self._clock = clock
        self._timer = timer
        self._pending: collections.deque = collections.deque()
        self._scorer = substrate.make_scorer(config.fused)
        # sharded substrates score to (B, C) candidate lists instead of
        # (B, N) rows; the commit path reads candidates in merged order
        self._cand_mode = getattr(substrate, "layout", None) is not None
        # a sequence policy's arrival-history carry, advanced by every
        # batch whose scores are used (a degraded batch discards it)
        self._carry = substrate.init_carry(params)
        self._next_id = 0
        # req_id -> (node, pod) of every currently-bound placement
        self._bound: dict = {}
        # > 0: this many upcoming batches skip the Q-net and serve from the
        # kube heuristic (set on a deadline breach / NaN scores)
        self._degraded = 0
        self.metrics = DaemonMetrics()
        self.decisions: List[Decision] = []

    # -- admission ----------------------------------------------------------

    def submit(self, pod, now: Optional[float] = None) -> int:
        """Enqueue one placement request; returns its request id.  With
        ``queue_cap`` set, a full queue sheds its OLDEST pending request."""
        now = self._clock() if now is None else now
        cap = self.config.queue_cap
        if cap > 0:
            while len(self._pending) >= cap:
                old = self._pending.popleft()
                lat = max(now - old.t_submit, 0.0)
                self.decisions.append(Decision(old.req_id, NO_PLACEMENT, lat,
                                               old.attempts, shed=True))
                self.metrics.shed_wait_s.append(lat)
                self.metrics.shed += 1
        req = _Request(self._next_id, pod, now)
        self._next_id += 1
        self._pending.append(req)
        self.metrics.submitted += 1
        return req.req_id

    # -- health watchdog ----------------------------------------------------

    def fail_node(self, node: int, now: Optional[float] = None) -> int:
        """Mark ``node`` NotReady and auto-requeue every pod bound there as
        a fresh submission; returns the number of evicted pods."""
        now = self._clock() if now is None else now
        self._sub.set_health(node, False)
        evicted = [(rid, pod) for rid, (n, pod) in self._bound.items()
                   if n == node]
        for rid, pod in evicted:
            del self._bound[rid]
            self._sub.unbind(node, pod)
            self.metrics.evictions += 1
            self.submit(pod, now=now)
        return len(evicted)

    def recover_node(self, node: int) -> None:
        """Mark ``node`` Ready again."""
        self._sub.set_health(node, True)

    def set_params(self, params: dict) -> None:
        """Swap the policy's params (the same tree structure), from any
        thread: one reference assignment, taken up at the next batch cut.
        The caller must not write ``params`` in place afterwards."""
        self._params = params

    @property
    def pending(self) -> int:
        return len(self._pending)

    # -- serving loop -------------------------------------------------------

    def _cut_ready(self, now: float) -> bool:
        if not self._pending:
            return False
        if len(self._pending) >= self.config.batch_size:
            return True
        return now - self._pending[0].t_submit >= self.config.max_wait_s

    def poll(self, now: Optional[float] = None) -> int:
        """Process at most one batch if the cut condition holds.  Returns
        the number of requests decided (bound or dropped) this call."""
        now = self._clock() if now is None else now
        if not self._cut_ready(now):
            return 0
        return self._process_batch(now)

    def flush(self, now: Optional[float] = None) -> int:
        """Process one batch regardless of the cut condition (0 if idle);
        backoff holds are overridden."""
        now = self._clock() if now is None else now
        if not self._pending:
            return 0
        return self._process_batch(now, force=True)

    def drain(self, now: Optional[float] = None) -> int:
        """Flush until the queue is empty (conflict re-queues included)."""
        done = 0
        while self._pending:
            done += self.flush(now)
        return done

    def warmup(self) -> None:
        """Build and load the kernels and run one scoring pass outside any
        timing window.  ``n_real = 0``: every row is a pad row, and the
        advanced carry is discarded anyway."""
        snap = self._sub.snapshot()
        pods = self._sub.pack([self._sub.dummy()], self.config.batch_size)
        for out in self._scorer(self._params, snap, pods, self._carry, 0)[:2]:
            self._fetch(out)

    # -- internals ----------------------------------------------------------

    @staticmethod
    def _fetch(t: torch.Tensor) -> np.ndarray:
        """Read one scoring output back to the host (the batch's sync)."""
        return t.cpu().numpy()

    def _take_batch(self, now: float, force: bool) -> List[_Request]:
        """Pop up to one batch of eligible requests (backoff holds honored
        unless forced; held requests keep their queue order)."""
        b = self.config.batch_size
        take: List[_Request] = []
        held: List[_Request] = []
        while self._pending and len(take) < b:
            req = self._pending.popleft()
            if force or req.not_before <= now:
                take.append(req)
            else:
                held.append(req)
        for req in reversed(held):
            self._pending.appendleft(req)
        return take

    def _process_batch(self, now: float, force: bool = False) -> int:
        reqs = self._take_batch(now, force)
        if not reqs:
            return 0
        scores = ok = cand_idx = None
        degraded = self.config.heuristic_only or self._degraded > 0
        if not degraded:
            # the params are read once, at the cut: a swap during this
            # batch takes effect at the next one
            params = self._params
            snap = self._sub.snapshot()
            pods = self._sub.pack([r.pod for r in reqs],
                                  self.config.batch_size)
            t0 = self._timer()
            q, okq, carry = self._scorer(params, snap, pods, self._carry,
                                         len(reqs))                # 1 launch
            q = self._fetch(q)
            elapsed = self._timer() - t0
            self.metrics.device_launches += 1
            deadline = self.config.score_deadline_s
            real = q[:len(reqs)]
            if self._cand_mode:
                # candidate lists legitimately carry -inf (infeasible or
                # exhausted slots): divergence is NaN, or a FINITE candidate
                # beyond the limit
                finite = np.isfinite(real)
                bad = bool(np.isnan(real).any()
                           or (np.where(finite, np.abs(real), 0.0)
                               > _DIVERGENCE_LIMIT).any())
            else:
                bad = (not np.all(np.isfinite(real))
                       or float(np.max(np.abs(real))) > _DIVERGENCE_LIMIT)
            if bad or (deadline is not None and elapsed > deadline):
                # degrade: discard the launch (scores AND its carry advance)
                # and serve this + the next degrade_batches batches from
                # the closed-form heuristic
                self._degraded = self.config.degrade_batches
                degraded = True
            else:
                self._carry = carry
                if self._cand_mode:
                    scores, cand_idx = q, self._fetch(okq)
                else:
                    scores, ok = q, self._fetch(okq)
        if degraded:
            if not self.config.heuristic_only and self._degraded > 0:
                self._degraded -= 1
            self.metrics.fallback_batches += 1
            scores, ok = self._sub.heuristic_batch([r.pod for r in reqs])
            if self._cand_mode:
                # degraded mode is host-side numpy by design, so the full-N
                # heuristic rows are sorted here into the candidate
                # contract; the stable sort keeps the lowest-index tie rule
                masked = np.where(ok, scores, -np.inf)
                cand_idx = np.argsort(-masked, axis=1, kind="stable")
                scores = np.take_along_axis(masked, cand_idx, axis=1)
        self.metrics.batches += 1
        decided = 0
        for i, req in enumerate(reqs):
            if self._cand_mode:
                decided += self._commit_candidates(req, scores[i],
                                                   cand_idx[i], now)
            else:
                decided += self._commit(req, scores[i], ok[i], now)
        return decided

    def _decide(self, req: _Request, node: int) -> None:
        lat = max(self._clock() - req.t_submit, 0.0)
        self.decisions.append(Decision(req.req_id, node, lat, req.attempts))
        self.metrics.bind_latencies_s.append(lat)
        if node == NO_PLACEMENT:
            self.metrics.dropped += 1
        else:
            self.metrics.bound += 1
            self._bound[req.req_id] = (node, req.pod)
        if self.decision_hook is not None:
            # host-side only (a deque append in sched.online's recorders):
            # no scoring launch is added
            self.decision_hook(req.pod, node)

    def _commit(self, req: _Request, row: np.ndarray, ok: np.ndarray,
                now: float) -> int:
        """Optimistic bind of one scored request; returns 1 if decided."""
        req.attempts += 1
        masked = np.where(ok, row, -np.inf)
        if not ok.any():
            # the snapshot offered no feasible node at all: a genuine drop
            self._decide(req, NO_PLACEMENT)
            return 1
        choice = int(np.argmax(masked))
        if self._sub.feasible_one(choice, req.pod):
            self._sub.bind(choice, req.pod)
            self._decide(req, choice)
            return 1
        # the snapshot's winner was taken by an earlier bind before this turn
        self.metrics.conflicts += 1
        if self.config.conflict_policy == "next-best":
            for cand in np.argsort(-masked)[1:]:
                if not np.isfinite(masked[cand]):
                    break
                if self._sub.feasible_one(int(cand), req.pod):
                    self._sub.bind(int(cand), req.pod)
                    self._decide(req, int(cand))
                    return 1
        return self._requeue_or_drop(req, now)

    def _commit_candidates(self, req: _Request, vals: np.ndarray,
                           idx: np.ndarray, now: float) -> int:
        """Optimistic bind from a merged candidate list (sharded
        substrates): ``vals`` descending with global ``idx``, ``-inf`` past
        the feasible set.  Element 0 is exactly the flat argmax winner;
        ``next-best`` walks the remaining candidates (depth shards·topk)."""
        req.attempts += 1
        if not np.isfinite(vals[0]):
            self._decide(req, NO_PLACEMENT)
            return 1
        choice = int(idx[0])
        if self._sub.feasible_one(choice, req.pod):
            self._sub.bind(choice, req.pod)
            self._decide(req, choice)
            return 1
        self.metrics.conflicts += 1
        if self.config.conflict_policy == "next-best":
            for v, cand in zip(vals[1:], idx[1:]):
                if not np.isfinite(v):
                    break
                if self._sub.feasible_one(int(cand), req.pod):
                    self._sub.bind(int(cand), req.pod)
                    self._decide(req, int(cand))
                    return 1
        return self._requeue_or_drop(req, now)

    def _requeue_or_drop(self, req: _Request, now: float) -> int:
        if req.attempts > self.config.max_retries:
            self._decide(req, NO_PLACEMENT)
            return 1
        self.metrics.requeued += 1
        if self.config.backoff_base_s > 0:
            req.not_before = now + (self.config.backoff_base_s
                                    * 2.0 ** (req.attempts - 1))
        self._pending.appendleft(req)
        return 0


def replay_trace(daemon: PlacementDaemon, t_s: Sequence[float],
                 pods: Sequence, speed: float = 1.0,
                 events: Optional[Sequence] = None) -> float:
    """Replay an arrival trace in real time through the daemon.

    Each request's submission time is its *scheduled* arrival, so queueing
    delay shows up in decision latency.  ``speed`` compresses the trace;
    ``events`` is an optional sequence of ``(t_off, kind, node)`` with
    ``kind`` in ``{"fail", "recover"}``.  Polls between arrivals, drains at
    the end; returns the wall-clock serving duration."""
    clock = daemon._clock
    ev = sorted(events or [], key=lambda e: e[0])
    ev_i = 0

    def apply_events(up_to: float):
        nonlocal ev_i
        while ev_i < len(ev) and ev[ev_i][0] / speed <= up_to:
            _, kind, node = ev[ev_i]
            if kind == "fail":
                daemon.fail_node(int(node))
            elif kind == "recover":
                daemon.recover_node(int(node))
            else:
                raise ValueError(f"unknown chaos event kind {kind!r}")
            ev_i += 1

    t0 = clock()
    for t_off, pod in zip(t_s, pods):
        due = t0 + t_off / speed
        apply_events(due - t0)
        while clock() < due:
            if not daemon.poll():
                time.sleep(0)        # yield; arrival gaps are sub-ms anyway
        daemon.submit(pod, now=due)
        daemon.poll()
    apply_events(float("inf"))
    daemon.drain()
    return clock() - t0
