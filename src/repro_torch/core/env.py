"""Kubernetes-cluster environment, homogeneous pool (PyTorch port).

Counterpart of ``repro.core.env``: construction (``reset``), the arrival
stream without a scenario, the Table-2 features, the k8s filtering
predicates, the bind / afterstate transitions, the clock, the pod ledger,
the energy accounting and the episode loop.  The arithmetic follows the
reference op for op, in float32, so that the port agrees with it to float
rounding.  Every function takes states with leading batch dimensions
(seeds, envs, trials): ``(..., N)`` columns, reduced over the node axis
only.  Randomness comes from an explicit ``torch.Generator`` or from
``core.draws``; torch cannot reproduce JAX's threefry streams, so the
parity tests carry the reference's draws over.  Chaos (failure traces) and
in-episode consolidation are not ported yet.
"""
from __future__ import annotations

import functools
import numbers
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.types import (NO_PLACEMENT, ClusterState, EnvConfig,
                                    EpisodeResult, EpisodeStats, PodLedger,
                                    PodSpec, PodTable)
from repro_torch.device import resolve_device

F32 = torch.float32
I32 = torch.int32

# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


def _uniform(gen: torch.Generator, shape, lo: float = 0.0,
             hi: float = 1.0) -> torch.Tensor:
    """U[lo, hi) float32 draws on the generator's own device."""
    u = torch.rand(shape, generator=gen, dtype=F32, device=gen.device)
    return lo + u * (hi - lo)


def _profile(gen: torch.Generator, profile: tuple, jitter: float,
             shape) -> torch.Tensor:
    """Tile `profile` along the node axis, permute each row, jitter —
    stable totals, varied layout."""
    n = shape[-1]
    reps = -(-n // len(profile))  # ceil
    vals = torch.tensor(profile, dtype=F32).repeat(reps)[:n].to(gen.device)
    perm = torch.argsort(torch.rand(shape, generator=gen, device=gen.device),
                         dim=-1)
    return vals[perm] + _uniform(gen, shape, -jitter, jitter)


def reset(gen: torch.Generator, cfg: EnvConfig, device=None,
          batch: Tuple[int, ...] = ()) -> ClusterState:
    """Fresh homogeneous clusters drawn from ``gen``, ``(*batch, N)``, on
    ``device`` (``EnvConfig`` rejects scenario pools until they are
    ported)."""
    device = resolve_device(device)
    shape = tuple(batch) + (cfg.n_nodes,)
    dev = gen.device
    uptime = _uniform(gen, shape, *cfg.init_uptime_range_h)
    cap = torch.full(shape, cfg.cpu_capacity, dtype=F32, device=dev)
    mem_cap = torch.full(shape, cfg.mem_capacity, dtype=F32, device=dev)
    max_pods = torch.full(shape, cfg.max_pods, dtype=I32, device=dev)
    base = torch.clamp(_profile(gen, cfg.base_cpu_profile,
                                cfg.base_cpu_jitter, shape), min=0.0)
    healthy = _uniform(gen, shape) >= cfg.unhealthy_prob
    # pre-existing *requests* are permuted independently of pre-existing usage
    requested0 = cfg.cpu_capacity * torch.clamp(
        _profile(gen, cfg.requested_frac_profile, cfg.requested_frac_jitter,
                 shape), 0.0, 0.95)
    pod0 = mean_pod(cfg)
    # bookings come from tenant pods: X millicores requested ~ X/request pods
    tenant_pods = (requested0 / pod0.cpu_request).to(I32)

    exp_pods0 = torch.zeros(shape, dtype=I32, device=dev)
    # a homogeneous pool has no pre-pulled images (cached_prob = 0)
    cached0 = torch.zeros(shape, dtype=torch.bool, device=dev)
    startup0 = torch.zeros(shape, dtype=F32, device=dev)
    if cfg.randomize_workload:
        # training-only domain randomization: nodes start mid-flight
        pods = torch.randint(0, cfg.randomize_max_pods + 1, shape,
                             generator=gen, device=dev).to(I32)
        mem_den = max(max(pod0.mem_request, pod0.mem_demand), 1e-6)
        mem_fit = torch.floor(0.9 * mem_cap / mem_den).to(I32)
        slot_fit = max_pods - tenant_pods
        pods = torch.minimum(pods, torch.clamp(torch.minimum(mem_fit, slot_fit),
                                               min=0))
        empty = _uniform(gen, shape) < cfg.randomize_empty_prob
        exp_pods0 = torch.where(empty, torch.zeros_like(pods), pods).to(I32)
        cached0 = cached0 | (exp_pods0 > 0) | (
            _uniform(gen, shape) < cfg.randomize_cached_prob)
        startup0 = _uniform(gen, shape, 0.0, 0.3 * cfg.image_pull_cost)

    fexp = exp_pods0.to(F32)
    state = ClusterState(
        cpu_capacity=cap,
        mem_capacity=mem_cap,
        max_pods=max_pods,
        healthy=healthy,
        uptime_hours=uptime,
        num_pods=tenant_pods + exp_pods0,
        exp_pods=exp_pods0,
        cpu_requested=torch.minimum(requested0 + fexp * pod0.cpu_request,
                                    0.98 * cap),
        mem_requested=fexp * pod0.mem_request,
        pods_cpu=fexp * pod0.cpu_demand,
        mem_used=fexp * pod0.mem_demand,
        base_cpu=base,
        startup_cpu=startup0,
        image_cached=cached0,
        time_s=torch.zeros(tuple(batch), dtype=F32, device=dev),
    )
    return ClusterState(*(x.to(device) for x in state))


def default_pod(cfg: EnvConfig) -> PodSpec:
    return PodSpec(cpu_request=float(cfg.pod_cpu_request),
                   cpu_demand=float(cfg.pod_cpu_demand),
                   mem_request=float(cfg.pod_mem_request),
                   mem_demand=float(cfg.pod_mem_demand))


def mean_pod(cfg: EnvConfig) -> PodSpec:
    """Mean PodSpec of the workload: the default pod without a scenario."""
    return default_pod(cfg)


def sample_pod_table(gen: Optional[torch.Generator], cfg: EnvConfig,
                     n_pods: int, device=None,
                     batch: Tuple[int, ...] = ()) -> PodTable:
    """The paper's homogeneous burst: `n_pods` copies of the default pod every
    `schedule_dt_s` seconds, all running forever (no draw is taken), with
    fields ``(*batch, n_pods)``."""
    device = resolve_device(device)
    shape = tuple(batch) + (n_pods,)
    pod = default_pod(cfg)
    specs = PodSpec(*(torch.full(shape, v, dtype=F32, device=device)
                      for v in pod))
    return PodTable(specs=specs,
                    dt_s=torch.full(shape, cfg.schedule_dt_s, dtype=F32,
                                    device=device),
                    type_idx=torch.zeros(shape, dtype=I32, device=device),
                    lifetime_s=torch.full(shape, float("inf"), dtype=F32,
                                          device=device))


# ---------------------------------------------------------------------------
# observation (Table 2 features)
# ---------------------------------------------------------------------------


def _node_cpu_used(base_cpu, active, pods_cpu, startup_cpu, num_pods,
                   cpu_capacity, cfg: EnvConfig) -> torch.Tensor:
    """Elementwise per-node CPU model: base + overhead + demand + startup,
    CFS crowding past ``crowd_knee`` pods, contention past the knee."""
    crowd = torch.clamp(num_pods.to(F32) - cfg.crowd_knee, min=0.0)
    overhead = active.to(F32) * cfg.node_active_overhead   # 0 where idle
    raw = (base_cpu + overhead + pods_cpu + startup_cpu
           + cfg.crowd_coeff * crowd * crowd)
    util = raw / cpu_capacity
    over = torch.clamp(util - cfg.contention_knee, min=0.0)
    contention = cfg.contention_coeff * over * over * cpu_capacity
    return torch.minimum(raw + contention, cpu_capacity)


def _feature_stack(used, mem_used, num_pods, max_pods, healthy, uptime_hours,
                   exp_pods, cpu_capacity, mem_capacity) -> torch.Tensor:
    """The six Table-2 columns from elementwise node quantities: (..., 6).

    ``num_pods / max_pods`` is taken in float32 (the reference divides two
    int32 arrays, which JAX promotes to float32)."""
    cols = [
        100.0 * used / cpu_capacity,
        100.0 * mem_used / mem_capacity,
        100.0 * num_pods.to(F32) / max_pods.to(F32),   # utilization: ALL pods
        healthy.to(F32),
        uptime_hours,
        exp_pods.to(F32),                              # count: OUR pods
    ]
    return torch.stack(torch.broadcast_tensors(*cols), dim=-1)


def cpu_used(state: ClusterState, cfg: EnvConfig) -> torch.Tensor:
    """Actual per-node CPU usage in millicores, incl. contention inflation."""
    return _node_cpu_used(state.base_cpu, state.exp_pods > 0, state.pods_cpu,
                          state.startup_cpu, state.num_pods, state.cpu_capacity, cfg)


def cpu_pct(state: ClusterState, cfg: EnvConfig) -> torch.Tensor:
    return 100.0 * cpu_used(state, cfg) / state.cpu_capacity


def features(state: ClusterState, cfg: EnvConfig) -> torch.Tensor:
    """The six Table-2 inputs, one row per node: (N, 6) float32."""
    return _feature_stack(cpu_used(state, cfg), state.mem_used, state.num_pods,
                          state.max_pods, state.healthy, state.uptime_hours,
                          state.exp_pods, state.cpu_capacity, state.mem_capacity)


FEATURE_SCALE = torch.tensor([100.0, 100.0, 100.0, 1.0, 24.0, 32.0], dtype=F32)


@functools.lru_cache(maxsize=None)
def _feature_scale(device: torch.device) -> torch.Tensor:
    """``FEATURE_SCALE`` on ``device``, copied there once."""
    return FEATURE_SCALE.to(device)


def normalize_features(feats: torch.Tensor) -> torch.Tensor:
    """Scale raw Table-2 features to O(1) for the neural scorers."""
    return feats / _feature_scale(feats.device)


# ---------------------------------------------------------------------------
# scheduling predicates (k8s filtering phase)
# ---------------------------------------------------------------------------


def feasible(state: ClusterState, pod: PodSpec, cfg: EnvConfig) -> torch.Tensor:
    """k8s predicates: Ready, CPU/mem requests fit, below max-pods.

    (N,) bool for a scalar pod; pod fields of shape (B, 1) give (B, N)."""
    return (
        state.healthy
        & (state.cpu_requested + pod.cpu_request <= state.cpu_capacity)
        & (state.mem_requested + pod.mem_request <= state.mem_capacity)
        & (state.num_pods < state.max_pods)
    )


# ---------------------------------------------------------------------------
# transitions
# ---------------------------------------------------------------------------


def pull_cost_now(state: ClusterState, cfg: EnvConfig) -> torch.Tensor:
    """Cost of starting a cold image pull *right now*, one per cluster:
    float32 ``(...)`` (0-d for one cluster).

    Each pull already in flight inflates a new one by
    ``pull_concurrency_coeff`` — a reduction over each cluster's nodes."""
    in_flight = torch.sum(state.startup_cpu > 0.25 * cfg.image_pull_cost,
                          dim=-1).to(F32)
    return cfg.image_pull_cost * (1.0 + cfg.pull_concurrency_coeff * in_flight)


def _per_node(x, like: torch.Tensor) -> torch.Tensor:
    """A per-cluster value (a float, or a ``(...)`` tensor) shaped to
    broadcast over the node axis of ``like (..., N)``."""
    return torch.as_tensor(x, dtype=F32, device=like.device)[..., None]


def place(state: ClusterState, action, pod: PodSpec, cfg: EnvConfig) -> ClusterState:
    """Bind one pod per cluster to node ``action`` (an int, or an integer
    tensor ``(...)`` over the batch; pod fields floats or ``(...)``).

    The bind is the reference's one-hot row, ``arange(N) == action``: the
    drop sentinel ``NO_PLACEMENT`` (-1) gives a zero row, so that cluster
    passes through unchanged, and no value is read back to the host.  A
    Python int is checked on the host: -1 returns ``state`` itself, and
    one outside ``[0, N)`` raises."""
    n = state.n_nodes
    dev = state.base_cpu.device
    if isinstance(action, numbers.Integral):
        if action == NO_PLACEMENT:
            return state
        if not 0 <= action < n:
            raise IndexError(f"action {action} outside [0, {n})")
    a = torch.as_tensor(action, device=dev).to(torch.int64)
    hit = torch.arange(n, device=dev) == a[..., None]
    onehot, onehot_i = hit.to(F32), hit.to(I32)
    cached = torch.take_along_dim(state.image_cached,
                                  torch.clamp(a, 0, n - 1)[..., None],
                                  dim=-1)[..., 0]
    start_cost = torch.where(cached, cfg.warm_start_cost,
                             pull_cost_now(state, cfg))
    return state._replace(
        num_pods=state.num_pods + onehot_i,
        exp_pods=state.exp_pods + onehot_i,
        cpu_requested=state.cpu_requested
        + onehot * _per_node(pod.cpu_request, onehot),
        mem_requested=state.mem_requested
        + onehot * _per_node(pod.mem_request, onehot),
        pods_cpu=state.pods_cpu + onehot * _per_node(pod.cpu_demand, onehot),
        mem_used=state.mem_used + onehot * _per_node(pod.mem_demand, onehot),
        startup_cpu=state.startup_cpu + onehot * start_cost[..., None],
        image_cached=state.image_cached | hit,
    )


def hypothetical_place(state: ClusterState, pod: PodSpec, cfg: EnvConfig,
                       pull_cost=None) -> torch.Tensor:
    """Afterstate features for *every* candidate node: (..., N, 6).

    Row i = Table-2 features of node i as if the pod were placed there, in
    O(N): the placement delta applied to every node at once.  Pod fields
    shaped ``(..., 1)`` broadcast over the nodes: (B, 1) against one
    cluster gives a (B, N, 6) batch, ``(...)``-batched clusters take one
    pod each.  ``pull_cost`` pins the pull-contention scalar instead of
    reducing it from ``state``."""
    pull = pull_cost_now(state, cfg) if pull_cost is None else pull_cost
    pull = _per_node(pull, state.startup_cpu)
    start_cost = torch.where(torch.logical_not(state.image_cached), pull,
                             cfg.warm_start_cost)
    num_pods = state.num_pods + 1
    exp_pods = state.exp_pods + 1
    pods_cpu = state.pods_cpu + 1.0 * _as_f32(pod.cpu_demand, state)
    mem_used = state.mem_used + 1.0 * _as_f32(pod.mem_demand, state)
    startup_cpu = state.startup_cpu + start_cost

    used = _node_cpu_used(state.base_cpu, exp_pods > 0, pods_cpu, startup_cpu,
                          num_pods, state.cpu_capacity, cfg)
    return _feature_stack(used, mem_used, num_pods, state.max_pods, state.healthy,
                          state.uptime_hours, exp_pods, state.cpu_capacity,
                          state.mem_capacity)


def _as_f32(x, state: ClusterState) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32, device=state.base_cpu.device)


def hypothetical_place_one(state: ClusterState, pod: PodSpec, cfg: EnvConfig,
                           node) -> torch.Tensor:
    """Afterstate features of ONE candidate node per cluster: ``(..., 6)``.

    Row ``node (...)`` of ``hypothetical_place`` without the (N, 6) matrix
    (the replay stores only the afterstate it bound).  ``node`` must be a
    valid index: callers clamp the drop sentinel and zero-weight the
    sample.  Pod fields are floats or ``(...)``."""
    idx = torch.as_tensor(node, device=state.base_cpu.device).to(
        torch.int64)[..., None]

    def at(col):
        return torch.take_along_dim(col, idx, dim=-1)[..., 0]

    start_cost = torch.where(torch.logical_not(at(state.image_cached)),
                             pull_cost_now(state, cfg), cfg.warm_start_cost)
    num_pods = at(state.num_pods) + 1
    exp_pods = at(state.exp_pods) + 1
    pods_cpu = at(state.pods_cpu) + 1.0 * _as_f32(pod.cpu_demand, state)
    mem_used = at(state.mem_used) + 1.0 * _as_f32(pod.mem_demand, state)
    startup_cpu = at(state.startup_cpu) + start_cost
    cap = at(state.cpu_capacity)
    used = _node_cpu_used(at(state.base_cpu), exp_pods > 0, pods_cpu,
                          startup_cpu, num_pods, cap, cfg)
    return _feature_stack(used, mem_used, num_pods, at(state.max_pods),
                          at(state.healthy), at(state.uptime_hours),
                          exp_pods, cap, at(state.mem_capacity))


def tick(state: ClusterState, cfg: EnvConfig, dt_s) -> ClusterState:
    """Advance wall-clock by ``dt_s`` (a float or ``(...)``): decay startup
    transients by ``decay ** (dt / schedule_dt_s)``, accrue uptime."""
    dt = torch.as_tensor(dt_s, dtype=F32, device=state.base_cpu.device)
    decay = cfg.startup_decay ** (dt / cfg.schedule_dt_s)
    return state._replace(
        startup_cpu=state.startup_cpu * decay[..., None],
        uptime_hours=state.uptime_hours + (dt / 3600.0)[..., None],
        time_s=state.time_s + dt,
    )


def average_cpu_utilization(state: ClusterState, cfg: EnvConfig) -> torch.Tensor:
    """Cluster-wide average CPU% per node (idle nodes included): ``(...)``,
    the paper's metric (§4.3.2)."""
    return torch.mean(cpu_pct(state, cfg), dim=-1)


def node_watts(cfg: EnvConfig, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-node (idle_watts, peak_watts) of the homogeneous pool: (N,)."""
    device = resolve_device(device)
    return (torch.full((cfg.n_nodes,), cfg.idle_watts, dtype=F32,
                       device=device),
            torch.full((cfg.n_nodes,), cfg.peak_watts, dtype=F32,
                       device=device))


def nodes_active(state: ClusterState) -> torch.Tensor:
    """Nodes hosting >= 1 experiment pod, per cluster: int32 ``(...)``."""
    return torch.sum(state.exp_pods > 0, dim=-1).to(I32)


def fleet_power_w(state: ClusterState, cfg: EnvConfig) -> torch.Tensor:
    """Power (watts) billed to the experiment workload, per cluster: each
    node hosting our pods draws ``idle + (peak - idle) * cpu_util``; the
    others could be powered down and bill nothing."""
    idle, peak = node_watts(cfg, device=state.base_cpu.device)
    util = cpu_used(state, cfg) / state.cpu_capacity
    return torch.sum(torch.where(state.exp_pods > 0,
                                 idle + (peak - idle) * util,
                                 torch.zeros_like(util)), dim=-1)


# ---------------------------------------------------------------------------
# pod lifecycle: fixed-shape expiry ledger and retirement
# ---------------------------------------------------------------------------


def ledger_init(n_slots: int, batch: Tuple[int, ...] = (),
                device=None) -> PodLedger:
    """Empty expiry ledger: one slot per episode arrival, ``(*batch, K)``."""
    device = resolve_device(device)
    shape = tuple(batch) + (n_slots,)
    z = torch.zeros(shape, dtype=F32, device=device)
    return PodLedger(
        node=torch.full(shape, -1, dtype=I32, device=device),
        expiry_s=torch.full(shape, float("inf"), dtype=F32, device=device),
        spec=PodSpec(cpu_request=z, cpu_demand=z, mem_request=z,
                     mem_demand=z),
    )


def ledger_record(ledger: PodLedger, slot: int, action, expiry_s,
                  pod: PodSpec) -> PodLedger:
    """Write arrival ``slot`` (a host int): where each cluster's pod went
    (``action (...)``) and when it completes.  Dropped arrivals
    (``action == -1``) record as empty slots and never retire."""
    dev = ledger.node.device
    action = torch.as_tensor(action, device=dev).to(I32)

    def put(col, v):
        out = col.clone()
        out[..., slot] = torch.as_tensor(v, dtype=col.dtype, device=dev)
        return out

    expiry = torch.where(action >= 0,
                         torch.as_tensor(expiry_s, dtype=F32, device=dev),
                         float("inf"))
    return PodLedger(node=put(ledger.node, action),
                     expiry_s=put(ledger.expiry_s, expiry),
                     spec=PodSpec(*(put(c, v) for c, v in
                                    zip(ledger.spec, pod))))


def retire_expired(state: ClusterState, ledger: PodLedger
                   ) -> Tuple[ClusterState, PodLedger, torch.Tensor]:
    """Retire every ledger pod whose expiry has passed: release its CPU/mem
    requests, compute demand and pod slot on its node (one ``scatter_add``
    over the node axis per column), and free the slot.  With all-``inf``
    lifetimes nothing is due and the state passes through bit for bit.
    Returns (state, ledger, retired count ``(...)`` int32)."""
    n = state.n_nodes
    done = (ledger.node >= 0) & (ledger.expiry_s <= state.time_s[..., None])
    seg = torch.clamp(ledger.node, 0, n - 1).to(torch.int64)
    w = done.to(F32)
    zeros = torch.zeros(state.base_cpu.shape, dtype=F32,
                        device=state.base_cpu.device)

    def released(col):
        return zeros.scatter_add(-1, seg, w * col)

    cnt = torch.zeros_like(state.num_pods).scatter_add(-1, seg, done.to(I32))
    state = state._replace(
        num_pods=state.num_pods - cnt,
        exp_pods=state.exp_pods - cnt,
        cpu_requested=state.cpu_requested - released(ledger.spec.cpu_request),
        mem_requested=state.mem_requested - released(ledger.spec.mem_request),
        pods_cpu=state.pods_cpu - released(ledger.spec.cpu_demand),
        mem_used=state.mem_used - released(ledger.spec.mem_demand),
    )
    ledger = ledger._replace(node=torch.where(done, torch.full_like(
        ledger.node, -1), ledger.node))
    return state, ledger, torch.sum(done, dim=-1).to(I32)


# ---------------------------------------------------------------------------
# the episode loop
# ---------------------------------------------------------------------------

CHAOS_QUEUE_ITEM = ("failure traces are not ported yet: see ROADMAP.md, "
                    "queue 1, 'Chaos'")
CONSOLIDATE_QUEUE_ITEM = ("in-episode consolidation is not ported yet: see "
                          "ROADMAP.md, queue 1, 'Lifecycle and SDQN-n over "
                          "time'")


class _EpisodeAcc(NamedTuple):
    """Accumulators of the dt-weighted episode integrals, per cluster."""

    metric: torch.Tensor        # sum of avg-CPU% * dt
    dt: torch.Tensor            # total integrated wall-clock
    node_seconds: torch.Tensor  # sum of nodes_active * dt
    energy_j: torch.Tensor      # sum of fleet power * dt (joules)
    peak_active: torch.Tensor   # max nodes_active seen
    retired: torch.Tensor       # int32 pods completed + released


def run_episode(draws, cfg: EnvConfig, select_action: Callable, n_pods: int,
                pod_table: Optional[PodTable] = None, consolidate=None,
                select_carry=None, failure_trace=None,
                lead: Tuple[int, ...] = (), device=None) -> EpisodeResult:
    """Schedule ``n_pods`` arrivals with ``select_action``, settle, retire:
    every cluster of the draws' batch at once.

    ``draws`` (``core.draws``) gives the initial clusters (``(*batch, N)``)
    and each step's selector draws; ``lead`` prepends batch dimensions that
    share them (the candidate seeds of ``eval.engine``, validated on the
    same bursts).  Arrivals come from ``pod_table`` (fields ``(*batch,
    n_pods)`` or ``(n_pods,)``), else from ``draws.pod_table``.  Every
    placement is recorded in a ``PodLedger`` and ``retire_expired`` runs
    after each step, as the reference does when a pod table is supplied.

    ``select_action(step_draws, state, pod) -> node (...)``, or with
    ``select_carry`` ``(step_draws, state, pod, carry) -> (node, carry)``
    (sequence policy classes).  ``failure_trace`` and ``consolidate`` raise
    ``NotImplementedError`` (not ported yet).

    Returns ``EpisodeResult`` ``(state, placements, metric, dropped,
    stats)`` with the batch dimensions leading every field."""
    if failure_trace is not None:
        raise NotImplementedError(CHAOS_QUEUE_ITEM)
    if consolidate is not None:
        raise NotImplementedError(CONSOLIDATE_QUEUE_ITEM)
    device = resolve_device(device)
    lead = tuple(lead)
    state = draws.reset(cfg, device=device)
    batch = lead + tuple(state.time_s.shape)
    state = ClusterState(*(x.expand(lead + x.shape).clone() for x in state))
    if pod_table is None:
        pod_table = draws.pod_table(cfg, n_pods, 0, device=device)
    table = [torch.broadcast_to(torch.as_tensor(x, device=device),
                                batch + (n_pods,))
             for x in (*pod_table.specs, pod_table.dt_s,
                       pod_table.lifetime_s)]
    ledger = ledger_init(n_pods, batch, device=device)
    zf = torch.zeros(batch, dtype=F32, device=device)
    acc = _EpisodeAcc(zf, zf, zf, zf, zf, torch.zeros(batch, dtype=I32,
                                                      device=device))
    # one history carry per cluster (sequence policy classes)
    carry = (None if select_carry is None else
             select_carry.expand(batch + select_carry.shape).clone())

    def advance(st, ledger, dt, acc):
        st = tick(st, cfg, dt)
        st, ledger, n_ret = retire_expired(st, ledger)
        m = average_cpu_utilization(st, cfg)
        na = nodes_active(st).to(F32)
        acc = acc._replace(
            metric=acc.metric + m * dt,
            dt=acc.dt + dt,
            node_seconds=acc.node_seconds + na * dt,
            energy_j=acc.energy_j + fleet_power_w(st, cfg) * dt,
            peak_active=torch.maximum(acc.peak_active, na),
            retired=acc.retired + n_ret,
        )
        return st, ledger, acc

    dropped = torch.zeros(batch, dtype=I32, device=device)
    for t in range(n_pods):
        pod = PodSpec(*(col[..., t] for col in table[:4]))
        dt, lifetime = table[4][..., t], table[5][..., t]
        step = draws.step(0, t)
        if select_carry is None:
            a = select_action(step, state, pod)
        else:
            a, carry = select_action(step, state, pod, carry)
        state = place(state, a, pod, cfg)
        ledger = ledger_record(ledger, t, a, state.time_s + lifetime, pod)
        state, ledger, acc = advance(state, ledger, dt, acc)
        dropped = dropped + (a < 0).to(I32)
    for _ in range(cfg.settle_steps):
        state, ledger, acc = advance(state, ledger,
                                     torch.full(batch, cfg.schedule_dt_s,
                                                dtype=F32, device=device),
                                     acc)
    zi = torch.zeros(batch, dtype=I32, device=device)
    stats = EpisodeStats(
        nodes_active_mean=acc.node_seconds / acc.dt,
        nodes_active_final=nodes_active(state),
        nodes_active_peak=acc.peak_active.to(I32),
        node_seconds=acc.node_seconds,
        energy_wh=acc.energy_j / 3600.0,
        retired=acc.retired,
        evicted=zi, rescheduled=zi, lost=zi)
    return EpisodeResult(state=state, placements=state.num_pods,
                         metric=acc.metric / acc.dt, dropped=dropped,
                         stats=stats)
