"""Kubernetes-cluster environment (PyTorch port of ``repro.core.env``).

Construction (``reset``) of the paper's homogeneous pool and of scenario
pools (heterogeneous node classes, ``core.types.ScenarioConfig``), the
arrival stream (the paper's burst, or a scenario's pod catalog with burst,
Poisson or diurnal gaps and lognormal lifetimes), the Table-2 features,
the k8s filtering predicates, the bind / unbind / afterstate transitions,
the clock, the pod ledger, the energy accounting and the episode loop
with its in-episode consolidation pass.  The arithmetic follows the
reference op for op, in float32, so that the port agrees with it to float
rounding.  Every function takes states with leading batch dimensions
(seeds, envs, trials): ``(..., N)`` columns, reduced over the node axis
only.  Randomness comes from an explicit ``torch.Generator`` or from
``core.draws``; torch cannot reproduce JAX's threefry streams, so the
scenario arms take their unit draws as tensors (``reset_draws``,
``pod_table_draws``, ``failure_draws``) and the parity tests hand them
the reference's.  Chaos: failure traces (sampled from each node class's
MTBF / MTTR, or given), eviction of the pods on down nodes into a
fixed-capacity reschedule ring, and one re-placement attempt per arrival.
"""
from __future__ import annotations

import functools
import math
import numbers
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import (NO_PLACEMENT, ClusterState, EnvConfig,
                                    EpisodeResult, EpisodeStats, FailureTrace,
                                    PodLedger, PodSpec, PodTable)
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


@functools.lru_cache(maxsize=None)
def _scenario_pool(scn) -> dict:
    """Static per-node numpy columns of a heterogeneous pool (class by
    class, in the scenario's order)."""

    def col(get, dtype=np.float32):
        return np.concatenate(
            [np.full(c.count, get(c), dtype) for c in scn.node_classes])

    return {
        "cpu_capacity": col(lambda c: c.cpu_capacity),
        "mem_capacity": col(lambda c: c.mem_capacity),
        "max_pods": col(lambda c: c.max_pods, np.int32),
        "unhealthy_prob": col(lambda c: c.unhealthy_prob),
        "cached_prob": col(lambda c: c.image_cached_prob),
        "base_lo": col(lambda c: c.base_cpu_frac[0]),
        "base_hi": col(lambda c: c.base_cpu_frac[1]),
        "req_lo": col(lambda c: c.requested_frac[0]),
        "req_hi": col(lambda c: c.requested_frac[1]),
        "idle_watts": col(lambda c: c.idle_watts),
        "peak_watts": col(lambda c: c.peak_watts),
        "mtbf": col(lambda c: c.mtbf_s),
        "mttr": col(lambda c: c.mttr_s),
    }


@functools.lru_cache(maxsize=None)
def _pool(scn, name: str, device: torch.device) -> torch.Tensor:
    """One pool column on ``device``, copied there once."""
    return torch.from_numpy(_scenario_pool(scn)[name]).to(device)


def _randomize_draws(gen: torch.Generator, cfg: EnvConfig, shape) -> dict:
    """The training resets' mid-flight draws: pods per node, and unit
    uniforms for the empty, cached and startup columns."""
    return {"pods": torch.randint(0, cfg.randomize_max_pods + 1, shape,
                                  generator=gen, device=gen.device).to(I32),
            "empty": _uniform(gen, shape), "cached_r": _uniform(gen, shape),
            "startup": _uniform(gen, shape)}


def reset_draws(gen: torch.Generator, cfg: EnvConfig, shape) -> dict:
    """A scenario reset's unit draws (``shape = (*batch, N)``): uniforms in
    [0, 1) for ``uptime``, ``base``, ``healthy``, ``requested`` and
    ``cached``, and with ``randomize_workload`` the mid-flight draws."""
    u = {k: _uniform(gen, shape) for k in ("uptime", "base", "healthy",
                                           "requested", "cached")}
    if cfg.randomize_workload:
        u.update(_randomize_draws(gen, cfg, shape))
    return u


def reset(gen: torch.Generator, cfg: EnvConfig, device=None,
          batch: Tuple[int, ...] = ()) -> ClusterState:
    """Fresh clusters drawn from ``gen``, ``(*batch, N)``, on ``device``:
    the paper's homogeneous pool, or the scenario's node classes."""
    device = resolve_device(device)
    shape = tuple(batch) + (cfg.n_nodes,)
    if cfg.scenario is not None:
        return scenario_reset(cfg, reset_draws(gen, cfg, shape), device)
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
    # a homogeneous pool has no pre-pulled images (cached_prob = 0)
    cached0 = torch.zeros(shape, dtype=torch.bool, device=dev)
    rand = (_randomize_draws(gen, cfg, shape) if cfg.randomize_workload
            else None)
    state = _populate(cfg, uptime, cap, mem_cap, max_pods, base, healthy,
                      requested0, cached0, rand)
    return ClusterState(*(x.to(device) for x in state))


def scenario_reset(cfg: EnvConfig, u: dict, device=None) -> ClusterState:
    """A scenario's clusters from their unit draws ``u`` (``reset_draws``'
    keys, ``(*batch, N)``): each class's capacities, base load and
    bookings uniform over its fractions of its own capacity, health and
    pre-pulled images from its probabilities."""
    device = resolve_device(device)
    scn = cfg.scenario
    dev = u["uptime"].device

    def col(name):
        return _pool(scn, name, dev)

    def between(x, lo, hi):
        return x * (hi - lo) + lo

    shape = u["uptime"].shape
    lo_h, hi_h = cfg.init_uptime_range_h
    uptime = between(u["uptime"], lo_h, hi_h)
    cap = col("cpu_capacity").expand(shape).clone()
    # base load and bookings scale with each class's own capacity
    base = cap * between(u["base"], col("base_lo"), col("base_hi"))
    healthy = u["healthy"] >= col("unhealthy_prob")
    requested0 = cap * torch.clamp(
        between(u["requested"], col("req_lo"), col("req_hi")), 0.0, 0.95)
    cached0 = u["cached"] < col("cached_prob")
    rand = ({k: u[k] for k in ("pods", "empty", "cached_r", "startup")}
            if cfg.randomize_workload else None)
    state = _populate(cfg, uptime, cap,
                      col("mem_capacity").expand(shape).clone(),
                      col("max_pods").expand(shape).clone(), base, healthy,
                      requested0, cached0, rand)
    return ClusterState(*(x.to(device) for x in state))


def _populate(cfg: EnvConfig, uptime, cap, mem_cap, max_pods, base, healthy,
              requested0, cached0, rand: Optional[dict]) -> ClusterState:
    """The reset's shared tail: tenant pods from the bookings, and with
    ``rand`` (``_randomize_draws``) the training resets' mid-flight
    workload, kept to what each node's memory and pod slots hold."""
    pod0 = mean_pod(cfg)
    # bookings come from tenant pods: X millicores requested ~ X/request pods
    tenant_pods = (requested0 / pod0.cpu_request).to(I32)
    exp_pods0 = torch.zeros_like(tenant_pods)
    startup0 = torch.zeros_like(base)
    if rand is not None:
        # training-only domain randomization: nodes start mid-flight
        mem_den = max(max(pod0.mem_request, pod0.mem_demand), 1e-6)
        mem_fit = torch.floor(0.9 * mem_cap / mem_den).to(I32)
        slot_fit = max_pods - tenant_pods
        pods = torch.minimum(rand["pods"],
                             torch.clamp(torch.minimum(mem_fit, slot_fit),
                                         min=0))
        empty = rand["empty"] < cfg.randomize_empty_prob
        exp_pods0 = torch.where(empty, torch.zeros_like(pods), pods).to(I32)
        cached0 = cached0 | (exp_pods0 > 0) | (
            rand["cached_r"] < cfg.randomize_cached_prob)
        startup0 = rand["startup"] * (0.3 * cfg.image_pull_cost)

    fexp = exp_pods0.to(F32)
    return ClusterState(
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
        time_s=torch.zeros(uptime.shape[:-1], dtype=F32, device=uptime.device),
    )


def default_pod(cfg: EnvConfig) -> PodSpec:
    return PodSpec(cpu_request=float(cfg.pod_cpu_request),
                   cpu_demand=float(cfg.pod_cpu_demand),
                   mem_request=float(cfg.pod_mem_request),
                   mem_demand=float(cfg.pod_mem_demand))


def mean_pod(cfg: EnvConfig) -> PodSpec:
    """Mixture-weighted mean PodSpec of the scenario's catalog, rounded to
    float32 as the reference's (the default pod without a scenario): the
    pre-existing workload's accounting at reset."""
    scn = cfg.scenario
    if scn is None:
        return default_pod(cfg)
    w = np.asarray([p.weight for p in scn.pod_types], np.float64)
    w = w / w.sum()

    def m(field):
        vals = np.asarray([getattr(p, field) for p in scn.pod_types])
        return float(np.float32(np.sum(w * vals)))

    return PodSpec(*(m(f) for f in PodSpec._fields))


# ---------------------------------------------------------------------------
# arrival stream (the paper's burst, or a scenario's pod catalog)
# ---------------------------------------------------------------------------


def pod_table_draws(gen: torch.Generator, cfg: EnvConfig, shape) -> dict:
    """A scenario pod table's draws (``shape = (*batch, n_pods)``): each
    arrival's pod type from the catalog's mixture weights (inverse CDF of a
    uniform), unit exponentials ``e`` for Poisson and diurnal gaps, and
    standard normals ``z`` for the lifetimes."""
    scn = cfg.scenario
    w = np.asarray([p.weight for p in scn.pod_types], np.float64)
    cdf = torch.tensor(np.cumsum(w / w.sum()), dtype=torch.float64,
                       device=gen.device)
    u = torch.rand(shape, generator=gen, dtype=torch.float64,
                   device=gen.device)
    out = {"type_idx": torch.clamp(torch.searchsorted(cdf, u, right=True),
                                   max=len(w) - 1).to(I32)}
    if scn.arrival.kind != "burst":
        out["e"] = -torch.log1p(-_uniform(gen, shape))
    out["z"] = torch.randn(shape, generator=gen, dtype=F32, device=gen.device)
    return out


def _arrival_gaps(cfg: EnvConfig, e: Optional[torch.Tensor], shape,
                  device) -> torch.Tensor:
    """Inter-arrival gaps ``(*batch, n_pods)`` from unit exponentials
    ``e``: a fixed ``schedule_dt_s`` for bursts, ``e / rate`` for Poisson,
    and for diurnal streams a rate modulated by a sine of the arrival
    clock, advanced arrival by arrival."""
    arr = cfg.scenario.arrival if cfg.scenario is not None else None
    if arr is None or arr.kind == "burst":
        return torch.full(shape, cfg.schedule_dt_s, dtype=F32, device=device)
    if arr.kind == "poisson":
        return e / arr.rate_per_s
    if arr.kind != "diurnal":
        raise ValueError(f"unknown arrival kind: {arr.kind!r}")
    t = torch.zeros(e.shape[:-1], dtype=F32, device=e.device)
    gaps = []
    for i in range(e.shape[-1]):
        rate = arr.rate_per_s * (1.0 + arr.depth * torch.sin(
            2.0 * math.pi * t / arr.period_s))
        dt = e[..., i] / torch.clamp(rate, min=1e-6)
        t = t + dt
        gaps.append(dt)
    return torch.stack(gaps, dim=-1)


def _sample_lifetimes(scn, type_idx: torch.Tensor,
                      z: torch.Tensor) -> torch.Tensor:
    """Per-arrival running durations: lognormal with each type's mean and
    coefficient of variation (``cv = 0`` is the mean itself, ``inf`` mean
    never finishes)."""
    dev = z.device
    mean = torch.tensor([p.lifetime_mean_s for p in scn.pod_types], dtype=F32,
                        device=dev)
    cv = torch.tensor([p.lifetime_cv for p in scn.pod_types], dtype=F32,
                      device=dev)
    sigma2 = torch.log1p(cv * cv)
    # mean = exp(mu + sigma^2 / 2); an inf mean propagates to inf
    mu = torch.log(mean) - 0.5 * sigma2
    idx = type_idx.to(torch.int64)
    return torch.exp(mu[idx] + torch.sqrt(sigma2)[idx] * z)


def scenario_pod_table(cfg: EnvConfig, d: dict, device=None) -> PodTable:
    """A scenario's arrival stream from its draws ``d`` (``pod_table_draws``'
    keys): each arrival's catalog entry, gap and lifetime."""
    device = resolve_device(device)
    scn = cfg.scenario
    idx = d["type_idx"].to(torch.int64)
    dev = idx.device
    specs = PodSpec(*(torch.tensor([getattr(p, f) for p in scn.pod_types],
                                   dtype=F32, device=dev)[idx]
                      for f in PodSpec._fields))
    table = PodTable(specs=specs,
                     dt_s=_arrival_gaps(cfg, d.get("e"), idx.shape, dev),
                     type_idx=d["type_idx"].to(I32),
                     lifetime_s=_sample_lifetimes(scn, idx, d["z"]))
    return PodTable(PodSpec(*(x.to(device) for x in table.specs)),
                    *(x.to(device) for x in table[1:]))


def sample_pod_table(gen: Optional[torch.Generator], cfg: EnvConfig,
                     n_pods: int, device=None,
                     batch: Tuple[int, ...] = ()) -> PodTable:
    """The episode's arrival streams, fields ``(*batch, n_pods)``: from the
    scenario's catalog (draws from ``gen``), or without a scenario the
    paper's homogeneous burst — `n_pods` copies of the default pod every
    `schedule_dt_s` seconds, all running forever, no draw taken."""
    device = resolve_device(device)
    shape = tuple(batch) + (n_pods,)
    if cfg.scenario is not None:
        return scenario_pod_table(cfg, pod_table_draws(gen, cfg, shape),
                                  device)
    pod = default_pod(cfg)
    specs = PodSpec(*(torch.full(shape, v, dtype=F32, device=device)
                      for v in pod))
    return PodTable(specs=specs,
                    dt_s=_arrival_gaps(cfg, None, shape, device),
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


def remove_pod(state: ClusterState, node, pod: PodSpec,
               count=1) -> ClusterState:
    """Unbind ``count`` pods of spec ``pod`` from ``node`` per cluster (an
    int or ``(...)``; pod fields floats or ``(...)``): the exact inverse of
    ``place``'s resource accounting.  Startup transients and the cached
    image stay: a pod finishing or migrating undoes no pull."""
    dev = state.base_cpu.device
    a = torch.as_tensor(node, device=dev).to(torch.int64)
    hit = torch.arange(state.n_nodes, device=dev) == a[..., None]
    onehot = hit.to(F32) * _per_node(count, hit)
    onehot_i = onehot.to(I32)
    return state._replace(
        num_pods=state.num_pods - onehot_i,
        exp_pods=state.exp_pods - onehot_i,
        cpu_requested=state.cpu_requested
        - onehot * _per_node(pod.cpu_request, onehot),
        mem_requested=state.mem_requested
        - onehot * _per_node(pod.mem_request, onehot),
        pods_cpu=state.pods_cpu - onehot * _per_node(pod.cpu_demand, onehot),
        mem_used=state.mem_used - onehot * _per_node(pod.mem_demand, onehot),
    )


def where_tree(mask: torch.Tensor, new, old):
    """``new`` where ``mask (...)`` holds, else ``old``, field by field of
    two NamedTuples of tensors with leading dimensions ``(...)``."""
    def pick(a, b):
        if isinstance(a, tuple):
            return type(a)(*(pick(x, y) for x, y in zip(a, b)))
        m = mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim()))
        return torch.where(m, a, b)

    return pick(new, old)


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
    """Per-node (idle_watts, peak_watts): (N,), per class for a scenario."""
    device = resolve_device(device)
    if cfg.scenario is not None:
        return (_pool(cfg.scenario, "idle_watts", device),
                _pool(cfg.scenario, "peak_watts", device))
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


def ledger_record(ledger: PodLedger, slot, action, expiry_s,
                  pod: PodSpec) -> PodLedger:
    """Write arrival ``slot`` (a host int, or an integer tensor ``(...)``:
    a slot per cluster): where each cluster's pod went (``action (...)``)
    and when it completes.  Dropped arrivals (``action == -1``) record as
    empty slots and never retire."""
    dev = ledger.node.device
    batch = ledger.node.shape[:-1]
    idx = torch.as_tensor(slot, device=dev).to(torch.int64).expand(
        batch)[..., None]
    action = torch.as_tensor(action, device=dev).to(I32)

    def put(col, v):
        v = torch.as_tensor(v, dtype=col.dtype, device=dev).expand(batch)
        return col.scatter(-1, idx, v[..., None])

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


def has_lifecycle(cfg: EnvConfig) -> bool:
    """True when the scenario's catalog holds a finite-lifetime pod type
    (pods can retire mid-episode)."""
    scn = cfg.scenario
    return scn is not None and any(math.isfinite(p.lifetime_mean_s)
                                   for p in scn.pod_types)


def has_chaos(cfg: EnvConfig) -> bool:
    """True when a node class can fail mid-episode (finite ``mtbf_s``)."""
    scn = cfg.scenario
    return scn is not None and any(math.isfinite(c.mtbf_s)
                                   for c in scn.node_classes)


# ---------------------------------------------------------------------------
# chaos: failure traces, eviction, the reschedule ring
# ---------------------------------------------------------------------------


def empty_failure_trace(n_nodes: int, cycles: int = 1,
                        device=None) -> FailureTrace:
    """A trace in which no node ever fails (every window at ``inf``)."""
    device = resolve_device(device)
    full = torch.full((cycles, n_nodes), float("inf"), dtype=F32,
                      device=device)
    return FailureTrace(fail_s=full, recover_s=full.clone())


def failure_draws(gen: torch.Generator, cfg: EnvConfig, shape,
                  cycles: Optional[int] = None) -> torch.Tensor:
    """A failure trace's unit exponentials, ``(*shape, cycles, 2, N)``:
    ``[..., c, 0, :]`` the up time before outage ``c``, ``[..., c, 1, :]``
    its length."""
    cycles = cfg.chaos_cycles if cycles is None else cycles
    return -torch.log1p(-_uniform(gen, tuple(shape)
                                  + (cycles, 2, cfg.n_nodes)))


def sample_failure_trace(cfg: EnvConfig, e: torch.Tensor,
                         device=None) -> FailureTrace:
    """Per-node fail / recover schedules from unit exponentials ``e``
    (``failure_draws``' layout): node ``n``'s ``c``-th outage starts
    ``mtbf * e`` after its previous recovery and lasts ``mttr * e``, each
    class's MTBF / MTTR (``inf`` / 60 s without a scenario).  The cycles
    accumulate one by one, so ``mtbf = inf`` stays ``inf`` (a cumsum would
    meet ``inf - inf``), and the exponentials are clamped away from zero
    so that ``inf * 0`` never appears."""
    device = resolve_device(device)
    e = e.to(device=device, dtype=F32)
    n = e.shape[-1]
    if cfg.scenario is None:
        mtbf = torch.full((n,), float("inf"), dtype=F32, device=device)
        mttr = torch.full((n,), 60.0, dtype=F32, device=device)
    else:
        mtbf = _pool(cfg.scenario, "mtbf", device)
        mttr = _pool(cfg.scenario, "mttr", device)
    prev = torch.zeros(e.shape[:-3] + (n,), dtype=F32, device=device)
    fails, recovers = [], []
    for c in range(e.shape[-3]):
        f = prev + mtbf * torch.clamp(e[..., c, 0, :], min=1e-6)
        r = f + mttr * torch.clamp(e[..., c, 1, :], min=1e-6)
        fails.append(f)
        recovers.append(r)
        prev = r
    return FailureTrace(fail_s=torch.stack(fails, dim=-2),
                        recover_s=torch.stack(recovers, dim=-2))


def trace_down(trace: FailureTrace, t_s) -> torch.Tensor:
    """Per-node down mask at episode time ``t_s`` (a float or ``(...)``):
    ``(..., N)`` bool."""
    t = torch.as_tensor(t_s, dtype=F32,
                        device=trace.fail_s.device)[..., None, None]
    return torch.any((trace.fail_s <= t) & (t < trace.recover_s), dim=-2)


class RescheduleQueue(NamedTuple):
    """Fixed-capacity ring of evicted pods awaiting re-placement, per
    cluster: each entry is the pod's own ledger slot (its spec is still
    recorded there) and the run time it had left when its node died.
    ``head`` / ``count`` bound the live window; pushes past capacity are
    lost (counted, never silent)."""

    slot: torch.Tensor         # (..., R) int32 ledger slot of each entry
    remaining_s: torch.Tensor  # (..., R) f32 run time left at eviction
    head: torch.Tensor         # (...) int32 index of the oldest entry
    count: torch.Tensor        # (...) int32 number of live entries


def reschedule_queue_init(cap: int, batch: Tuple[int, ...] = (),
                          device=None) -> RescheduleQueue:
    device = resolve_device(device)
    shape = tuple(batch) + (cap,)
    zi = torch.zeros(tuple(batch), dtype=I32, device=device)
    return RescheduleQueue(
        slot=torch.full(shape, -1, dtype=I32, device=device),
        remaining_s=torch.zeros(shape, dtype=F32, device=device),
        head=zi, count=zi.clone())


def _ring_set(col: torch.Tensor, pos: torch.Tensor,
              values: torch.Tensor) -> torch.Tensor:
    """``col (..., R)`` with ``values`` written at ``pos`` (same shape as
    ``values``), where ``pos == R`` drops the write: the scatter goes into
    a ring one slot wider and the spare slot is sliced off."""
    spare = torch.zeros(col.shape[:-1] + (1,), dtype=col.dtype,
                        device=col.device)
    wide = torch.cat([col, spare], dim=-1)
    return wide.scatter(-1, pos, values.to(col.dtype))[..., :-1]


def _queue_push(q: RescheduleQueue, mask: torch.Tensor, values: torch.Tensor,
                cap: int) -> Tuple[RescheduleQueue, torch.Tensor]:
    """Push every masked ledger slot (``mask (..., K)``) into its cluster's
    ring in slot order, with ``values (..., K)``; entries past the free
    space are dropped and returned as the overflow (lost) count ``(...)``."""
    space = cap - q.count
    rank = torch.cumsum(mask.to(I32), dim=-1) - 1
    ok = mask & (rank < space[..., None])
    pos = torch.where(ok, (q.head[..., None] + q.count[..., None] + rank)
                      % cap, cap).to(torch.int64)
    slot_ids = torch.arange(mask.shape[-1], dtype=I32,
                            device=mask.device).expand(mask.shape)
    n_mask = torch.sum(mask, dim=-1).to(I32)
    n_push = torch.minimum(n_mask, space)
    q = q._replace(slot=_ring_set(q.slot, pos, slot_ids),
                   remaining_s=_ring_set(q.remaining_s, pos, values),
                   count=q.count + n_push)
    return q, n_mask - n_push


def evict_down_pods(state: ClusterState, ledger: PodLedger, q: RescheduleQueue,
                    healthy_base: torch.Tensor, trace: FailureTrace, cap: int
                    ) -> Tuple[ClusterState, PodLedger, RescheduleQueue,
                               torch.Tensor, torch.Tensor]:
    """Apply the failure trace at each cluster's clock: ``healthy`` becomes
    ``healthy_base & ~down(t)`` (a node that started NotReady stays down
    after its outage), every ledger pod on a down node is released (one
    ``scatter_add`` over the node axis per column, as ``retire_expired``)
    and pushed into the ring with its remaining run time.  An evicted
    slot's node is -1, so a node staying down evicts nothing new.
    Returns (state, ledger, queue, evicted ``(...)``, overflow lost
    ``(...)``)."""
    n = state.n_nodes
    down = trace_down(trace, state.time_s)
    state = state._replace(healthy=healthy_base & torch.logical_not(down))
    seg = torch.clamp(ledger.node, 0, n - 1).to(torch.int64)
    evict = (ledger.node >= 0) & torch.take_along_dim(
        down.expand(state.base_cpu.shape), seg, dim=-1)
    w = evict.to(F32)
    zeros = torch.zeros(state.base_cpu.shape, dtype=F32,
                        device=state.base_cpu.device)

    def released(col):
        return zeros.scatter_add(-1, seg, w * col)

    cnt = torch.zeros_like(state.num_pods).scatter_add(-1, seg,
                                                       evict.to(I32))
    state = state._replace(
        num_pods=state.num_pods - cnt,
        exp_pods=state.exp_pods - cnt,
        cpu_requested=state.cpu_requested - released(ledger.spec.cpu_request),
        mem_requested=state.mem_requested - released(ledger.spec.mem_request),
        pods_cpu=state.pods_cpu - released(ledger.spec.cpu_demand),
        mem_used=state.mem_used - released(ledger.spec.mem_demand),
    )
    remaining = ledger.expiry_s - state.time_s[..., None]
    ledger = ledger._replace(node=torch.where(evict, torch.full_like(
        ledger.node, -1), ledger.node))
    q, n_lost = _queue_push(q, evict, remaining, cap)
    return state, ledger, q, torch.sum(evict, dim=-1).to(I32), n_lost


def take_last(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``col[..., idx]`` per cluster: ``col (..., K)``, ``idx (...)``."""
    return torch.take_along_dim(col, idx.to(torch.int64)[..., None],
                                dim=-1)[..., 0]


# ---------------------------------------------------------------------------
# the episode loop
# ---------------------------------------------------------------------------


class _EpisodeAcc(NamedTuple):
    """Accumulators of the dt-weighted episode integrals, per cluster."""

    metric: torch.Tensor        # sum of avg-CPU% * dt
    dt: torch.Tensor            # total integrated wall-clock
    node_seconds: torch.Tensor  # sum of nodes_active * dt
    energy_j: torch.Tensor      # sum of fleet power * dt (joules)
    peak_active: torch.Tensor   # max nodes_active seen
    retired: torch.Tensor       # int32 pods completed + released
    moved: torch.Tensor         # int32 pods the kept passes migrated
    evicted: torch.Tensor       # int32 pods killed by node failures
    rescheduled: torch.Tensor   # int32 evicted pods re-placed in-episode
    lost: torch.Tensor          # int32 evicted pods dropped off the ring


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
    (sequence policy classes).  ``consolidate`` (``sched.elastic.
    make_consolidator``) runs after every clock step that crosses a
    multiple of ``cfg.consolidate_every_s`` (0 = off): it runs on every
    cluster and is kept where that cluster's clock crossed, so that no
    value is read back; ``stats.moved`` adds up the pods the kept passes
    moved.

    ``failure_trace`` (a ``FailureTrace``, ``(C, N)`` or ``(*batch, C,
    N)``) injects mid-episode node failures; without one, a scenario with
    a finite-MTBF node class samples it from ``draws.failure``.  After
    each step's retirements the pods on down nodes are evicted into a
    ``cfg.chaos_requeue_cap`` ring, and each arrival step makes one
    re-placement attempt of the ring's head through the same selector
    (``step_draws.reschedule()`` draws), back into the pod's own ledger
    slot with its remaining run time; a failed attempt rotates the entry
    to the tail.  Evictees still queued at the end count as lost.

    Returns ``EpisodeResult`` ``(state, placements, metric, dropped,
    stats)`` with the batch dimensions leading every field."""
    do_consolidate = consolidate is not None and cfg.consolidate_every_s > 0.0
    use_chaos = failure_trace is not None or has_chaos(cfg)
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
    zi = torch.zeros(batch, dtype=I32, device=device)
    acc = _EpisodeAcc(zf, zf, zf, zf, zf, zi, zi, zi, zi, zi)
    # one history carry per cluster (sequence policy classes)
    carry = (None if select_carry is None else
             select_carry.expand(batch + select_carry.shape).clone())
    cap = cfg.chaos_requeue_cap
    queue = reschedule_queue_init(cap, batch, device=device)
    if use_chaos:
        if failure_trace is None:
            failure_trace = sample_failure_trace(
                cfg, draws.failure(cfg, 0, device=device), device)
        failure_trace = FailureTrace(*(x.to(device=device, dtype=F32)
                                       for x in failure_trace))
    healthy_base = state.healthy

    def select(step, st, pod, pc):
        if select_carry is None:
            return select_action(step, st, pod), pc
        return select_action(step, st, pod, pc)

    def advance(st, ledger, q, dt, acc):
        t_before = st.time_s
        st = tick(st, cfg, dt)
        st, ledger, n_ret = retire_expired(st, ledger)
        evicted, lost = acc.evicted, acc.lost
        if use_chaos:
            # retire, then evict: a pod both expired and on a dead node
            # releases once (retirement already freed its slot)
            st, ledger, q, n_ev, n_lost = evict_down_pods(
                st, ledger, q, healthy_base, failure_trace, cap)
            evicted, lost = evicted + n_ev, lost + n_lost
        moved = acc.moved
        if do_consolidate:
            period = cfg.consolidate_every_s
            crossed = (torch.floor(st.time_s / period)
                       > torch.floor(t_before / period))
            st2, led2, n_moved = consolidate(st, ledger)
            st = where_tree(crossed, st2, st)
            ledger = where_tree(crossed, led2, ledger)
            moved = moved + torch.where(crossed, n_moved, 0)
        m = average_cpu_utilization(st, cfg)
        na = nodes_active(st).to(F32)
        acc = acc._replace(
            metric=acc.metric + m * dt,
            dt=acc.dt + dt,
            node_seconds=acc.node_seconds + na * dt,
            energy_j=acc.energy_j + fleet_power_w(st, cfg) * dt,
            peak_active=torch.maximum(acc.peak_active, na),
            retired=acc.retired + n_ret,
            moved=moved, evicted=evicted, lost=lost,
        )
        return st, ledger, q, acc

    def try_reschedule(step, st, ledger, q, acc, pc):
        """One re-placement attempt of each ring's head; every branch is
        masked, so with an empty ring the block is the identity."""
        has = q.count > 0
        slot = torch.clamp(take_last(q.slot, q.head), 0, n_pods - 1)
        remaining = take_last(q.remaining_s, q.head)
        rpod = PodSpec(*(take_last(col, slot) for col in ledger.spec))
        a, pc2 = select(step.reschedule(), st, rpod, pc)
        if pc is not None:
            # the carry advances only where the ring held a pod
            pc = torch.where(has.reshape(has.shape + (1,) * (
                pc.dim() - has.dim())), pc2, pc)
        placed = has & (a >= 0)
        a_eff = torch.where(placed, a.to(I32), NO_PLACEMENT)
        st = place(st, a_eff, rpod, cfg)
        ledger = where_tree(placed, ledger_record(
            ledger, slot, a_eff, st.time_s + remaining, rpod), ledger)
        # success pops the head; failure rotates it to the tail (writing
        # at (head + count) % cap and advancing head together is a correct
        # rotation even when the ring is full)
        tail = ((q.head + q.count) % cap).to(torch.int64)[..., None]
        rotated = (has & torch.logical_not(placed))[..., None]
        head_slot = take_last(q.slot, q.head)[..., None]
        q = q._replace(
            slot=torch.where(rotated, q.slot.scatter(-1, tail, head_slot),
                             q.slot),
            remaining_s=torch.where(
                rotated, q.remaining_s.scatter(-1, tail, remaining[..., None]),
                q.remaining_s),
            head=torch.where(has, (q.head + 1) % cap, q.head),
            count=torch.where(placed, q.count - 1, q.count))
        acc = acc._replace(rescheduled=acc.rescheduled + placed.to(I32))
        return st, ledger, q, acc, pc

    dropped = torch.zeros(batch, dtype=I32, device=device)
    for t in range(n_pods):
        pod = PodSpec(*(col[..., t] for col in table[:4]))
        dt, lifetime = table[4][..., t], table[5][..., t]
        step = draws.step(0, t)
        a, carry = select(step, state, pod, carry)
        state = place(state, a, pod, cfg)
        ledger = ledger_record(ledger, t, a, state.time_s + lifetime, pod)
        if use_chaos:
            state, ledger, queue, acc, carry = try_reschedule(
                step, state, ledger, queue, acc, carry)
        state, ledger, queue, acc = advance(state, ledger, queue, dt, acc)
        dropped = dropped + (a < 0).to(I32)
    for _ in range(cfg.settle_steps):
        state, ledger, queue, acc = advance(
            state, ledger, queue,
            torch.full(batch, cfg.schedule_dt_s, dtype=F32, device=device),
            acc)
    stats = EpisodeStats(
        nodes_active_mean=acc.node_seconds / acc.dt,
        nodes_active_final=nodes_active(state),
        nodes_active_peak=acc.peak_active.to(I32),
        node_seconds=acc.node_seconds,
        energy_wh=acc.energy_j / 3600.0,
        retired=acc.retired,
        evicted=acc.evicted,
        rescheduled=acc.rescheduled,
        # evictees still queued never re-entered before the episode ended
        lost=acc.lost + queue.count,
        moved=acc.moved)
    return EpisodeResult(state=state, placements=state.num_pods,
                         metric=acc.metric / acc.dt, dropped=dropped,
                         stats=stats)
