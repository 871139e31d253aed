"""Kubernetes-cluster environment, homogeneous pool (PyTorch port).

Counterpart of ``repro.core.env`` for the serving slice: construction
(``reset``), the arrival stream without a scenario, the Table-2 features,
the k8s filtering predicates and the bind / afterstate transitions.  The
arithmetic follows the reference op for op, in float32, so that the port
agrees with it to float rounding.  Randomness comes from an explicit
``torch.Generator``; its draws differ from JAX's threefry streams, so the
parity tests build their states in JAX and carry them over through
``repro_torch.convert``.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import (NO_PLACEMENT, ClusterState, EnvConfig,
                                    PodSpec, PodTable)
from repro_torch.device import resolve_device

F32 = torch.float32
I32 = torch.int32

# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


def _uniform(gen: torch.Generator, n: int, lo: float = 0.0,
             hi: float = 1.0) -> torch.Tensor:
    """U[lo, hi) float32 draws on the generator's own device."""
    u = torch.rand((n,), generator=gen, dtype=F32, device=gen.device)
    return lo + u * (hi - lo)


def _profile(gen: torch.Generator, profile: tuple, jitter: float,
             n: int) -> torch.Tensor:
    """Tile `profile` to n entries, permute, jitter — stable totals, varied layout."""
    reps = -(-n // len(profile))  # ceil
    vals = torch.tensor(profile, dtype=F32).repeat(reps)[:n].to(gen.device)
    vals = vals[torch.randperm(n, generator=gen, device=gen.device)]
    return vals + _uniform(gen, n, -jitter, jitter)


def reset(gen: torch.Generator, cfg: EnvConfig, device=None) -> ClusterState:
    """A fresh homogeneous cluster drawn from ``gen``, on ``device``
    (``EnvConfig`` rejects scenario pools until they are ported)."""
    device = resolve_device(device)
    n = cfg.n_nodes
    uptime = _uniform(gen, n, *cfg.init_uptime_range_h)
    cap = torch.full((n,), cfg.cpu_capacity, dtype=F32, device=gen.device)
    mem_cap = torch.full((n,), cfg.mem_capacity, dtype=F32, device=gen.device)
    max_pods = torch.full((n,), cfg.max_pods, dtype=I32, device=gen.device)
    base = torch.clamp(_profile(gen, cfg.base_cpu_profile, cfg.base_cpu_jitter, n),
                       min=0.0)
    healthy = _uniform(gen, n) >= cfg.unhealthy_prob
    # pre-existing *requests* are permuted independently of pre-existing usage
    requested0 = cfg.cpu_capacity * torch.clamp(
        _profile(gen, cfg.requested_frac_profile, cfg.requested_frac_jitter, n),
        0.0, 0.95)
    pod0 = mean_pod(cfg)
    # bookings come from tenant pods: X millicores requested ~ X/request pods
    tenant_pods = (requested0 / pod0.cpu_request).to(I32)

    exp_pods0 = torch.zeros((n,), dtype=I32, device=gen.device)
    # a homogeneous pool has no pre-pulled images (cached_prob = 0)
    cached0 = torch.zeros((n,), dtype=torch.bool, device=gen.device)
    startup0 = torch.zeros((n,), dtype=F32, device=gen.device)
    if cfg.randomize_workload:
        # training-only domain randomization: nodes start mid-flight
        pods = torch.randint(0, cfg.randomize_max_pods + 1, (n,), generator=gen,
                             device=gen.device).to(I32)
        mem_den = max(max(pod0.mem_request, pod0.mem_demand), 1e-6)
        mem_fit = torch.floor(0.9 * mem_cap / mem_den).to(I32)
        slot_fit = max_pods - tenant_pods
        pods = torch.minimum(pods, torch.clamp(torch.minimum(mem_fit, slot_fit),
                                               min=0))
        empty = _uniform(gen, n) < cfg.randomize_empty_prob
        exp_pods0 = torch.where(empty, torch.zeros_like(pods), pods).to(I32)
        cached0 = cached0 | (exp_pods0 > 0) | (
            _uniform(gen, n) < cfg.randomize_cached_prob)
        startup0 = _uniform(gen, n, 0.0, 0.3 * cfg.image_pull_cost)

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
        time_s=torch.zeros((), dtype=F32, device=gen.device),
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


def sample_pod_table(gen: torch.Generator, cfg: EnvConfig, n_pods: int,
                     device=None) -> PodTable:
    """The paper's homogeneous burst: `n_pods` copies of the default pod every
    `schedule_dt_s` seconds, all running forever (no draw is taken)."""
    device = resolve_device(device)
    pod = default_pod(cfg)
    specs = PodSpec(*(torch.full((n_pods,), v, dtype=F32, device=device)
                      for v in pod))
    return PodTable(specs=specs,
                    dt_s=torch.full((n_pods,), cfg.schedule_dt_s, dtype=F32,
                                    device=device),
                    type_idx=torch.zeros((n_pods,), dtype=I32, device=device),
                    lifetime_s=torch.full((n_pods,), float("inf"), dtype=F32,
                                          device=device))


# ---------------------------------------------------------------------------
# observation (Table 2 features)
# ---------------------------------------------------------------------------


def _node_cpu_used(base_cpu, active, pods_cpu, startup_cpu, num_pods,
                   cpu_capacity, cfg: EnvConfig) -> torch.Tensor:
    """Elementwise per-node CPU model: base + overhead + demand + startup,
    CFS crowding past ``crowd_knee`` pods, contention past the knee."""
    crowd = torch.clamp(num_pods.to(F32) - cfg.crowd_knee, min=0.0)
    overhead = torch.where(active, torch.tensor(cfg.node_active_overhead, dtype=F32,
                                                device=active.device),
                           torch.tensor(0.0, dtype=F32, device=active.device))
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


def normalize_features(feats: torch.Tensor) -> torch.Tensor:
    """Scale raw Table-2 features to O(1) for the neural scorers."""
    return feats / FEATURE_SCALE.to(feats.device)


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
    """Cost of starting a cold image pull *right now*: 0-d float32.

    Each pull already in flight inflates a new one by
    ``pull_concurrency_coeff`` — a GLOBAL reduction over the snapshot."""
    in_flight = torch.sum(state.startup_cpu > 0.25 * cfg.image_pull_cost).to(F32)
    return cfg.image_pull_cost * (1.0 + cfg.pull_concurrency_coeff * in_flight)


def place(state: ClusterState, action, pod: PodSpec, cfg: EnvConfig) -> ClusterState:
    """Bind one pod to node `action` (int or 0-d integer tensor).

    ``action == NO_PLACEMENT`` (-1) is the drop sentinel: the reference's
    one-hot of -1 is a zero row, so the bind is a no-op and the state passes
    through unchanged.  ``torch.nn.functional.one_hot`` rejects -1, so the
    sentinel is handled explicitly here and the chosen row is updated in a
    copy of each column."""
    a = int(action)
    if a == NO_PLACEMENT:
        return state
    if not 0 <= a < state.n_nodes:
        raise IndexError(f"action {a} outside [0, {state.n_nodes})")
    start_cost = (cfg.warm_start_cost if bool(state.image_cached[a])
                  else pull_cost_now(state, cfg))

    def bump(col, delta):
        out = col.clone()
        out[a] = col[a] + delta
        return out

    cached = state.image_cached.clone()
    cached[a] = True
    return state._replace(
        num_pods=bump(state.num_pods, 1),
        exp_pods=bump(state.exp_pods, 1),
        cpu_requested=bump(state.cpu_requested, pod.cpu_request),
        mem_requested=bump(state.mem_requested, pod.mem_request),
        pods_cpu=bump(state.pods_cpu, pod.cpu_demand),
        mem_used=bump(state.mem_used, pod.mem_demand),
        startup_cpu=bump(state.startup_cpu, start_cost),
        image_cached=cached,
    )


def hypothetical_place(state: ClusterState, pod: PodSpec, cfg: EnvConfig,
                       pull_cost=None) -> torch.Tensor:
    """Afterstate features for *every* candidate node: (N, 6).

    Row i = Table-2 features of node i as if the pod were placed there, in
    O(N): the placement delta applied to every node at once.  Pod fields of
    shape (B, 1) give a (B, N, 6) batch.  ``pull_cost`` pins the global
    pull-contention scalar instead of reducing it from ``state``."""
    pull = pull_cost_now(state, cfg) if pull_cost is None else pull_cost
    pull = torch.as_tensor(pull, dtype=F32, device=state.startup_cpu.device)
    start_cost = torch.where(torch.logical_not(state.image_cached), pull,
                             torch.tensor(cfg.warm_start_cost, dtype=F32,
                                          device=pull.device))
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
