"""Tensor types for the cluster scheduling environment (PyTorch port).

Counterpart of ``repro.core.types``: the same NamedTuples with the same
field order and dtypes (int32 counts, bool ``healthy`` / ``image_cached``,
float32 for the rest), and the same frozen ``EnvConfig``.  Every field may
carry leading batch dimensions (seeds, envs, trials) before the node axis:
``(..., N)`` columns with a ``(...)`` clock.  Scenarios (heterogeneous
node pools x pod catalogs x arrival processes) are the reference's frozen,
hashable dataclasses, field for field, so an ``EnvConfig`` carrying one
keys ``train_mixture``'s segments.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

# "no feasible target" sentinel: selectors return it when the filtering
# phase leaves no candidate; ``env.place`` treats it as a no-op bind.
NO_PLACEMENT = -1

# width of the Table-2 afterstate feature row
FEATURE_DIM = 6

class ClusterState(NamedTuple):
    """Vectorized node state: columns ``(..., N)`` over the nodes, the clock
    ``(...)``, for any leading batch dimensions."""

    cpu_capacity: torch.Tensor    # (N,) f32 millicores
    mem_capacity: torch.Tensor    # (N,) f32 MiB
    max_pods: torch.Tensor        # (N,) int32
    healthy: torch.Tensor         # (N,) bool
    uptime_hours: torch.Tensor    # (N,) f32
    num_pods: torch.Tensor        # (N,) int32 — ALL pods (tenant + experiment)
    exp_pods: torch.Tensor        # (N,) int32 — experiment pods (our image)
    cpu_requested: torch.Tensor   # (N,) f32 millicores booked by requests
    mem_requested: torch.Tensor   # (N,) f32 MiB booked by requests
    pods_cpu: torch.Tensor        # (N,) f32 millicores of pod compute demand
    mem_used: torch.Tensor        # (N,) f32 MiB actually used
    base_cpu: torch.Tensor        # (N,) f32 pre-existing load
    startup_cpu: torch.Tensor     # (N,) f32 transient startup/pull CPU
    image_cached: torch.Tensor    # (N,) bool — experiment image on node
    time_s: torch.Tensor          # () f32 seconds since episode start

    @property
    def n_nodes(self) -> int:
        return self.cpu_capacity.shape[-1]


class PodSpec(NamedTuple):
    """One compute-intensive pod; fields are floats, 0-d or (B,) tensors."""

    cpu_request: object   # millicores (scheduling request)
    cpu_demand: object    # millicores actually burned while running
    mem_request: object   # MiB
    mem_demand: object    # MiB


class PodLedger(NamedTuple):
    """Fixed-shape expiry ledger: one slot per episode arrival (``K``).

    Slot ``t`` records where arrival ``t`` bound and when it completes;
    ``env.retire_expired`` releases every due slot.  ``node == -1`` marks
    empty, dropped or retired slots."""

    node: torch.Tensor              # (..., K) int32; -1 = empty / retired
    expiry_s: torch.Tensor          # (..., K) f32 absolute completion time
    spec: "PodSpec"                 # each field (..., K): what to release


class FailureTrace(NamedTuple):
    """Fixed-shape mid-episode node fail/recover schedule.

    ``fail_s[..., c, n]`` / ``recover_s[..., c, n]`` bound node ``n``'s
    ``c``-th outage window: the node is down whenever ``fail_s <= t <
    recover_s``.  ``inf`` marks an unused cycle, so node health at any
    time is a pure function of the trace.  Leading batch dimensions are
    optional: a ``(C, N)`` trace is shared by every cluster of a batch.
    Sampled per node from each ``NodeClass``'s MTBF / MTTR
    (``env.sample_failure_trace``); an all-``inf`` trace
    (``env.empty_failure_trace``) injects nothing."""

    fail_s: torch.Tensor              # (..., C, N) f32 outage start times
    recover_s: torch.Tensor           # (..., C, N) f32 recovery times


class EpisodeStats(NamedTuple):
    """Time-resolved lifecycle metrics of an episode (one per batch row).

    ``evicted`` / ``rescheduled`` / ``lost`` account for mid-episode node
    failures (``evicted == rescheduled + lost``).  ``moved`` counts the
    pods that the kept consolidation passes migrated (zero without
    ``consolidate``); the reference does not report it."""

    nodes_active_mean: torch.Tensor   # time-averaged active-node count
    nodes_active_final: torch.Tensor  # int32, active nodes at episode end
    nodes_active_peak: torch.Tensor   # int32, most active nodes seen
    node_seconds: torch.Tensor        # integral of nodes_active over time
    energy_wh: torch.Tensor           # integral of active-node power draw
    retired: torch.Tensor             # int32, pods completed + released
    evicted: torch.Tensor             # int32, pods killed by node failures
    rescheduled: torch.Tensor         # int32, evicted pods re-placed
    lost: torch.Tensor                # int32, evicted pods never re-placed
    moved: torch.Tensor               # int32, pods consolidation moved


@dataclasses.dataclass(frozen=True)
class NodeClass:
    """A homogeneous slice of a heterogeneous node pool.

    ``base_cpu_frac`` / ``requested_frac`` are uniform ranges as fractions
    of this class's capacity; ``idle_watts`` / ``peak_watts`` parameterize
    the energy model; ``mtbf_s`` / ``mttr_s`` the mid-episode failures
    (``inf`` = the node never fails)."""

    name: str
    count: int
    cpu_capacity: float               # millicores
    mem_capacity: float               # MiB
    max_pods: int = 110
    unhealthy_prob: float = 0.0
    base_cpu_frac: tuple = (0.02, 0.2)
    requested_frac: tuple = (0.05, 0.5)
    image_cached_prob: float = 0.0
    idle_watts: float = 120.0
    peak_watts: float = 350.0
    mtbf_s: float = float("inf")
    mttr_s: float = 60.0


@dataclasses.dataclass(frozen=True)
class PodType:
    """One entry of the workload catalog (a mixture component of the
    stream); lifetimes are lognormal with ``lifetime_mean_s`` and
    ``lifetime_cv`` (``inf`` = the pod never completes)."""

    name: str
    weight: float
    cpu_request: float
    cpu_demand: float
    mem_request: float
    mem_demand: float
    lifetime_mean_s: float = float("inf")
    lifetime_cv: float = 0.0


@dataclasses.dataclass(frozen=True)
class ArrivalConfig:
    """Pod arrival process: ``burst`` (a fixed gap), ``poisson``
    (exponential gaps at ``rate_per_s``) or ``diurnal`` (a Poisson stream
    whose rate a sine of ``period_s`` and relative amplitude ``depth``
    modulates)."""

    kind: str = "burst"
    rate_per_s: float = 0.5
    period_s: float = 1200.0
    depth: float = 0.8


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Declarative scenario: node pool + pod catalog + arrival process."""

    name: str
    node_classes: tuple               # tuple[NodeClass, ...]
    pod_types: tuple                  # tuple[PodType, ...]
    arrival: ArrivalConfig = ArrivalConfig()
    n_pods: int = 50                  # default arrivals per episode
    settle_steps: Optional[int] = None  # post-arrival drain override

    @property
    def n_nodes(self) -> int:
        return sum(c.count for c in self.node_classes)


class EpisodeResult(NamedTuple):
    """``env.run_episode``'s result, field for field the reference's."""

    state: ClusterState               # final cluster state after settle
    placements: torch.Tensor          # (..., N) final pods per node
    metric: torch.Tensor              # dt-weighted cluster-average CPU%
    dropped: torch.Tensor             # int32, arrivals with no feasible node
    stats: EpisodeStats


class PodTable(NamedTuple):
    """Pre-sampled arrival stream (see ``env.sample_pod_table``)."""

    specs: PodSpec                  # each field (..., n_pods) f32
    dt_s: torch.Tensor              # (..., n_pods) f32 gap after each bind
    type_idx: torch.Tensor          # (..., n_pods) int32
    lifetime_s: torch.Tensor        # (..., n_pods) f32, inf = runs forever


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Cluster simulation constants; field for field ``repro.core.types``."""

    n_nodes: int = 4
    cpu_capacity: float = 4000.0
    mem_capacity: float = 16384.0
    max_pods: int = 110
    pod_cpu_request: float = 140.0
    pod_cpu_demand: float = 20.0
    pod_mem_request: float = 128.0
    pod_mem_demand: float = 100.0
    node_active_overhead: float = 500.0
    image_pull_cost: float = 4200.0
    warm_start_cost: float = 40.0
    startup_decay: float = 0.88
    pull_concurrency_coeff: float = 0.7
    contention_knee: float = 0.68
    contention_coeff: float = 120.0
    crowd_knee: int = 26
    crowd_coeff: float = 8.0
    schedule_dt_s: float = 2.0
    settle_steps: int = 20
    idle_watts: float = 120.0
    peak_watts: float = 350.0
    consolidate_every_s: float = 0.0
    base_cpu_profile: tuple = (720.0, 200.0, 120.0, 70.0)
    base_cpu_jitter: float = 40.0
    requested_frac_profile: tuple = (0.05, 0.12, 0.45, 0.80)
    requested_frac_jitter: float = 0.03
    init_uptime_range_h: tuple = (1.0, 200.0)
    unhealthy_prob: float = 0.0
    randomize_workload: bool = False
    randomize_max_pods: int = 26
    randomize_empty_prob: float = 0.45
    randomize_cached_prob: float = 0.3
    chaos_requeue_cap: int = 32
    chaos_cycles: int = 4
    scenario: Optional[ScenarioConfig] = None


def training_cluster() -> EnvConfig:
    """Domain-randomized variant of the paper cluster for policy training."""
    return dataclasses.replace(paper_cluster(), randomize_workload=True)


def paper_cluster() -> EnvConfig:
    """The paper's experimental cluster: 4 slave nodes, 50-pod batches."""
    return EnvConfig()


def fleet_cluster(n_nodes: int = 1024) -> EnvConfig:
    """A fleet-scale cluster for the 1000+-node scheduling benchmarks."""
    return dataclasses.replace(paper_cluster(), n_nodes=n_nodes, max_pods=110)


def scenario_env(scn: ScenarioConfig, randomize: bool = False,
                 **overrides) -> EnvConfig:
    """EnvConfig for a scenario: ``n_nodes`` tracks the node pool; capacity
    and pod fields become per class / per arrival at reset and episode
    time."""
    if scn.settle_steps is not None:
        overrides.setdefault("settle_steps", scn.settle_steps)
    return dataclasses.replace(paper_cluster(), n_nodes=scn.n_nodes,
                               scenario=scn, randomize_workload=randomize,
                               **overrides)
