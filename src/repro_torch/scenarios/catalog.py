"""Reusable scenario building blocks: node classes and pod types (the
port's own copy of ``repro.scenarios.catalog``, value for value).

Numbers are in the environment's native units (millicores / MiB) and sized
against the paper's 4-vCPU slaves so the homogeneous paper cluster is just
one more entry in the catalog.
"""
from __future__ import annotations

from repro_torch.core.types import NodeClass, PodType

# ---------------------------------------------------------------------------
# node classes
# ---------------------------------------------------------------------------

PAPER_SLAVE = NodeClass(
    name="paper-slave", count=4, cpu_capacity=4000.0, mem_capacity=16384.0,
    base_cpu_frac=(0.02, 0.2), requested_frac=(0.05, 0.8),
)

BIG_CPU = NodeClass(
    name="big-cpu", count=2, cpu_capacity=16000.0, mem_capacity=65536.0,
    max_pods=250, base_cpu_frac=(0.02, 0.12), requested_frac=(0.05, 0.4),
)

SMALL_EDGE = NodeClass(
    name="small-edge", count=6, cpu_capacity=2000.0, mem_capacity=4096.0,
    max_pods=30, base_cpu_frac=(0.05, 0.3), requested_frac=(0.1, 0.6),
)

MEM_HEAVY = NodeClass(
    name="mem-heavy", count=4, cpu_capacity=8000.0, mem_capacity=131072.0,
    max_pods=150, base_cpu_frac=(0.02, 0.15), requested_frac=(0.05, 0.45),
)

SPOT = NodeClass(
    name="spot", count=6, cpu_capacity=4000.0, mem_capacity=16384.0,
    unhealthy_prob=0.25, base_cpu_frac=(0.01, 0.1), requested_frac=(0.0, 0.3),
)

WARM_POOL = NodeClass(
    name="warm-pool", count=4, cpu_capacity=4000.0, mem_capacity=16384.0,
    image_cached_prob=1.0, base_cpu_frac=(0.02, 0.2), requested_frac=(0.05, 0.5),
)

# preemptible capacity that FAILS MID-EPISODE (finite MTBF): on average one
# outage every ~5 minutes of episode time, back in ~1 minute.  Pods on a dead
# node are evicted and re-enter the arrival stream — see env.run_episode.
PREEMPTIBLE = NodeClass(
    name="preemptible", count=6, cpu_capacity=4000.0, mem_capacity=16384.0,
    mtbf_s=300.0, mttr_s=60.0,
    base_cpu_frac=(0.01, 0.1), requested_frac=(0.0, 0.3),
)

# spot capacity that both starts flaky (unhealthy_prob) AND keeps flapping
# mid-episode — the harshest node class in the catalog.
SPOT_CHAOS = NodeClass(
    name="spot-chaos", count=6, cpu_capacity=4000.0, mem_capacity=16384.0,
    unhealthy_prob=0.15, mtbf_s=180.0, mttr_s=90.0,
    base_cpu_frac=(0.01, 0.1), requested_frac=(0.0, 0.3),
)

NODE_CLASSES = {
    c.name: c
    for c in (PAPER_SLAVE, BIG_CPU, SMALL_EDGE, MEM_HEAVY, SPOT, WARM_POOL,
              PREEMPTIBLE, SPOT_CHAOS)
}

# ---------------------------------------------------------------------------
# pod types
# ---------------------------------------------------------------------------

# the paper's compute-intensive no-op burner (requests >> burns)
NOOP_PAPER = PodType(
    name="noop-paper", weight=1.0,
    cpu_request=140.0, cpu_demand=20.0, mem_request=128.0, mem_demand=100.0,
)

# training replica: big request, burns close to it, memory-hungry
TRAIN_HEAVY = PodType(
    name="train-heavy", weight=1.0,
    cpu_request=900.0, cpu_demand=780.0, mem_request=2048.0, mem_demand=1800.0,
)

# serving replica: small request, mostly idle between requests
SERVE_LIGHT = PodType(
    name="serve-light", weight=1.0,
    cpu_request=120.0, cpu_demand=60.0, mem_request=256.0, mem_demand=180.0,
)

# batch job: burns MORE than it requests (the classic noisy neighbour)
BATCH_BURST = PodType(
    name="batch-burst", weight=1.0,
    cpu_request=400.0, cpu_demand=520.0, mem_request=512.0, mem_demand=420.0,
)

# in-memory cache shard: negligible CPU, giant working set
MEM_CACHE = PodType(
    name="mem-cache", weight=1.0,
    cpu_request=100.0, cpu_demand=40.0, mem_request=4096.0, mem_demand=3900.0,
)

# ---------------------------------------------------------------------------
# finite-lifetime pod types (churn / consolidation scenarios).  Durations are
# lognormal (mean, cv) — see env._sample_lifetimes; the catalog entries above
# keep the default lifetime of inf (they never finish), which is exactly the
# paper's static-burst experiment.
# ---------------------------------------------------------------------------

# short CI-style job: arrives in waves, burns hard, gone in under a minute
SHORT_JOB = PodType(
    name="short-job", weight=1.0,
    cpu_request=300.0, cpu_demand=350.0, mem_request=384.0, mem_demand=300.0,
    lifetime_mean_s=45.0, lifetime_cv=0.4,
)

# long-running training replica: outlives the episode's arrival wave but
# does finish — draining its node is worth planning for
LONG_TRAIN = PodType(
    name="long-train", weight=1.0,
    cpu_request=900.0, cpu_demand=780.0, mem_request=2048.0, mem_demand=1800.0,
    lifetime_mean_s=600.0, lifetime_cv=0.25,
)

# autoscaled serving replica: scaled up for a traffic wave, reaped after it
SERVE_CHURN = PodType(
    name="serve-churn", weight=1.0,
    cpu_request=120.0, cpu_demand=60.0, mem_request=256.0, mem_demand=180.0,
    lifetime_mean_s=90.0, lifetime_cv=0.6,
)

# medium-lived batch shard with a heavy straggler tail (cv ~ 1): a few
# stragglers pin otherwise-idle nodes — the consolidation pass's bread and
# butter
BATCH_STRAGGLER = PodType(
    name="batch-straggler", weight=1.0,
    cpu_request=250.0, cpu_demand=220.0, mem_request=512.0, mem_demand=400.0,
    lifetime_mean_s=150.0, lifetime_cv=1.0,
)

POD_TYPES = {
    p.name: p
    for p in (NOOP_PAPER, TRAIN_HEAVY, SERVE_LIGHT, BATCH_BURST, MEM_CACHE,
              SHORT_JOB, LONG_TRAIN, SERVE_CHURN, BATCH_STRAGGLER)
}


def weighted(pod: PodType, weight: float) -> PodType:
    """Catalog pod type with a scenario-specific mixture weight."""
    import dataclasses

    return dataclasses.replace(pod, weight=weight)


def with_lifetime(pod: PodType, mean_s: float, cv: float = 0.3) -> PodType:
    """Catalog pod type with a scenario-specific duration distribution."""
    import dataclasses

    return dataclasses.replace(pod, lifetime_mean_s=mean_s, lifetime_cv=cv)
