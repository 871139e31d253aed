"""Named scenario registry (the port's own copy of
``repro.scenarios.registry``, entry for entry).

Every entry is a fully declarative ``ScenarioConfig``, convertible to an
``EnvConfig`` with ``make_env(name)`` and run on the card by
``scripts/scenario_tables.py``.  The chaos scenarios (finite MTBF) sample
a failure trace per episode: their nodes fail mid-episode and the pods
there are evicted and rescheduled (``core.env.run_episode``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.core.types import (ArrivalConfig, EnvConfig, ScenarioConfig,
                                    scenario_env)
from repro_torch.scenarios import catalog as cat

_c = dataclasses.replace  # shrink a node class / retune a pod type in place


SCENARIOS: Dict[str, ScenarioConfig] = {}


def _register(scn: ScenarioConfig) -> ScenarioConfig:
    SCENARIOS[scn.name] = scn
    return scn


# 1. the paper's experiment, expressed as a scenario: homogeneous 4-slave
#    pool, 50 identical no-op pods arriving as a fixed burst.
PAPER_BURST = _register(ScenarioConfig(
    name="paper-burst",
    node_classes=(cat.PAPER_SLAVE,),
    pod_types=(cat.NOOP_PAPER,),
    arrival=ArrivalConfig(kind="burst"),
    n_pods=50,
))

# 2. big/small CPU split: two 16-core crunchers next to six 2-core edge
#    boxes; a mixed stream where train-heavy pods only really fit the big
#    nodes while serve-light pods fit anywhere.
HETERO_BIGSMALL = _register(ScenarioConfig(
    name="hetero-bigsmall",
    node_classes=(cat.BIG_CPU, cat.SMALL_EDGE),
    pod_types=(cat.weighted(cat.TRAIN_HEAVY, 0.25), cat.weighted(cat.SERVE_LIGHT, 0.75)),
    arrival=ArrivalConfig(kind="burst"),
    n_pods=60,
))

# 3. train/serve mixture on a mixed pool under a Poisson stream (the
#    AGMARL-DKS-style heterogeneous evaluation).
TRAIN_SERVE_MIX = _register(ScenarioConfig(
    name="train-serve-mix",
    node_classes=(cat.BIG_CPU, cat.PAPER_SLAVE),
    pod_types=(cat.weighted(cat.TRAIN_HEAVY, 0.3), cat.weighted(cat.SERVE_LIGHT, 0.7)),
    arrival=ArrivalConfig(kind="poisson", rate_per_s=0.5),
    n_pods=60,
))

# 4. memory pressure: cache shards whose working sets dwarf their CPU needs,
#    on a pool where only half the nodes are memory-heavy.
MEMORY_PRESSURE = _register(ScenarioConfig(
    name="memory-pressure",
    node_classes=(cat.MEM_HEAVY, cat.PAPER_SLAVE),
    pod_types=(cat.weighted(cat.MEM_CACHE, 0.5), cat.weighted(cat.SERVE_LIGHT, 0.5)),
    arrival=ArrivalConfig(kind="poisson", rate_per_s=0.4),
    n_pods=50,
))

# 5. flaky spot pool: a quarter of the spot nodes come up NotReady, so the
#    filtering phase actually bites; batch pods burn above their requests.
SPOT_FLAKY = _register(ScenarioConfig(
    name="spot-flaky",
    node_classes=(cat.SPOT, _c(cat.PAPER_SLAVE, count=2)),
    pod_types=(cat.weighted(cat.BATCH_BURST, 0.6), cat.weighted(cat.NOOP_PAPER, 0.4)),
    arrival=ArrivalConfig(kind="poisson", rate_per_s=0.6),
    n_pods=50,
))

# 6. diurnal serving wave: warm image pool, light pods, arrival rate swinging
#    sinusoidally over a 20-minute "day".
DIURNAL_SERVE = _register(ScenarioConfig(
    name="diurnal-serve",
    node_classes=(cat.WARM_POOL, cat.PAPER_SLAVE),
    pod_types=(cat.SERVE_LIGHT,),
    arrival=ArrivalConfig(kind="diurnal", rate_per_s=0.5, period_s=1200.0, depth=0.8),
    n_pods=80,
))

# 7. batch storm: a dense Poisson burst of over-burning batch jobs onto big
#    nodes plus unreliable spot capacity.
BATCH_STORM = _register(ScenarioConfig(
    name="batch-storm",
    node_classes=(_c(cat.BIG_CPU, count=4), _c(cat.SPOT, count=4)),
    pod_types=(cat.BATCH_BURST,),
    arrival=ArrivalConfig(kind="poisson", rate_per_s=1.5),
    n_pods=80,
))

# --- churn scenarios (finite pod lifetimes: the consolidation/energy story
# is only measurable when pods finish and release their nodes) --------------

# 9. short-job burst: a CI-style wave of sub-minute jobs on a widened paper
#    pool.  The arrival wave saturates the pool, then the whole wave dies —
#    nodes_active must fall back toward zero through the settle window.
SHORT_JOB_BURST = _register(ScenarioConfig(
    name="short-job-burst",
    node_classes=(_c(cat.PAPER_SLAVE, count=8),),
    pod_types=(cat.SHORT_JOB,),
    arrival=ArrivalConfig(kind="burst"),
    n_pods=60,
    settle_steps=60,
))

# 10. long-running training mix: training replicas that outlive the arrival
#     wave next to quickly-reaped serving churn, on a big/small pool.
LONGRUN_TRAIN_MIX = _register(ScenarioConfig(
    name="longrun-train-mix",
    node_classes=(cat.BIG_CPU, cat.PAPER_SLAVE),
    pod_types=(cat.weighted(cat.LONG_TRAIN, 0.3), cat.weighted(cat.SERVE_CHURN, 0.7)),
    arrival=ArrivalConfig(kind="poisson", rate_per_s=0.5),
    n_pods=60,
    settle_steps=60,
))

# 11. diurnal churn: autoscaled serving replicas arriving on a daily wave and
#     being reaped ~90s later — load rises and falls, nodes empty in the
#     trough.
DIURNAL_CHURN = _register(ScenarioConfig(
    name="diurnal-churn",
    node_classes=(cat.WARM_POOL, cat.PAPER_SLAVE),
    pod_types=(cat.SERVE_CHURN,),
    arrival=ArrivalConfig(kind="diurnal", rate_per_s=0.8, period_s=600.0, depth=0.9),
    n_pods=100,
    settle_steps=45,
))

# 12. consolidation stress: medium-lived batch shards with a heavy straggler
#     tail (cv ~ 1) on a wide pool — a few stragglers pin otherwise-idle
#     nodes, exactly what the in-episode SDQN-n consolidation pass drains.
CONSOLIDATION_STRESS = _register(ScenarioConfig(
    name="consolidation-stress",
    node_classes=(_c(cat.PAPER_SLAVE, count=10),),
    pod_types=(cat.weighted(cat.BATCH_STRAGGLER, 0.7), cat.weighted(cat.SHORT_JOB, 0.3)),
    arrival=ArrivalConfig(kind="poisson", rate_per_s=0.6),
    n_pods=80,
    settle_steps=75,
))

# --- chaos scenarios (finite MTBF: nodes fail MID-EPISODE, their pods are
# evicted and re-enter the arrival stream — see env.sample_failure_trace) ---

# 13. preemptible churn: autoscaled serving replicas on a pool where most
#     capacity is preemptible — placements must survive evictions, and the
#     reschedule ring is exercised continuously.
PREEMPTIBLE_FLAKY = _register(ScenarioConfig(
    name="preemptible-flaky",
    node_classes=(cat.PREEMPTIBLE, _c(cat.PAPER_SLAVE, count=2)),
    pod_types=(cat.SERVE_CHURN,),
    arrival=ArrivalConfig(kind="poisson", rate_per_s=0.6),
    n_pods=60,
    settle_steps=45,
))

# 14. batch jobs on chaos-grade spot: over-burning batch shards on nodes
#     that both start NotReady and keep flapping — eviction storms hit
#     mid-wave, so where the scheduler parks the survivors matters.
BATCH_FLAKY = _register(ScenarioConfig(
    name="batch-flaky",
    node_classes=(cat.SPOT_CHAOS, _c(cat.BIG_CPU, count=1)),
    pod_types=(cat.weighted(cat.BATCH_STRAGGLER, 0.6), cat.weighted(cat.SHORT_JOB, 0.4)),
    arrival=ArrivalConfig(kind="poisson", rate_per_s=0.7),
    n_pods=60,
    settle_steps=60,
))

# 15. mixed train/serve under light chaos: long training replicas (the
#     expensive thing to lose) next to serving churn, with a preemptible
#     slice of the pool — the policy should learn to keep the long jobs off
#     the flaky capacity.
TRAIN_FLAKY = _register(ScenarioConfig(
    name="train-flaky",
    node_classes=(cat.BIG_CPU, _c(cat.PREEMPTIBLE, count=4)),
    pod_types=(cat.weighted(cat.LONG_TRAIN, 0.3), cat.weighted(cat.SERVE_CHURN, 0.7)),
    arrival=ArrivalConfig(kind="poisson", rate_per_s=0.5),
    n_pods=60,
    settle_steps=60,
))

# 8. fleet-scale heterogeneous pool for the scaling benchmarks.
FLEET_HETERO = _register(ScenarioConfig(
    name="fleet-hetero",
    node_classes=(
        _c(cat.BIG_CPU, count=256),
        _c(cat.PAPER_SLAVE, count=512),
        _c(cat.SMALL_EDGE, count=256),
    ),
    pod_types=(
        cat.weighted(cat.TRAIN_HEAVY, 0.2),
        cat.weighted(cat.SERVE_LIGHT, 0.6),
        cat.weighted(cat.BATCH_BURST, 0.2),
    ),
    arrival=ArrivalConfig(kind="poisson", rate_per_s=5.0),
    n_pods=200,
))

# --- cluster-of-clusters family (16–18): N identical 4096-node regional
# clusters federated into one scheduling domain, 4k → 128k nodes.  These
# exist to exercise the two-stage hierarchical sharded scoring path
# (``sched.shard``) — an episode rollout at 128k nodes is not the point, so
# the pod stream is small and the scoring benchmarks drive them
# per-decision.  They are registered like any
# scenario (make_env works) but excluded from the episode-sweep benches via
# SCORING_ONLY. -------------------------------------------------------------

_COC_CLUSTER = (          # one 4096-node regional cluster
    _c(cat.BIG_CPU, count=512),
    _c(cat.PAPER_SLAVE, count=2048),
    _c(cat.SMALL_EDGE, count=1536),
)


def _cluster_of_clusters(n_clusters: int, label: str) -> ScenarioConfig:
    return ScenarioConfig(
        name=f"cluster-of-clusters-{label}",
        node_classes=tuple(
            _c(nc, name=f"coc{i}-{nc.name}")
            for i in range(n_clusters) for nc in _COC_CLUSTER),
        pod_types=(
            cat.weighted(cat.TRAIN_HEAVY, 0.2),
            cat.weighted(cat.SERVE_LIGHT, 0.6),
            cat.weighted(cat.BATCH_BURST, 0.2),
        ),
        arrival=ArrivalConfig(kind="poisson", rate_per_s=5.0),
        n_pods=32,
    )


COC_4K = _register(_cluster_of_clusters(1, "4k"))
COC_16K = _register(_cluster_of_clusters(4, "16k"))
COC_64K = _register(_cluster_of_clusters(16, "64k"))
COC_128K = _register(_cluster_of_clusters(32, "128k"))

# scenarios meant for per-decision scoring benches, not episode sweeps:
# the scenario sweeps skip them (episode physics at 10^5 nodes
# adds nothing the 1k fleet-hetero rollout doesn't already cover)
SCORING_ONLY = frozenset(
    n for n in SCENARIOS if n.startswith("cluster-of-clusters-"))


def scenario_names() -> List[str]:
    return sorted(SCENARIOS)


def get_scenario(name: str) -> ScenarioConfig:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; available: {', '.join(scenario_names())}"
        ) from None


def make_env(name: str, randomize: bool = False, **overrides) -> EnvConfig:
    """EnvConfig for a registry scenario (randomize=True for training resets)."""
    return scenario_env(get_scenario(name), randomize=randomize, **overrides)


def training_mixture(names=None) -> List[EnvConfig]:
    """The scenario mixture one Q-net trains across (domain-randomized resets).

    Defaults to ``presets.SCENARIO_MIX_NAMES`` so the mixture is defined in
    exactly one place (lazy import: presets pulls in the training stack).
    """
    if names is None:
        from repro_torch.core.presets import SCENARIO_MIX_NAMES
        names = SCENARIO_MIX_NAMES
    return [make_env(n, randomize=True) for n in names]
