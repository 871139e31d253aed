"""Scenario subsystem (port of ``repro.scenarios``): declarative
heterogeneous workloads for the scheduler.

A scenario = node pool (classes of machines) x pod catalog (workload
mixture) x arrival process.  ``registry`` holds the named scenarios,
``catalog`` the building blocks, ``engine`` turns a scenario and a policy
into episode metrics, ``arrivals`` turns pod tables into daemon request
traces.
"""
from repro_torch.scenarios.arrivals import ArrivalTrace, arrival_trace, trace_from_table
from repro_torch.scenarios.catalog import NODE_CLASSES, POD_TYPES
from repro_torch.scenarios.engine import (batch_episode, evaluate_scenario,
                                          scenario_episode)
from repro_torch.scenarios.registry import (SCENARIOS, SCORING_ONLY,
                                            get_scenario, make_env,
                                            scenario_names, training_mixture)

__all__ = [
    "NODE_CLASSES",
    "POD_TYPES",
    "SCENARIOS",
    "SCORING_ONLY",
    "ArrivalTrace",
    "arrival_trace",
    "trace_from_table",
    "batch_episode",
    "evaluate_scenario",
    "get_scenario",
    "make_env",
    "scenario_episode",
    "scenario_names",
    "training_mixture",
]
