"""Run scenarios against scheduler policies and collect episode metrics
(port of ``repro.scenarios.engine``).

Trials run through the batched eval engine (``eval.engine``): every trial
of a (scenario, scheduler) cell is one batch dimension of one episode
loop.  Where the reference takes a PRNG key, these take a ``core.draws``
object whose batch is the trials.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.core import env as kenv
from repro_torch.core.types import EnvConfig
from repro_torch.device import resolve_device
from repro_torch.eval import engine as eval_engine


def default_n_pods(env_cfg: EnvConfig, n_pods: Optional[int] = None) -> int:
    """``n_pods``, else the scenario's arrivals, else the paper's 50."""
    return eval_engine._default_n_pods(env_cfg, n_pods)


def scenario_episode(env_cfg: EnvConfig, select: Callable,
                     n_pods: Optional[int] = None,
                     consolidate: Optional[Callable] = None,
                     device=None) -> Callable:
    """``(draws) -> EpisodeResult`` (state, distribution, metric, dropped,
    the ``EpisodeStats`` of time-resolved lifecycle metrics);
    ``consolidate`` threads the in-episode SDQN-n pass through."""
    n = default_n_pods(env_cfg, n_pods)
    device = resolve_device(device)
    return lambda draws: kenv.run_episode(draws, env_cfg, select, n,
                                          consolidate=consolidate,
                                          device=device)


def batch_episode(env_cfg: EnvConfig, select: Callable,
                  n_pods: Optional[int] = None,
                  consolidate: Optional[Callable] = None,
                  device=None) -> Callable:
    """``(draws) -> TrialResults``: the batched trial runner."""
    return eval_engine.make_batch_episode(env_cfg, select, n_pods,
                                          consolidate, device=device)


def evaluate_scenario(draws, env_cfg: EnvConfig, select: Callable,
                      n_pods: Optional[int] = None,
                      episode: Optional[Callable] = None,
                      device=None) -> Dict[str, float]:
    """The paper's metric (cluster-average CPU%) and the drop and
    lifecycle statistics over ``draws``' trials; ``episode`` is a prebuilt
    ``batch_episode``."""
    return eval_engine.evaluate(draws, env_cfg, select, n_pods=n_pods,
                                batch=episode, device=device)
