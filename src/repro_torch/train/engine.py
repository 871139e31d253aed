"""Multi-candidate training engine (port of ``repro.train.engine``).

The paper's "Algorithm Selection and Scheduler Development" step trains
several candidate SDQN/SDQN-n policies and keeps the best on held-out
validation bursts.  Where the reference vmaps the whole training program
over the seed ladder, the port runs the seeds as the leading batch
dimension of one loop (``train_rl.train_carry``): one episode loop for all
candidates, each with its own draws, params, Adam moments and ring.
Validation runs every (seed, trial) episode as one batch
(``eval.engine.make_multi_param_evaluator``) and the winner is a
NaN-guarded argmin.  No ``mesh=``: the port targets one card.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import policy as policy_mod, schedulers, train_rl
from repro_torch.core.draws import TorchDraws
from repro_torch.core.types import EnvConfig
from repro_torch.device import resolve_device
from repro_torch.eval import engine as eval_engine
from repro_torch.optim import tree_map

# the reference validates on PRNGKey(5000 + t); standalone runs draw their
# validation trials from a generator seeded alike
VALIDATION_SEED = 5000


def train_seeds(draws, env_cfg: EnvConfig, rl: train_rl.RLConfig,
                n_seeds: int, carry=None, device=None) -> Tuple[dict, dict]:
    """Train ``n_seeds`` candidate policies as one batch.  ``draws`` has
    batch ``(n_seeds, rl.n_envs)``.  Returns (stacked qparams with a
    leading seed dim, metrics dict of (S, episodes) tensors).  The batch
    runs unsharded on one card, as the reference's does under a one-device
    mesh; ``launch.mesh.plan_seed_env_layout`` plans its split over
    several devices."""
    carry, metrics = train_rl.train_carry(draws, env_cfg, rl, n_seeds,
                                          carry=carry, device=device)
    return carry.params, metrics


class Selection(NamedTuple):
    """``select_best``'s result; unpacks as ``(params, metric, diverged)``."""

    params: dict
    metric: torch.Tensor    # () guarded validation metric of the winner
    diverged: torch.Tensor  # () bool: EVERY candidate was NaN — params are
                            # the seed-0 fallback, not a real selection


def select_best(stacked_params: dict, metrics: torch.Tensor) -> Selection:
    """NaN-guarded candidate selection: NaN metrics are demoted to +inf
    before the argmin (first minimum), so if every seed is NaN seed 0
    wins and ``diverged`` says so."""
    nan = torch.isnan(metrics)
    guarded = torch.where(nan, torch.full_like(metrics, torch.inf), metrics)
    best = torch.argmin(guarded)
    return Selection(tree_map(lambda x: x[best], stacked_params),
                     guarded[best], torch.all(nan))


def train_and_select(draws, train_cfg: EnvConfig, eval_cfg: EnvConfig,
                     rl: train_rl.RLConfig, n_seeds: int = 4,
                     val_trials: int = 12, val_pods: Optional[int] = 50,
                     val_draws=None, device=None):
    """Seed-parallel training, batched validation and NaN-guarded
    selection.  ``draws`` has batch ``(n_seeds, rl.n_envs)``;
    ``val_draws`` (batch ``(val_trials,)``) defaults to ``TorchDraws`` from
    a generator seeded ``VALIDATION_SEED`` on the device.  Returns
    ``(best_params, float(best_val_metric))``; all-NaN warns and returns
    seed 0's params."""
    device = resolve_device(device)
    stacked, _ = train_seeds(draws, train_cfg, rl, n_seeds, device=device)
    spec = policy_mod.get(rl.policy)
    evaluator = eval_engine.make_multi_param_evaluator(
        eval_cfg, lambda p: schedulers.make_policy_selector(spec, p, eval_cfg),
        val_pods, device=device)
    if val_draws is None:
        val_draws = TorchDraws(
            torch.Generator(device=device).manual_seed(VALIDATION_SEED),
            (val_trials,))
    metrics = torch.mean(evaluator(stacked, val_draws).metric, dim=1)  # (S,)
    best_params, best_metric, diverged = select_best(stacked, metrics)
    if bool(diverged):
        warnings.warn(
            f"train_and_select: every candidate's validation metric was NaN "
            f"({n_seeds} seeds) — returning seed 0's params unselected; "
            f"treat them as diverged", RuntimeWarning, stacklevel=2)
    return best_params, float(best_metric)
