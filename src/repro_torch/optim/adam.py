"""AdamW on dicts of tensors (port of ``repro.optim.adam``).

Parameters, gradients and moments are trees of nested dicts (and lists)
keyed like the params.  Every leaf may carry a leading seed dimension ``S`` (candidate
policies trained side by side): ``adam_update(..., seeds=True)`` then
clips each seed by its own global norm, and a step counter of shape
``(S,)`` (the reference's, stacked over seeds) or ``()`` broadcasts over
the leaves.  The arithmetic follows the reference op for op in float32:
moments in ``moment_dtype``, updates through float32, master copies in
``master_dtype`` ("" updates the params in their own dtype).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 1e-3          # paper Table 4: Adam, lr=0.001
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0   # 0 => off
    moment_dtype: str = "float32"
    master_dtype: str = "float32"  # "" => update params in their own dtype


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists (``rest`` keyed
    alike)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in key order of insertion (list order), depth first."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def adam_init(params: Any, cfg: AdamConfig) -> dict:
    """Zero moments (and float master copies) for ``params``; the step
    counter is a () int32 tensor on the params' device."""
    mdt = _dtype(cfg.moment_dtype)
    device = tree_leaves(params)[0].device
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
    }
    if cfg.master_dtype:
        state["master"] = tree_map(
            lambda p: p.to(_dtype(cfg.master_dtype)).clone(), params)
    return state


def global_norm(tree: Any, seeds: bool = False) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in float32: one () norm,
    or with ``seeds`` one per leading seed row, (S,)."""
    def sq(x):
        x = x.to(torch.float32)
        if seeds:
            return torch.sum(torch.square(x).reshape(x.shape[0], -1), dim=1)
        return torch.sum(torch.square(x))

    return torch.sqrt(torch.sum(torch.stack([sq(x) for x in
                                             tree_leaves(tree)]), dim=0))


def _rows(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-seed (S,) value (or a ()) shaped to broadcast over ``like``."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def adam_update(
    params: Any,
    grads: Any,
    state: dict,
    cfg: AdamConfig,
    lr_schedule: Optional[Callable[[torch.Tensor], Any]] = None,
    seeds: bool = False,
) -> Tuple[Any, dict, dict]:
    """Returns (new_params, new_state, stats); nothing is written in place."""
    step = state["step"] + 1
    lr = cfg.lr if lr_schedule is None else lr_schedule(step)
    gnorm = global_norm(grads, seeds)
    if cfg.grad_clip_norm > 0:
        scale = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
        grads = tree_map(lambda g: g * _rows(scale, g), grads)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)
    mdt = _dtype(cfg.moment_dtype)

    def upd_moment(m, g, beta):
        return (beta * m.to(torch.float32)
                + (1 - beta) * g.to(torch.float32)).to(mdt)

    new_m = tree_map(lambda m, g: upd_moment(m, g, b1), state["m"], grads)
    new_v = tree_map(lambda v, g: upd_moment(v, g * g, b2), state["v"], grads)

    masters = state.get("master", params)

    def upd_param(p, m, v):
        mhat = m.to(torch.float32) / _rows(bc1, p)
        vhat = v.to(torch.float32) / _rows(bc2, p)
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        step_lr = lr if not torch.is_tensor(lr) else _rows(lr, p)
        return (p.to(torch.float32) - step_lr * delta).to(p.dtype)

    new_masters = tree_map(upd_param, masters, new_m, new_v)
    new_state = {"step": step, "m": new_m, "v": new_v}
    if "master" in state:
        new_state["master"] = new_masters
        new_params = tree_map(lambda mp, p: mp.to(p.dtype), new_masters,
                              params)
    else:
        new_params = new_masters
    stats = {"grad_norm": gnorm, "lr": lr}   # lr: a float or the schedule's
    return new_params, new_state, stats
