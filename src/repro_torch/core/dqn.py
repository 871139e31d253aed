"""The SDQN value network — paper Table 4 (PyTorch port).

Input: 6 state features.  Hidden: one fully-connected 6→32 layer, ReLU.
Output: 32→1 estimated Q-value, evaluated on *afterstates*.  Loss: MSE
against target rewards (weighted: zero-weight rows never train).
Optimizer: Adam, lr = 0.001.  Parameters are a plain dict of tensors in
the reference's layout: ``w1 (6, 32)``, ``b1 (32,)``, ``w2 (32, 1)``,
``b2 (1,)``.  Every leaf may carry a leading seed dimension ``S``
(candidate policies trained side by side, ``train.engine.train_seeds``):
feature rows then lead with the same ``S``, and each seed's rows go
through its own weights in one batched product.  Gradients come from
``torch.autograd``.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.types import FEATURE_DIM
from repro_torch.device import resolve_device
from repro_torch.optim import (AdamConfig, adam_init, adam_update,
                               tree_leaves, tree_map)

HIDDEN = 32
N_FEATURES = FEATURE_DIM


def init_qnet(gen: torch.Generator, hidden: int = HIDDEN, device=None) -> dict:
    """He-scaled normal weights drawn from ``gen``, zero biases."""
    device = resolve_device(device)

    def normal(shape, scale):
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device)
        return (x * scale).to(device)

    return {
        "w1": normal((N_FEATURES, hidden), (2.0 / N_FEATURES) ** 0.5),
        "b1": torch.zeros((hidden,), dtype=torch.float32, device=device),
        "w2": normal((hidden, 1), (1.0 / hidden) ** 0.5),
        "b2": torch.zeros((1,), dtype=torch.float32, device=device),
    }


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w + b``.  With per-seed weights ``w (S, in, out)`` (``b (S,
    out)``) the rows ``x (S, ..., in)`` of seed s go through seed s's
    weights: one batched product for all seeds."""
    if w.dim() == 2:
        y = x @ w
        return y if b is None else y + b
    s = w.shape[0]
    y = torch.matmul(x.reshape(s, -1, x.shape[-1]), w)
    if b is not None:
        y = y + b[:, None, :]
    return y.reshape(x.shape[:-1] + w.shape[-1:])


def qvalues(params: dict, feats: torch.Tensor) -> torch.Tensor:
    """feats: (..., 6) normalized features -> Q: (...); with per-seed
    params, feats lead with the seed dimension."""
    h = torch.relu(linear(feats, params["w1"], params["b1"]))
    return linear(h, params["w2"], params["b2"])[..., 0]


def seeded(params) -> bool:
    """True when ``params`` carry a leading seed dimension: without one,
    every registered policy class's leaves are at most 2-D (weight
    matrices, biases, the mamba class's ``A_log``)."""
    return max(x.dim() for x in tree_leaves(params)) == 3


def weighted_mse(q: torch.Tensor, targets: torch.Tensor,
                 weights: Optional[torch.Tensor] = None,
                 per_seed: bool = False) -> torch.Tensor:
    """The reference's loss: mean squared error, or with ``weights`` the
    weighted sum over max(sum of weights, 1e-9).  ``per_seed`` reduces
    each leading row separately: an (S,) loss."""
    err = torch.square(q - targets)
    dims = tuple(range(1 if per_seed else 0, err.dim()))
    if weights is None:
        return torch.mean(err, dim=dims)
    return (torch.sum(err * weights, dim=dims)
            / torch.clamp(torch.sum(weights, dim=dims), min=1e-9))


def mse_loss(params: dict, feats: torch.Tensor, targets: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Table-4 MSE of ``qvalues``; an (S,) loss with per-seed params."""
    return weighted_mse(qvalues(params, feats), targets, weights,
                        per_seed=seeded(params))


ADAM = AdamConfig(lr=1e-3, master_dtype="")  # paper Table 4


def init_train_state(gen: torch.Generator, device=None) -> Tuple[dict, dict]:
    params = init_qnet(gen, device=device)
    return params, adam_init(params, ADAM)


def learner_step(loss_fn: Callable, params, opt_state: dict, feats, targets,
                 weights=None, per_seed: bool = False):
    """One forward + backprop + Adam update of ``loss_fn(params, feats,
    targets, weights)``.  With ``per_seed`` the loss is (S,); the step
    differentiates its sum, so each seed's gradients are its own loss's.
    Returns (params, opt_state, loss, stats) with detached tensors."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss = loss_fn(live, feats, targets, weights)
        grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
    # a parameter the loss does not reach (the attention class's query
    # and key weights on singleton sets) gets zeros, as under jax.grad
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    grads = tree_map(lambda _: next(it), params)
    params, opt_state, stats = adam_update(params, grads, opt_state, ADAM,
                                           seeds=per_seed)
    return params, opt_state, loss.detach(), stats


def train_step(params: dict, opt_state: dict, feats: torch.Tensor,
               targets: torch.Tensor, weights: Optional[torch.Tensor] = None):
    """One forward + MSE backprop + Adam update (paper Table 4 training
    loop): (params, opt_state, loss, stats)."""
    return learner_step(mse_loss, params, opt_state, feats, targets, weights,
                        per_seed=seeded(params))
