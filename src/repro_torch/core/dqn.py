"""The SDQN value network — paper Table 4 (PyTorch port, inference only).

Input: 6 state features.  Hidden: one fully-connected 6→32 layer, ReLU.
Output: 32→1 estimated Q-value, evaluated on *afterstates*.  Parameters are
a plain dict of tensors in the reference's layout: ``w1 (6, 32)``,
``b1 (32,)``, ``w2 (32, 1)``, ``b2 (1,)``.  Training (Adam, MSE) waits for
the learner slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import FEATURE_DIM
from repro_torch.device import resolve_device

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


def qvalues(params: dict, feats: torch.Tensor) -> torch.Tensor:
    """feats: (..., 6) normalized features -> Q: (...)."""
    h = torch.relu(feats @ params["w1"] + params["b1"])
    return (h @ params["w2"] + params["b2"])[..., 0]
