"""Plain PyTorch oracles for the kernels (the correctness ground truth)."""
from __future__ import annotations

import torch


def sdqn_score_ref(feats, w1, b1, w2, b2):
    """Unfused Table-4 Q-net on a built (..., 6) feature matrix."""
    h = torch.clamp(feats.to(torch.float32) @ w1 + b1, min=0.0)
    return (h @ w2 + b2)[..., 0]
