"""Learning-rate schedules (port of ``repro.optim.schedule``): functions of
the int32 step tensor that ``adam_update`` passes, returning a float32
tensor on its device.

The arithmetic is the reference's, op for op in float32, so the rate
equals the reference's evaluated op by op (``jax.disable_jit``) on the
warmup branch and for ``constant_lr``.  Under ``jax.jit`` XLA rewrites a
division by a constant into a product by its reciprocal and takes its own
float32 cosine, so on the cosine branch the jitted reference's rate
differs from this one by a few ulps (PERF.md, deliberate differences).
"""
from __future__ import annotations

import math

import torch


def constant_lr(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def cosine_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    down to ``floor * peak_lr`` at ``total_steps``."""
    def schedule(step):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule
