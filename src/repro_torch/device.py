"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; the port never falls back to the CPU
    on its own.  Pass ``device="cpu"`` to run the plain versions there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass device='cpu' "
                               "to run on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)
