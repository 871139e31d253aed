"""Checkpoints (port of ``repro.checkpoint``), in the reference's format."""
from repro_torch.checkpoint.ckpt import (  # noqa: F401
    CheckpointManager,
    content_digest,
    latest_step,
    read_extra,
    restore,
    save,
)
