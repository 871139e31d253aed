"""Optimizers (port of ``repro.optim``)."""
from repro_torch.optim.adam import (AdamConfig, adam_init, adam_update,
                                    global_norm, tree_leaves, tree_map)

__all__ = ["AdamConfig", "adam_init", "adam_update", "global_norm",
           "tree_leaves", "tree_map"]
