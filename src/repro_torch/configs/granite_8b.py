"""granite-8b [dense] — 36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.

Llama-style code model. [arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import ModelConfig, register, smoke_reduce


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-8b",
        family="dense",
        num_layers=36,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=49152,
        head_dim=128,
    )


def smoke() -> ModelConfig:
    return smoke_reduce(full(), num_kv_heads=1)


register("granite-8b", full, smoke)
