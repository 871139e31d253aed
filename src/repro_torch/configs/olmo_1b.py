"""olmo-1b [dense] — 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304.

Non-parametric LayerNorm, SwiGLU, no biases, tied embeddings.
[arXiv:2402.00838; hf]
"""
from repro_torch.configs.base import ModelConfig, register, smoke_reduce


def full() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        family="dense",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=8192,
        vocab_size=50304,
        norm="layernorm_np",
        act="silu",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return smoke_reduce(full())


register("olmo-1b", full, smoke)
