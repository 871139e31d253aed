"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.

GQA, no biases, tied embeddings (Cohere uses tied input/output embeddings).
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""
from repro_torch.configs.base import ModelConfig, register, smoke_reduce


def full() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b",
        family="dense",
        num_layers=64,
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        d_ff=33792,
        vocab_size=256000,
        head_dim=128,
        use_bias=False,
        tie_embeddings=True,
        norm="layernorm",
    )


def smoke() -> ModelConfig:
    return smoke_reduce(full(), num_kv_heads=2)


register("command-r-plus-104b", full, smoke)
