"""internvl2-76b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.

InternViT frontend is a STUB per the assignment: ``input_specs`` supplies
precomputed patch embeddings (256 vision tokens) spliced into the prefix of
the token stream; the backbone is the (Llama-3-70B-style) language model.
[arXiv:2404.16821; unverified]
"""
from repro_torch.configs.base import ModelConfig, register, smoke_reduce


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b",
        family="vlm",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        head_dim=128,
        num_vision_tokens=256,
        rope_theta=500000.0,
    )


def smoke() -> ModelConfig:
    return smoke_reduce(full(), num_kv_heads=2)


register("internvl2-76b", full, smoke)
