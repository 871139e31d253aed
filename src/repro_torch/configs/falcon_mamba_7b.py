"""falcon-mamba-7b [ssm] — 64L d_model=4096 attention-free, vocab=65024,
ssm_state=16, mamba-1 blocks (expand=2 -> d_inner=8192, conv=4, dt_rank=256).

[arXiv:2410.05355; unverified]
"""
from repro_torch.configs.base import ModelConfig, register, smoke_reduce


def full() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        num_layers=64,
        d_model=4096,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=65024,
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return smoke_reduce(full(), num_heads=0, num_kv_heads=0, d_ff=0)


register("falcon-mamba-7b", full, smoke)
