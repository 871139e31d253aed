"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752/expert
vocab=100352, MoE 16 experts top-4 (fine-grained).

[hf:databricks/dbrx-base; unverified]
"""
from repro_torch.configs.base import ModelConfig, register, smoke_reduce


def full() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family="moe",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=10752,
        vocab_size=100352,
        head_dim=128,
        moe_num_experts=16,
        moe_top_k=4,
        moe_d_ff=10752,
        norm="layernorm",
        rope_theta=500000.0,
    )


def smoke() -> ModelConfig:
    return smoke_reduce(full(), num_kv_heads=2)


register("dbrx-132b", full, smoke)
