"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8) d_ff=24576,
vocab=65536, MoE 16 experts top-2, Mamba:attention 7:1 interleave
(one attention layer per period of 8, MoE every other layer).

[arXiv:2403.19887; hf]
"""
from repro_torch.configs.base import ModelConfig, register, smoke_reduce


def full() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        head_dim=128,
        moe_num_experts=16,
        moe_top_k=2,
        moe_d_ff=24576,
        moe_every=2,
        attn_period=8,
        attn_offset=4,       # attention sits mid-period (jamba places it at layer 4 of 8)
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
    )


def smoke() -> ModelConfig:
    return smoke_reduce(full(), num_kv_heads=2)


register("jamba-1.5-large-398b", full, smoke)
