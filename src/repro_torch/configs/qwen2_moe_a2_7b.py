"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408/expert
vocab=151936, MoE 60 experts top-4 + 4 shared experts (shared width 4x1408=5632).

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from repro_torch.configs.base import ModelConfig, register, smoke_reduce


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,           # routed-expert FFN width
        vocab_size=151936,
        moe_num_experts=60,
        moe_top_k=4,
        moe_d_ff=1408,
        moe_shared_d_ff=5632,  # 4 shared experts fused into one wide MLP
        use_bias=True,          # qwen uses attention QKV biases
    )


def smoke() -> ModelConfig:
    return smoke_reduce(full())


register("qwen2-moe-a2.7b", full, smoke)
