"""whisper-medium [audio] — enc-dec, 24L encoder + 24L decoder, d_model=1024,
16H, d_ff=4096, vocab=51865 (padded to 51968 for TP divisibility).

Conv audio frontend is a STUB per the assignment: ``input_specs`` supplies
precomputed frame embeddings (1500 frames) to the encoder.
[arXiv:2212.04356; unverified]
"""
from repro_torch.configs.base import ModelConfig, register, smoke_reduce


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="audio",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=51865,
        head_dim=64,
        is_encoder_decoder=True,
        enc_layers=24,
        enc_seq=1500,
        norm="layernorm",
        act="gelu",
        use_bias=True,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return smoke_reduce(full())


register("whisper-medium", full, smoke)
