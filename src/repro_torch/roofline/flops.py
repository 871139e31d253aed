"""Analytic FLOP and HBM-byte models per (arch x shape) (port of
``repro.roofline.flops``, pure arithmetic on ``ModelConfig`` and
``ShapeConfig``, equal to the reference's).

The reference counts its attention as its chunked XLA path computes it:
full-length scores per query chunk, so causal training costs 2·S²·H·hd
and not the triangle.  The port keeps that count as it is, although
kernel 7 (forward and backward) skips the masked tiles: the gap stays in
``model_flops / hlo_flops`` (``useful_flops_ratio``).  ``hlo_flops`` of a
train cell also counts the reference's full rematerialization (a second
forward); the port keeps every activation instead.  MFU in this repo is
``model_flops`` (6 N D) over the step time and the card's peak.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import block_spec


def _attn_flops_per_token(cfg: ModelConfig, kv_len: float, causal: bool = True) -> float:
    hq, hkv, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_model
    proj = 2 * d * (hq + 2 * hkv) * hd + 2 * hq * hd * d
    # scores + value-combine; the XLA chunked path computes full-length scores
    # unless bucketed-causal is on (G buckets => (G+1)/2G of full length)
    g = max(cfg.causal_buckets, 1)
    eff_len = kv_len * (g + 1) / (2 * g) if (causal and g > 1) else kv_len
    mix = 2 * 2 * eff_len * hq * hd
    return proj + mix


def _mlp_flops_per_token(cfg: ModelConfig, ff: int) -> float:
    n_mats = 3 if cfg.act == "silu" else 2
    return n_mats * 2 * cfg.d_model * ff


def _moe_flops_per_token(cfg: ModelConfig) -> float:
    e_ff = cfg.moe_d_ff or cfg.d_ff
    f = 2 * cfg.d_model * cfg.moe_num_experts          # router
    f += cfg.moe_top_k * _mlp_flops_per_token(cfg, e_ff)
    if cfg.moe_shared_d_ff:
        f += _mlp_flops_per_token(cfg, cfg.moe_shared_d_ff) + 2 * cfg.d_model
    return f


def _mamba_flops_per_token(cfg: ModelConfig) -> float:
    d, di, n, r, cw = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    f = 2 * d * 2 * di                 # in_proj
    f += 2 * cw * di                   # depthwise conv
    f += 2 * di * (r + 2 * n)          # x_proj
    f += 2 * r * di                    # dt_proj
    f += 10 * di * n                   # discretize + recurrence + C-dot
    f += 2 * di * d                    # out_proj
    return f


def forward_flops_per_token(cfg: ModelConfig, kv_len: float) -> float:
    """Decoder-side forward FLOPs for one token attending to kv_len keys."""
    total = 0.0
    spec = block_spec(cfg)
    blocks = cfg.num_layers // len(spec)
    for sub in spec:
        if sub.mixer == "attn":
            total += _attn_flops_per_token(cfg, kv_len)
        else:
            total += _mamba_flops_per_token(cfg)
        if sub.cross:
            total += _attn_flops_per_token(cfg, cfg.enc_seq)
        if sub.ffn == "moe":
            total += _moe_flops_per_token(cfg)
        elif sub.ffn == "mlp":
            total += _mlp_flops_per_token(cfg, cfg.d_ff)
    return total * blocks


def cell_flops(cfg: ModelConfig, shape: ShapeConfig, *, remat_full: bool = True) -> Dict[str, float]:
    """Global FLOPs for one step of this cell, as implemented."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        fwd = b * s * forward_flops_per_token(cfg, kv_len=s)
        fwd += b * s * 2 * cfg.d_model * cfg.padded_vocab          # logits
        if cfg.is_encoder_decoder:
            enc = b * cfg.enc_seq * (
                _attn_flops_per_token(cfg, cfg.enc_seq) + _mlp_flops_per_token(cfg, cfg.d_ff)
            ) * cfg.enc_layers
            fwd += enc
        mult = 3 + (1 if remat_full else 0)   # fwd + 2x bwd + remat re-fwd
        hlo = fwd * mult
        model = 6 * cfg.active_param_count() * b * s
    elif shape.kind == "prefill":
        fwd = b * s * forward_flops_per_token(cfg, kv_len=s)
        fwd += b * 2 * cfg.d_model * cfg.padded_vocab              # last-pos logits
        if cfg.is_encoder_decoder:
            fwd += b * cfg.enc_seq * (
                _attn_flops_per_token(cfg, cfg.enc_seq) + _mlp_flops_per_token(cfg, cfg.d_ff)
            ) * cfg.enc_layers
        hlo = fwd
        model = 2 * cfg.active_param_count() * b * s
    else:  # decode: one token against a kv_len cache
        fwd = b * 1 * forward_flops_per_token(cfg, kv_len=s)
        fwd += b * 2 * cfg.d_model * cfg.padded_vocab
        hlo = fwd
        model = 2 * cfg.active_param_count() * b
    return {"hlo_flops": hlo, "model_flops": model}


def cell_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig, n_chips: int,
                   num_microbatches: int = 1, tp: int = 16) -> float:
    """Per-chip HBM traffic estimate for one step (documented napkin model).

    weights: each microbatch reads the (TP-sharded) weights for fwd and bwd,
    plus remat re-read; grads accumulate read+write fp32; optimizer update
    reads/writes moments+master.
    activations: ~24 bytes/elem/layer of (tokens_local × d_model) traffic
    fwd+bwd, plus attention score traffic for the chunked implementation.
    kv cache: decode reads the whole local cache shard once.
    """
    p_bytes = cfg.param_count() * 2            # bf16
    p_local = p_bytes / n_chips
    p_gathered = p_bytes / tp                  # after FSDP all-gather, per chip
    b, s = shape.global_batch, shape.seq_len
    bpe = 2

    if shape.kind == "train":
        nm = num_microbatches
        w = p_gathered * nm * 3                # fwd + bwd + remat reads
        w += p_local * 4 * 2 * nm              # fp32 grad accum rw
        w += p_local * 4 * 6                   # adam m/v/master rw
        dp = max(n_chips / tp, 1)
        tokens_local = b * s / dp
        act = 0.0
        for mult, width in ((24, cfg.d_model), (6, cfg.d_ff or cfg.d_inner)):
            act += mult * tokens_local * width * bpe * cfg.num_layers / max(tp, 1)
        # attention scores traffic (full-S chunked): 2 passes of B·H·S² fp32
        if cfg.num_heads:
            spec = block_spec(cfg)
            n_attn = cfg.num_layers * sum(1 for sub in spec if sub.mixer == "attn") // len(spec)
            act += 2 * (b / dp) * (cfg.num_heads / tp) * s * s * 4 * n_attn
        return w + act
    if shape.kind == "prefill":
        tokens_local = b * s / max(n_chips / tp, 1)
        w = p_gathered
        act = 10 * tokens_local * cfg.d_model * bpe * cfg.num_layers / max(tp, 1)
        return w + act
    # decode: weight-stationary (XLA keeps weights fully sharded and
    # all-reduces the tiny single-token activations — confirmed by the
    # near-zero collective bytes in the compiled HLO): p/n_chips per chip
    w = p_bytes / n_chips
    if cfg.num_heads:
        n_attn = sum(1 for sub in block_spec(cfg) if sub.mixer == "attn")
        blocks = cfg.num_layers // len(block_spec(cfg))
        cache_bpe = 1 if cfg.cache_dtype.startswith("float8") else 2
        cache = (
            blocks * n_attn * b * s * cfg.num_kv_heads * cfg.resolved_head_dim * 2 * cache_bpe
        ) / n_chips
        w += cache
    if cfg.family in ("ssm", "hybrid"):
        n_mamba = sum(1 for sub in block_spec(cfg) if sub.mixer == "mamba")
        blocks = cfg.num_layers // len(block_spec(cfg))
        w += blocks * n_mamba * b * cfg.d_inner * cfg.ssm_state * 4 / n_chips
    return w
