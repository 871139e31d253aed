"""Architecture + shape configuration system (the port's own copy of
``repro.configs.base``, field for field: the port imports nothing of the
reference package).

Every assigned architecture registers a ``ModelConfig`` here (exact published
hyper-parameters) plus a reduced ``smoke`` variant used by CPU tests.  Configs
are selected by id via ``get_config("--arch" id)``; shapes via ``SHAPES``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Unified LM-family model configuration.

    Families: dense | moe | ssm | hybrid | vlm | audio (enc-dec).
    """

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int            # query heads (0 => attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0         # 0 => d_model // num_heads

    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0         # per-expert FFN width (0 => d_ff)
    moe_shared_d_ff: int = 0  # shared-expert FFN width (qwen2-moe)
    moe_every: int = 1        # apply MoE every k-th layer (jamba: 2)
    moe_capacity_factor: float = 1.25

    # --- SSM (mamba-1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0      # 0 => ceil(d_model / 16)

    # --- hybrid (jamba): one attention layer per `attn_period`, rest mamba ---
    attn_period: int = 0      # 0 => pure family; jamba: 8
    attn_offset: int = 0      # index of the attention layer within a period

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    enc_layers: int = 0
    enc_seq: int = 1500       # whisper audio frames after conv frontend (stub)

    # --- VLM (internvl): vision patch embeddings spliced into the prefix ---
    num_vision_tokens: int = 0

    # --- misc architecture knobs ---
    norm: str = "rmsnorm"     # rmsnorm | layernorm | layernorm_np (non-parametric)
    act: str = "silu"         # silu (SwiGLU) | gelu (plain MLP)
    use_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    vocab_pad_to: int = 128   # pad vocab for TP divisibility

    # --- performance knobs (§Perf hillclimbing) ---
    causal_buckets: int = 1     # >1: bucketed lower-triangle attention
    moe_dispatch: str = "batched"  # "batched" (per-row, shard-local) | "global"
    cache_dtype: str = "bfloat16"  # KV-cache storage ("float8_e4m3fn" halves traffic)

    # --- numerics / memory policy ---
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: str = "full"       # none | dots | full
    scan_layers: bool = True

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        if self.ssm_dt_rank:
            return self.ssm_dt_rank
        return max(1, (self.d_model + 15) // 16)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can decode at 500k context (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline bookkeeping)."""
        d, v = self.d_model, self.padded_vocab
        hd = self.resolved_head_dim
        total = v * d  # embed
        if not self.tie_embeddings:
            total += d * v

        def attn_params() -> int:
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            return q + kv + o

        def mlp_params(ff: int) -> int:
            if self.act == "silu":
                return 3 * d * ff
            return 2 * d * ff

        def moe_params() -> int:
            e_ff = self.moe_d_ff or self.d_ff
            p = d * self.moe_num_experts  # router
            p += self.moe_num_experts * mlp_params(e_ff)
            if self.moe_shared_d_ff:
                p += mlp_params(self.moe_shared_d_ff) + d  # + shared gate
            return p

        def mamba_params() -> int:
            di, n, r = self.d_inner, self.ssm_state, self.dt_rank
            p = d * 2 * di              # in_proj
            p += di * self.ssm_conv     # depthwise conv
            p += di * (r + 2 * n)       # x_proj -> dt, B, C
            p += r * di + di            # dt_proj
            p += di * n + di            # A_log, D
            p += di * d                 # out_proj
            return p

        for layer in range(self.num_layers):
            total += 2 * d  # norms (approximate; np-norm contributes 0 but keep simple)
            if self.family == "ssm":
                total += mamba_params()
                continue
            is_attn = True
            if self.attn_period:
                is_attn = layer % self.attn_period == self.attn_offset
            total += attn_params() if is_attn else mamba_params()
            use_moe = self.moe_num_experts and (layer % self.moe_every == self.moe_every - 1)
            total += moe_params() if use_moe else mlp_params(self.d_ff)

        if self.is_encoder_decoder:
            for _ in range(self.enc_layers):
                total += attn_params() + mlp_params(self.d_ff) + 2 * d
            total += self.num_layers * (attn_params() + d)  # cross-attn + its norm
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.moe_num_experts:
            return self.param_count()
        full = self.param_count()
        e_ff = self.moe_d_ff or self.d_ff
        d = self.d_model
        per_expert = (3 if self.act == "silu" else 2) * d * e_ff
        n_moe_layers = sum(
            1
            for layer in range(self.num_layers)
            if layer % self.moe_every == self.moe_every - 1
        )
        inactive = n_moe_layers * (self.moe_num_experts - self.moe_top_k) * per_expert
        return full - inactive


@dataclass(frozen=True)
class ShapeConfig:
    """An assigned (workload) input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str, full: Callable[[], ModelConfig], smoke: Callable[[], ModelConfig]) -> None:
    _REGISTRY[arch_id] = full
    _SMOKE_REGISTRY[arch_id] = smoke


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    _ensure_loaded()
    reg = _SMOKE_REGISTRY if smoke else _REGISTRY
    if arch_id not in reg:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(reg)}")
    return reg[arch_id]()


def list_archs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k skipped: pure full-attention arch (see DESIGN.md)"
    return True, ""


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    # Import every config module so registration side effects run.
    from repro_torch.configs import (  # noqa: F401
        olmo_1b,
        llama3_405b,
        command_r_plus_104b,
        granite_8b,
        qwen2_moe_a2_7b,
        dbrx_132b,
        falcon_mamba_7b,
        internvl2_76b,
        jamba_1_5_large_398b,
        whisper_medium,
    )


def smoke_reduce(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Produce a tiny same-family variant for CPU smoke tests."""
    base = dict(
        num_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        enc_layers=2 if cfg.is_encoder_decoder else 0,
        enc_seq=16 if cfg.is_encoder_decoder else cfg.enc_seq,
        num_vision_tokens=4 if cfg.num_vision_tokens else 0,
        remat="none",
    )
    if cfg.num_heads:
        base["num_heads"] = 4
        base["num_kv_heads"] = min(4, max(1, cfg.num_kv_heads * 4 // max(cfg.num_heads, 1)))
    if cfg.moe_num_experts:
        base["moe_num_experts"] = 4
        base["moe_top_k"] = min(2, cfg.moe_top_k)
        base["moe_d_ff"] = 32
        base["moe_shared_d_ff"] = 64 if cfg.moe_shared_d_ff else 0
        base["moe_every"] = min(cfg.moe_every, 2)
    if cfg.family in ("ssm", "hybrid"):
        base["ssm_state"] = min(cfg.ssm_state, 8) or 8
        base["ssm_dt_rank"] = 8
    if cfg.attn_period:
        base["attn_period"] = 2
        base["attn_offset"] = 1
        base["num_layers"] = 4
    base.update(overrides)
    return replace(cfg, **base)
