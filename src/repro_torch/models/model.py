"""The LM (port of ``repro.models.model``): the ``dense`` and ``vlm``
families, for inference.

Layers are grouped into *blocks* (the repeating unit, one layer for the
ported families) whose parameters are stacked over blocks, ``(nb, ...)``,
in the reference's tree, so ``convert.lm_params_from_numpy`` is a tree map.
Where the reference scans over the stacked blocks (``lax.scan``), the port
loops over them in Python; ``remat`` and ``scan_layers`` set how the
reference trains and compiles, and an eager forward pass needs neither.

The decode cache is ``{"sub0": {"k", "v"}}``, each (nb, B, max_len, Hkv,
hd).  ``decode_step`` writes the new token's K/V into it IN PLACE (the
reference's ``dynamic_update_slice`` returns a new cache, which on the card
would copy the whole cache every step) and returns the same dict.

The ``mamba`` and ``moe`` sub-layers (ssm, hybrid and moe families) and
cross-attention (the audio family) raise ``NotImplementedError``: they are
later items of ROADMAP "LM scaffolding", as is ``loss_and_metrics``.

Public entry points: init_params, init_cache, forward, prefill,
decode_step, logits_from_hidden.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers

ROADMAP_ITEM = "ROADMAP queue 1, 'LM scaffolding'"


@dataclasses.dataclass(frozen=True)
class SubLayer:
    mixer: str  # "attn" | "mamba"
    ffn: str    # "mlp" | "moe" | "none"
    cross: bool = False  # enc-dec cross attention after the mixer
    causal: bool = True


def block_spec(cfg: ModelConfig) -> List[SubLayer]:
    """The repeating sub-layer structure of one block (decoder side)."""
    if cfg.family == "ssm":
        return [SubLayer("mamba", "none")]  # mamba-1 blocks have no separate FFN
    if cfg.attn_period:  # hybrid (jamba)
        subs = []
        for j in range(cfg.attn_period):
            mixer = "attn" if j % cfg.attn_period == cfg.attn_offset else "mamba"
            use_moe = cfg.moe_num_experts and (j % cfg.moe_every == cfg.moe_every - 1)
            subs.append(SubLayer(mixer, "moe" if use_moe else "mlp"))
        return subs
    ffn = "moe" if cfg.moe_num_experts else "mlp"
    return [SubLayer("attn", ffn, cross=cfg.is_encoder_decoder)]


def num_blocks(cfg: ModelConfig) -> int:
    spec = block_spec(cfg)
    assert cfg.num_layers % len(spec) == 0, (cfg.num_layers, len(spec))
    return cfg.num_layers // len(spec)


def check_ported(cfg: ModelConfig) -> List[SubLayer]:
    """The block spec, raising ``NotImplementedError`` for a sub-layer the
    port does not have yet."""
    spec = block_spec(cfg)
    for sub in spec:
        missing = ("mamba mixer (models/mamba.py)" if sub.mixer != "attn"
                   else "MoE FFN (models/moe.py)" if sub.ffn == "moe"
                   else "cross-attention (the audio family)" if sub.cross
                   else None)
        if missing:
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}) needs the {missing}, not ported "
                f"yet: {ROADMAP_ITEM}")
    return spec


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_sublayer(gen, sub: SubLayer, cfg: ModelConfig, dtype, device) -> dict:
    return {
        "norm1": layers.init_norm(cfg.norm, cfg.d_model, dtype, device),
        "attn": layers.init_attention(gen, cfg, dtype, device),
        "norm2": layers.init_norm(cfg.norm, cfg.d_model, dtype, device),
        "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype,
                               cfg.num_layers, device),
    }


def _stack(trees: List[Any]):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """Random weights drawn from ``gen`` (on its device), in the
    reference's tree with leaves stacked over blocks, on ``device``."""
    spec = check_ported(cfg)
    dtype = _dtype(cfg.param_dtype)
    nb = num_blocks(cfg)
    params: Dict[str, Any] = {
        "embed": layers.embed_init(gen, (cfg.padded_vocab, cfg.d_model), dtype,
                                   device),
        "final_norm": layers.init_norm(cfg.norm, cfg.d_model, dtype, device),
        "layers": {
            f"sub{j}": _stack([_init_sublayer(gen, sub, cfg, dtype, device)
                               for _ in range(nb)])
            for j, sub in enumerate(spec)
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(
            gen, (cfg.d_model, cfg.padded_vocab), dtype,
            scale=cfg.d_model ** -0.5, device=device)
    return params


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    """Decode cache: per sub-layer, stacked over blocks, zeros."""
    spec = check_ported(cfg)
    dtype = dtype or _dtype(cfg.cache_dtype)
    shape = (num_blocks(cfg), batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {f"sub{j}": {"k": torch.zeros(shape, dtype=dtype, device=device),
                        "v": torch.zeros(shape, dtype=dtype, device=device)}
            for j in range(len(spec))}


# ---------------------------------------------------------------------------
# forward machinery
# ---------------------------------------------------------------------------


def _embed_tokens(params, cfg, tokens, extra: Optional[dict]) -> torch.Tensor:
    x = params["embed"][tokens]  # (B, S, D)
    if cfg.num_vision_tokens and extra is not None and "patch_embeds" in extra:
        pe = extra["patch_embeds"]
        x = torch.cat([pe.to(x.dtype), x[:, pe.shape[1]:]], dim=1)
    return x


def _run_attn(sp, x, cfg, *, positions, causal, cache_kv=None,
              cache_index=None, collect_kv=False, attn_mode=None):
    """One attention sub-layer (prefill or decode)."""
    q, k, v = layers.attention_qkv(sp, x, cfg)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    new_kv = None
    if cache_kv is not None:  # decode: write in place, then attend
        ck, cv = cache_kv
        ck[:, cache_index:cache_index + 1] = k
        cv[:, cache_index:cache_index + 1] = v
        o = layers.attention(q, ck, cv, causal=False, kv_len=cache_index + 1,
                             q_offset=cache_index, mode=attn_mode)
    else:
        o = layers.attention(q, k, v, causal=causal,
                             causal_buckets=cfg.causal_buckets,
                             mode=attn_mode)
        if collect_kv:
            new_kv = (k, v)
    return layers.attention_out(sp, o), new_kv


def _block_fn(bp, x, cfg, spec, *, mode, positions, block_cache=None,
              cache_index=None, attn_mode=None):
    """Run one block (all sub-layers). Returns (x, [(k, v) per sub-layer]
    in prefill mode)."""
    kvs = []
    for j, sub in enumerate(spec):
        sp = bp[f"sub{j}"]
        h = layers.apply_norm(cfg.norm, sp["norm1"], x)
        cache_kv = None
        if mode == "decode":
            sc = block_cache[f"sub{j}"]
            cache_kv = (sc["k"], sc["v"])
        out, kv = _run_attn(sp["attn"], h, cfg, positions=positions,
                            causal=sub.causal, cache_kv=cache_kv,
                            cache_index=cache_index,
                            collect_kv=mode == "prefill", attn_mode=attn_mode)
        kvs.append(kv)
        x = x + out
        h2 = layers.apply_norm(cfg.norm, sp["norm2"], x)
        x = x + layers.apply_mlp(sp["mlp"], h2, cfg.act)
    return x, kvs


def _index(tree, i: int):
    """Block ``i`` of a tree stacked over blocks (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            extra: Optional[dict] = None, *, mode: str = "train", cache=None,
            cache_index: Optional[int] = None, attn_mode: Optional[str] = None):
    """Returns (hidden_states, cache, aux_loss).

    ``mode`` "train" runs the prompt, "prefill" also returns its K/V as a
    cache (nb, B, S, Hkv, hd), "decode" runs one token per row at position
    ``cache_index`` against ``cache``, written in place and returned.
    ``attn_mode`` picks the attention kernels' mode (``kernels.ops``).
    """
    spec = check_ported(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got {mode!r}")
    x = _embed_tokens(params, cfg, tokens, extra)
    if mode == "decode":
        cache_index = int(cache_index)
        positions = torch.full((1,), cache_index, device=x.device)
    else:
        positions = torch.arange(tokens.shape[1], device=x.device)
    kv_blocks = []
    for i in range(num_blocks(cfg)):
        x, kvs = _block_fn(_index(params["layers"], i), x, cfg, spec,
                           mode=mode, positions=positions,
                           block_cache=(_index(cache, i) if mode == "decode"
                                        else None),
                           cache_index=cache_index, attn_mode=attn_mode)
        kv_blocks.append(kvs)
    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    new_cache = cache if mode == "decode" else None
    if mode == "prefill":
        new_cache = {f"sub{j}": {
            "k": torch.stack([kvs[j][0] for kvs in kv_blocks]),
            "v": torch.stack([kvs[j][1] for kvs in kv_blocks])}
            for j in range(len(spec))}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, new_cache, aux


def logits_from_hidden(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, S, Vp) float32 logits: the product accumulates in float32 and is
    not rounded to the weights' dtype (``preferred_element_type``)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    if x.dtype == torch.float32 or x.device.type != "cuda":
        out = x2.to(torch.float32) @ head.to(torch.float32)
    else:
        out = torch.mm(x2, head, out_dtype=torch.float32)
    return out.reshape(b, s, -1)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            extra: Optional[dict] = None, *, attn_mode: Optional[str] = None):
    """Run the prompt, return (last-token logits (B, Vp) float32, cache of
    the prompt's K/V (nb, B, S, Hkv, hd))."""
    x, cache, _ = forward(params, cfg, tokens, extra, mode="prefill",
                          attn_mode=attn_mode)
    return logits_from_hidden(params, cfg, x[:, -1:])[:, 0], cache


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache,
                cache_index: int, *, attn_mode: Optional[str] = None):
    """One token: tokens (B, 1), ``cache_index`` = #tokens already cached.
    Writes the token's K/V into ``cache`` in place.  Returns (logits
    (B, Vp) float32, cache)."""
    x, cache, _ = forward(params, cfg, tokens, mode="decode", cache=cache,
                          cache_index=cache_index, attn_mode=attn_mode)
    return logits_from_hidden(params, cfg, x[:, -1:])[:, 0], cache
