"""Core neural layers of the LM (port of ``repro.models.layers``).

Parameters are plain nested dicts of tensors, in the reference's layouts
(``wq`` is (d_model, Hq·hd), so a projection is ``x @ w``).  Every
``init_*`` function takes a ``torch.Generator`` and draws on the
generator's device before moving to ``device``; the draws differ from
JAX's, so the parity tests carry the reference's weights across
(``convert.lm_params_from_numpy``).

``attention`` dispatches to the port's kernels: one query token against a
KV cache (``kv_len`` given, or non-causal cross-attention at decode) to
kernel 8 (``kernels/decode_attention.py``), self-attention, the encoder and
cross-attention at prefill to kernel 7 (``kernels/flash_attention.py``).
On CUDA tensors the kernels run, on CPU tensors their plain versions
(``mode`` picks one explicitly); an offset causal query block raises
``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

_F32 = torch.float32


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, std: float, dtype, device):
    x = torch.randn(shape, generator=gen, dtype=_F32, device=gen.device)
    return (x * std).to(dtype).to(device)


def dense_init(gen, shape, dtype, scale: Optional[float] = None, device=None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return _normal(gen, shape, std, dtype, device)


def embed_init(gen, shape, dtype, device=None):
    return _normal(gen, shape, 0.02, dtype, device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(norm: str, d: int, dtype, device=None) -> dict:
    if norm == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if norm == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    if norm == "layernorm_np":  # olmo: non-parametric LN
        return {}
    raise ValueError(norm)


def apply_norm(norm: str, params: dict, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Computed in float32, returned in x's dtype."""
    dtype = x.dtype
    x = x.to(_F32)
    if norm == "rmsnorm":
        x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
        x = x * params["scale"].to(_F32)
    elif norm in ("layernorm", "layernorm_np"):
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
        x = (x - mu) * torch.rsqrt(var + eps)
        if norm == "layernorm":
            x = x * params["scale"].to(_F32) + params["bias"].to(_F32)
    else:
        raise ValueError(norm)
    return x.to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=_F32, device=device)
                            / half))


def apply_rope(x: torch.Tensor, positions, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)            # (hd/2,)
    pos = torch.as_tensor(positions, device=x.device).to(_F32)
    angles = pos[..., None] * freqs                          # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(_F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA)
# ---------------------------------------------------------------------------


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, q_chunk: int = 512, kv_len=None, q_offset=None,
              causal_buckets: int = 1,
              mode: Optional[str] = None) -> torch.Tensor:
    """GQA attention, q (B, Sq, Hq, hd), k and v (B, Skv, Hkv, hd) ->
    (B, Sq, Hq, hd).

    * ``kv_len`` given (the decode step: one query token against a cache
      whose first ``kv_len`` positions are valid, ``q_offset`` its
      position): kernel 8 on ``q[:, 0]`` and the cache seen as
      (B, Hkv, S, hd) through ``permute``, which copies nothing;
    * no ``kv_len``, non-causal, one query token (cross-attention at
      decode, against the whole encoder cache): kernel 8 with
      ``kv_len = Skv``, whose split-KV grid fills the card where kernel
      7 would leave 63 of a block's 64 query rows idle;
    * no ``kv_len``, otherwise: kernel 7, non-causal at any Sq and Skv
      (cross-attention at prefill, the encoder), causal at Sq == Skv.

    Causal with Sq != Skv or with ``q_offset`` and no ``kv_len`` raises
    ``NotImplementedError``: the reference's diagonal there starts at key
    0, kernel 7's at Skv - Sq, and no path runs it.  ``q_chunk`` and
    ``causal_buckets`` set the reference's memory and speed, not its
    result; the kernels need neither.  A float32 or bfloat16 cache in
    another dtype than q is cast to q's, as the reference does; a
    ``float8_e4m3fn`` cache goes to kernel 8 as it is (the reference's
    cast to q's dtype is exact, and the kernel converts exactly as it
    reads).  ``mode`` is that of ``kernels.ops``:
    ``None`` runs the kernels on CUDA tensors and their plain versions on
    the CPU.
    """
    del q_chunk, causal_buckets
    if k.dtype != q.dtype and k.dtype in (torch.float32, torch.bfloat16):
        k, v = k.to(q.dtype), v.to(q.dtype)
    sq, skv = q.shape[1], k.shape[1]
    if kv_len is None and sq == 1 and not causal and q_offset is None:
        kv_len = skv
    if kv_len is not None:
        if sq != 1:
            raise NotImplementedError(
                f"attention: kv_len with {sq} query tokens (only the one-token "
                f"decode step is ported)")
        del q_offset          # one token: the kv_len mask is the whole mask
        out = ops.decode_attention(q[:, 0], k.permute(0, 2, 1, 3),
                                   v.permute(0, 2, 1, 3), kv_len, mode=mode)
        return out[:, None]
    if q_offset is not None or (causal and sq != skv):
        raise NotImplementedError(
            f"attention: causal Sq={sq} against Skv={skv} keys without "
            f"kv_len (offset queries are not ported: no path runs them)")
    return ops.flash_attention(q, k, v, causal=causal, mode=mode)


def init_attention(gen, cfg, dtype, device=None) -> dict:
    d, hq, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
    p = {
        "wq": dense_init(gen, (d, hq * hd), dtype, device=device),
        "wk": dense_init(gen, (d, hkv * hd), dtype, device=device),
        "wv": dense_init(gen, (d, hkv * hd), dtype, device=device),
        "wo": dense_init(gen, (hq * hd, d), dtype,
                         scale=1.0 / math.sqrt(2 * cfg.num_layers * hq * hd),
                         device=device),
    }
    if cfg.use_bias:
        p["bq"] = torch.zeros((hq * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((hkv * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((hkv * hd,), dtype=dtype, device=device)
    return p


def attention_qkv(params: dict, x: torch.Tensor, cfg):
    """Project x -> (q, k, v) with RoPE left to the caller."""
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    b, s, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.use_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return (q.reshape(b, s, hq, hd), k.reshape(b, s, hkv, hd),
            v.reshape(b, s, hkv, hd))


def attention_q(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """The query projection alone (cross-attention), (B, S, Hq, hd)."""
    b, s, _ = x.shape
    q = x @ params["wq"]
    if cfg.use_bias:
        q = q + params["bq"]
    return q.reshape(b, s, cfg.num_heads, cfg.resolved_head_dim)


def attention_out(params: dict, o: torch.Tensor) -> torch.Tensor:
    b, s, h, hd = o.shape
    return o.reshape(b, s, h * hd) @ params["wo"]


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(gen, d: int, ff: int, act: str, dtype, num_layers: int = 1,
             device=None) -> dict:
    out_scale = 1.0 / math.sqrt(2 * num_layers * ff)
    if act == "silu":
        return {
            "w_gate": dense_init(gen, (d, ff), dtype, device=device),
            "w_up": dense_init(gen, (d, ff), dtype, device=device),
            "w_down": dense_init(gen, (ff, d), dtype, scale=out_scale,
                                 device=device),
        }
    return {
        "w_up": dense_init(gen, (d, ff), dtype, device=device),
        "w_down": dense_init(gen, (ff, d), dtype, scale=out_scale,
                             device=device),
    }


def apply_mlp(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = F.gelu(x @ params["w_up"], approximate="tanh")  # jax.nn.gelu
    return h @ params["w_down"]
