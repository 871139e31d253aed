"""Plain PyTorch oracles for the kernels (the correctness ground truth).

Deliberately direct, as the reference's ``repro.kernels.ref``: attention
materializes the whole (B, H, Sq, Skv) score matrix, the scan steps one
position at a time.
"""
from __future__ import annotations

import math

import torch


def sdqn_score_ref(feats, w1, b1, w2, b2):
    """Unfused Table-4 Q-net on a built (..., 6) feature matrix."""
    h = torch.clamp(feats.to(torch.float32) @ w1 + b1, min=0.0)
    return (h @ w2 + b2)[..., 0]


def _repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    return x if groups == 1 else torch.repeat_interleave(x, groups, dim=2)


def flash_attention_ref(q, k, v, *, causal=True):
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D)."""
    sq, hq, d = q.shape[1:]
    skv, hkv = k.shape[1], k.shape[2]
    k = _repeat_kv(k, hq // hkv).to(torch.float32)
    v = _repeat_kv(v, hq // hkv).to(torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k) / math.sqrt(d)
    if causal:
        qpos = torch.arange(sq, device=q.device) + (skv - sq)
        mask = qpos[:, None] >= torch.arange(skv, device=q.device)[None, :]
        s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def decode_attention_ref(q, k, v, kv_len):
    """q: (B, Hq, D); k, v: (B, Hkv, S, D); kv_len: () or (B,) -> (B, Hq, D).
    Masked scores are -1e30, so a row with kv_len = 0 gets the mean of V,
    as the reference's oracle does (the kernel gives zeros there).  A
    float8 cache is cast to float32 (exactly) first."""
    b, hq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    k = torch.repeat_interleave(k.to(torch.float32), group, dim=1)
    v = torch.repeat_interleave(v.to(torch.float32), group, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q.to(torch.float32), k) / math.sqrt(d)
    lens = torch.as_tensor(kv_len, device=q.device).reshape(-1).expand(b)
    mask = torch.arange(skv, device=q.device)[None, None, :] < lens[:, None, None]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p, v).to(q.dtype)


def mamba_scan_ref(x, dt, a, bmat, cmat, d_skip, h0):
    """Sequential selective scan; shapes as in ``kernels.mamba_scan``.
    Returns ``(y (B, S, di) in x's dtype, hT (B, di, N) float32)``."""
    h = h0
    ys = []
    xf = x.to(torch.float32)
    for t in range(x.shape[1]):
        x_t, dt_t, b_t, c_t = xf[:, t], dt[:, t], bmat[:, t], cmat[:, t]
        da = torch.exp(dt_t[..., None] * a[None])             # (B, di, N)
        h = da * h + (dt_t * x_t)[..., None] * b_t[:, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c_t) + x_t * d_skip)
    return torch.stack(ys, dim=1).to(x.dtype), h
