"""Decode attention: one query token per head against a KV cache (port of
``repro.kernels.decode_attention``), kernel 8 of ROADMAP queue 2.

q (B, Hq, D), k and v (B, Hkv, S, D), ``kv_len`` a host int (or a 0-d
tensor) or a (B,) integer tensor: for batch row b and query head h the
output is the softmax-weighted sum of v over keys ``0 .. kv_len[b] - 1`` of
key/value head ``h // (Hq // Hkv)``, scale ``1/sqrt(D)``, scores, exp and
sums in float32, in q's dtype.  A row with ``kv_len = 0`` comes out as
zeros (``acc / max(l, 1e-30)``, as the TPU kernel; the reference's oracle
``decode_attention_ref`` gives the mean of V there).  ``kv_len`` past S is
clamped to S.  Two versions of one function:

* ``decode_attention_plain`` — plain PyTorch, the whole (B, Hkv, G, S)
  score block in float32.  The CPU tests use it and ``chip_smoke.py`` holds
  the kernel to it.
* ``decode_attention`` — the wrapper: on CUDA tensors ONE call of the
  hand-written kernel ``csrc/decode_attention.cu`` (a split-KV pass, and
  when the keys are split a small merge pass), counted in
  ``decode_attention.launches``; on CPU tensors the plain version.  Any
  other device raises.

k and v may be strided views whose last axis is contiguous, such as the
model's (B, S, Hkv, D) cache seen through ``permute(0, 2, 1, 3)``: the
kernel takes their strides and copies nothing.  Both versions refuse, on
every device, what the kernel does not take: a dtype other than float32
and bfloat16 (a float8 cache among them), mixed dtypes, a head width
outside ``HEAD_DIMS``, and mismatched shapes.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

SOURCE = "decode_attention"
HEAD_DIMS = (16, 32, 64, 128)        # the kernel's template instances
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
GROUP_CHUNKS = (4, 2, 1)             # query heads a block serves, largest first
MIN_SPLIT_KEYS = 256                 # keys of the smallest split
BLOCKS_PER_SM = 4                    # split until the grid fills this many


def _dims(q, k, v):
    """(B, Hq, Hkv, S, D), raising on what the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES:
            raise ValueError(
                f"decode_attention: {name} is {t.dtype}; the kernel takes "
                f"float32 or bfloat16 (a float8 cache is not supported, see "
                f"ROADMAP)")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"decode_attention: mixed dtypes q {q.dtype}, k "
                         f"{k.dtype}, v {v.dtype}")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"decode_attention: want q (B, Hq, D) and k, v "
                         f"(B, Hkv, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    b, hq, d = q.shape
    bk, hkv, s, dk = k.shape
    if (bk, dk) != (b, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head width {d} not in "
                         f"{HEAD_DIMS}")
    if min(b, hkv, s) < 1 or hq % hkv:
        raise ValueError(f"decode_attention: unsupported shape B={b} Hq={hq} "
                         f"Hkv={hkv} S={s}")
    return b, hq, hkv, s, d


def _lengths(kv_len, b, device):
    """``(host int, None)`` for one length, ``(None, (B,) int32 tensor on
    device)`` for one per row."""
    if isinstance(kv_len, torch.Tensor):
        if kv_len.dim() == 0:
            return int(kv_len), None
        if tuple(kv_len.shape) != (b,) or kv_len.dtype.is_floating_point:
            raise ValueError(f"decode_attention: kv_len must be () or ({b},) "
                             f"integers, got {kv_len.dtype} "
                             f"{tuple(kv_len.shape)}")
        return None, kv_len.to(device=device, dtype=torch.int32).contiguous()
    return int(kv_len), None


def decode_attention_plain(q, k, v, kv_len) -> torch.Tensor:
    """(B, Hq, D) attention output, plain PyTorch in float32."""
    b, hq, hkv, s, d = _dims(q, k, v)
    g = hq // hkv
    scalar, lens = _lengths(kv_len, b, q.device)
    if lens is None:
        lens = torch.full((b,), scalar, dtype=torch.int32, device=q.device)
    qg = q.to(torch.float32).reshape(b, hkv, g, 1, d)
    kf = k.to(torch.float32)[:, :, None]                # (B, Hkv, 1, S, D)
    vf = v.to(torch.float32)[:, :, None]
    sc = (qg @ kf.transpose(-1, -2)) / math.sqrt(d)    # (B, Hkv, g, 1, S)
    valid = (torch.arange(s, device=q.device)[None, :]
             < lens[:, None]).reshape(b, 1, 1, 1, s)
    sc = sc.masked_fill(~valid, -1e30)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m) * valid        # 0 on masked keys, also at kv_len 0
    out = (p @ vf) / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return out.reshape(b, hq, d).to(q.dtype)


_SMS: dict = {}


def _sm_count(device) -> int:
    n = _SMS.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SMS[device.index] = n
    return n


def plan(b, hq, hkv, s, max_len, sms):
    """(query heads per block, splits, keys per split) of one launch: a
    block serves the largest chunk of its group in ``GROUP_CHUNKS``, and the
    keys are split until the grid holds ``BLOCKS_PER_SM`` blocks per SM,
    no split shorter than ``MIN_SPLIT_KEYS``."""
    group = hq // hkv
    gc = next(c for c in GROUP_CHUNKS if group % c == 0)
    blocks = b * hkv * (group // gc)
    max_len = max(0, min(max_len, s))
    want = -(-BLOCKS_PER_SM * sms // blocks)
    splits = max(1, min(want, -(-max_len // MIN_SPLIT_KEYS)))
    split_len = -(-max(max_len, 1) // splits)
    return gc, -(-max(max_len, 1) // split_len), split_len


def decode_attention(q, k, v, kv_len) -> torch.Tensor:
    """(B, Hq, D) attention output: one kernel call on CUDA, the plain
    version on CPU.  q contiguous; k, v with a contiguous last axis and
    16-byte aligned rows (the kernel reads them 16 bytes at a time)."""
    b, hq, hkv, s, d = _dims(q, k, v)
    device = q.device
    if not _build.on_card("decode_attention", device):
        return decode_attention_plain(q, k, v, kv_len)
    _build.check("q", q, q.dtype, q.shape, device)
    size = q.element_size()
    for name, t in (("k", k), ("v", v)):
        if t.device != device:
            raise ValueError(f"decode_attention: {name} is on {t.device}, "
                             f"q on {device}")
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                st * size % 16 for st in t.stride()[:3]):
            raise ValueError(f"decode_attention: {name} needs a contiguous "
                             f"last axis and 16-byte aligned rows, got "
                             f"strides {t.stride()}")
    if q.data_ptr() % 16:
        raise ValueError("decode_attention: q is not 16-byte aligned")
    scalar, lens = _lengths(kv_len, b, device)
    gc, splits, split_len = plan(b, hq, hkv, s, s if lens is not None
                                 else scalar, _sm_count(device))
    if b * hq * splits >= 2 ** 31 or splits > 65535:
        raise ValueError(f"decode_attention: grid too large for B={b} "
                         f"Hq={hq} S={s}")
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty((b * hq * splits * d,), dtype=torch.float32,
                               device=device)
        part_ml = torch.empty((b * hq * splits * 2,), dtype=torch.float32,
                              device=device)
    _build.launch("decode_attention", SOURCE,
                  [_build.P] * 7 + [_build.I] * 8 + [_build.L] * 6
                  + [_build.I] * 2, device,
                  q, k, v, out, part_acc, part_ml, lens,
                  0 if scalar is None else scalar, b, hq, hkv, s, d,
                  DTYPES[q.dtype], gc, *k.stride()[:3], *v.stride()[:3],
                  splits, split_len)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
