"""Decode attention: one query token per head against a KV cache (port of
``repro.kernels.decode_attention``), kernel 8 of ROADMAP queue 2.

q (B, Hq, D), k and v (B, Hkv, S, D), ``kv_len`` a host int (or a 0-d
tensor) or a (B,) integer tensor: for batch row b and query head h the
output is the softmax-weighted sum of v over keys ``0 .. kv_len[b] - 1`` of
key/value head ``h // (Hq // Hkv)``, scale ``1/sqrt(D)``, scores, exp and
sums in float32, in q's dtype.  A row with ``kv_len = 0`` comes out as
zeros (``acc / max(l, 1e-30)``, as the TPU kernel; the reference's oracle
``decode_attention_ref`` gives the mean of V there).  ``kv_len`` past S is
clamped to S.  q is float32 or bfloat16; k and v are in q's dtype or in
``float8_e4m3fn`` (the reference's ``cache_dtype="float8_e4m3fn"``, cast to
q's dtype, exactly, before attending).  Two versions of one function:

* ``decode_attention_plain`` — plain PyTorch, the whole (B, Hkv, G, S)
  score block in float32.  The CPU tests use it and ``chip_smoke.py`` holds
  the kernel to it.
* ``decode_attention`` — the wrapper: on CUDA tensors ONE launch of the
  hand-written kernel ``csrc/decode_attention.cu`` (the key splits of one
  (batch, KV head) a thread-block cluster, merged inside the launch),
  counted in ``decode_attention.launches``, on the grid of ``plan``; on
  CPU tensors the plain version.  Any other device raises.

k and v may be strided views whose last axis is contiguous, such as the
model's (B, S, Hkv, D) cache seen through ``permute(0, 2, 1, 3)``: the
kernel takes their strides and copies nothing.  Both versions refuse, on
every device, what the kernel does not take: another dtype (float8_e5m2
among them), a cache in a third dtype, a head width outside
``HEAD_DIMS``, and mismatched shapes.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from repro_torch.kernels import _build

SOURCE = "decode_attention"
HEAD_DIMS = (16, 32, 64, 128)        # the kernel's template instances
Q_TYPES = {torch.float32: 0, torch.bfloat16: 1}
CACHE_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}
ROWS = 16            # query heads a block: the rows of one mma tile
CLUSTER_MAX = 8      # splits of one (batch, KV head): a portable cluster


def _dims(q, k, v):
    """(B, Hq, Hkv, S, D), raising on what the kernel does not take."""
    if q.dtype not in Q_TYPES:
        raise ValueError(f"decode_attention: q is {q.dtype}; the kernel "
                         f"takes float32 or bfloat16")
    for name, t in (("k", k), ("v", v)):
        if t.dtype not in (q.dtype, torch.float8_e4m3fn):
            raise ValueError(
                f"decode_attention: {name} is {t.dtype}; the kernel takes a "
                f"cache in q's dtype ({q.dtype}) or in float8_e4m3fn")
    if k.dtype != v.dtype:
        raise ValueError(f"decode_attention: mixed cache dtypes k {k.dtype}, "
                         f"v {v.dtype}")
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
    """(B, Hq, D) attention output, plain PyTorch in float32 (a float8
    cache cast to float32, exactly)."""
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


@dataclasses.dataclass(frozen=True)
class Capacity:
    """What one (q dtype, cache dtype, D) instance of the kernel gets on a
    card: ``tile`` keys a block takes a step (16 a warp); ``clusters[k -
    1]`` clusters of k blocks the card holds at once
    (``cudaOccupancyMaxActiveClusters``: a block's registers and shared
    memory, a cluster's blocks in one GPC); and its ``sms``."""
    tile: int
    clusters: tuple
    sms: int


@dataclasses.dataclass(frozen=True)
class Plan:
    """The grid of one launch: a block per (batch, KV head, chunk of up to
    ``ROWS`` query heads, split); the ``splits`` blocks of one (batch, KV
    head, chunk) form a cluster, and split r covers keys
    ``[r * span // splits, (r + 1) * span // splits)`` of a row's first
    kv_len."""
    chunks: int
    splits: int
    span: int
    pairs: int       # (batch, KV head, chunk) triples: clusters

    @property
    def blocks(self) -> int:
        return self.pairs * self.splits


def plan(b, hq, hkv, s, max_len, cap: Capacity) -> Plan:
    """The split count of one launch: the largest, at most ``CLUSTER_MAX``
    and with no split shorter than one tile, whose blocks leave no SM with
    two (``pairs * splits <= cap.sms``) and whose clusters the card holds
    in one wave; else one.  A split brings an idle SM into play and costs
    a cluster merge, so the keys split only while SMs would sit idle.
    ``max_len`` is the longest row's kv_len (S for a per-row kv_len)."""
    chunks = -(-(hq // hkv) // ROWS)
    pairs = b * hkv * chunks
    span = max(0, min(int(max_len), s))
    splits = 1
    for k in range(2, min(CLUSTER_MAX, span // cap.tile) + 1):
        if pairs * k <= cap.sms and pairs <= cap.clusters[k - 1]:
            splits = k
    return Plan(chunks, splits, span, pairs)


_CAPACITY: dict = {}


def capacity(device, q_dtype, cache_dtype, d) -> Capacity:
    """The instance's ``Capacity`` on ``device``, asked of the card once
    per instance and device (``decode_attention_clusters``)."""
    key = (device.index, Q_TYPES[q_dtype], CACHE_TYPES[cache_dtype], d)
    cap = _CAPACITY.get(key)
    if cap is None:
        fn = _build.load(SOURCE).decode_attention_clusters
        fn.argtypes = [_build.I] * 4
        fn.restype = ctypes.c_int
        with torch.cuda.device(device):
            clusters = tuple(fn(*key[1:], k)
                             for k in range(1, CLUSTER_MAX + 1))
        if min(clusters) < 1:
            raise RuntimeError(f"decode_attention: cluster occupancy of "
                               f"{q_dtype}, {cache_dtype}, D={d}: {clusters}")
        tile = 16 * (8 if q_dtype == torch.bfloat16 else 4)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        cap = Capacity(tile, clusters, sms)
        _CAPACITY[key] = cap
    return cap


def decode_attention(q, k, v, kv_len) -> torch.Tensor:
    """(B, Hq, D) attention output: one kernel launch on CUDA, the plain
    version on CPU.  q contiguous; k, v with a contiguous last axis and
    16-byte aligned rows (the kernel copies them 16 bytes at a time)."""
    b, hq, hkv, s, d = _dims(q, k, v)
    device = q.device
    if not _build.on_card("decode_attention", device):
        return decode_attention_plain(q, k, v, kv_len)
    _build.refuse_grad("decode_attention", (q, k, v))
    _build.check("q", q, q.dtype, q.shape, device)
    size = k.element_size()
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
    p = plan(b, hq, hkv, s, s if lens is not None else scalar,
             capacity(device, q.dtype, k.dtype, d))
    if p.blocks >= 2 ** 31:
        raise ValueError(f"decode_attention: grid too large for B={b} "
                         f"Hq={hq} S={s}")
    out = torch.empty_like(q)
    _build.launch("decode_attention", SOURCE,
                  [_build.P] * 5 + [_build.I] * 8 + [_build.L] * 6
                  + [_build.I] * 3, device,
                  q, k, v, out, lens, 0 if scalar is None else scalar, b, hq,
                  hkv, s, d, Q_TYPES[q.dtype], CACHE_TYPES[k.dtype],
                  *k.stride()[:3], *v.stride()[:3], p.chunks, p.splits,
                  p.span)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
