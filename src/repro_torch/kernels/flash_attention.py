"""Blocked online-softmax attention forward (port of
``repro.kernels.flash_attention``), kernel 7 of ROADMAP queue 2.

Two versions of one function, in the reference's layout: q (B, Sq, Hq, D),
k and v (B, Skv, Hkv, D), float32 or bfloat16 (scores, exp and sums in
float32, the output in q's dtype), GQA groups of ``Hq / Hkv`` query heads
per key/value head, scale ``1/sqrt(D)``, and under ``causal`` the diagonal
at ``Skv - Sq`` (query row i sees keys ``0 .. i + Skv - Sq``):

* ``flash_attention_plain`` — plain PyTorch: walks the keys in blocks of
  ``PLAIN_BLOCK_K`` with the online-softmax update of the TPU kernel (running
  max, rescaled sum and accumulator), so its memory is (B, H, Sq, block_k)
  and never (B, H, Sq, Skv).  The CPU tests use it and ``chip_smoke.py``
  holds the kernel to it.
* ``flash_attention`` — the wrapper: on CUDA tensors ONE launch of the
  hand-written tensor-core kernel ``csrc/flash_attention.cu`` (bfloat16 on
  ``mma.sync`` m16n8k16, float32 as 3xTF32 on m16n8k8), counted in
  ``flash_attention.launches``; on CPU tensors the plain version.  Any
  other device raises.  ``plan(d, dtype)`` is the kernel's launch plan.

The plain version keeps the probabilities in float32 for the PV product,
as the TPU kernel does (its ``p.astype(v.dtype)`` casts to float32: v was
cast to float32 when its tile was read).  In bfloat16 the CUDA kernel
rounds them to bfloat16, the A operand of its tensor-core product; the two
differ by that rounding, well inside the bfloat16 tolerance (2e-2).

Both refuse what the kernel does not take, on every device: a dtype other
than float32 and bfloat16, mixed dtypes, a head width outside
``HEAD_DIMS``, mismatched shapes, and
``causal`` with Sq > Skv.  The last leaves the first ``Sq - Skv`` query
rows no key at all; the reference's output for them depends on its block
sizes, so it has no single value to port.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

SOURCE = "flash_attention"
HEAD_DIMS = (8, 16, 32, 64, 128)     # the kernel's template instances
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PLAIN_BLOCK_K = 256              # keys per step of the plain version
SMEM_LIMIT = 232_448             # shared bytes a block may use (H100)

_F32 = torch.float32


class Plan(NamedTuple):
    """One launch of the kernel (``csrc/flash_attention.cu``, whose
    ``Tiles`` this mirrors; it refuses a launch whose ``rows`` or
    ``smem_bytes`` differ from its own)."""
    threads: int      # 4 warps
    rows: int         # query rows per block, 16 a warp
    keys: int         # keys per K/V tile
    stages: int       # K/V tiles in the cp.async ring
    pitch: int        # bytes per tile row in shared memory
    smem_bytes: int   # dynamic shared memory per block: Q tile and ring


KEYS = {torch.bfloat16: 32, torch.float32: 64}   # keys per K/V tile


def plan(d: int, dtype: torch.dtype) -> Plan:
    """The launch plan at head width ``d``.  A bfloat16 tile row is padded
    to an odd number of 16-byte chunks (ldmatrix without bank conflicts),
    a float32 one by 4 floats (fragment reads without bank conflicts)."""
    if d not in HEAD_DIMS or dtype not in DTYPES:
        raise ValueError(f"flash_attention: no kernel instance for {dtype} "
                         f"at head width {d}")
    threads, rows, stages, keys = 128, 64, 2, KEYS[dtype]
    pitch = 16 * ((d // 8) | 1) if dtype == torch.bfloat16 else 4 * (d + 4)
    return Plan(threads, rows, keys, stages, pitch,
                pitch * (rows + 2 * stages * keys))


def query_block_order(n_blocks: int) -> list:
    """The query block that the kernel's blocks take, in launch order
    (``blockIdx.y`` 0, 1, ...): reversed, so under ``causal`` the blocks
    with the most keys start first."""
    return [n_blocks - 1 - y for y in range(n_blocks)]


def _dims(q, k, v, causal):
    """(B, Sq, Hq, Skv, Hkv, D), raising on what the kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4 or t.dtype not in DTYPES:
            raise ValueError(f"flash_attention: {name} must be a 4-D float32 "
                             f"or bfloat16 tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"flash_attention: mixed dtypes q {q.dtype}, k "
                         f"{k.dtype}, v {v.dtype}")
    b, sq, hq, d = q.shape
    bk, skv, hkv, dk = k.shape
    if (bk, dk) != (b, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {d} not in {HEAD_DIMS}")
    if min(b, sq, skv, hkv) < 1 or hq % hkv:
        raise ValueError(f"flash_attention: unsupported shape B={b} Sq={sq} "
                         f"Skv={skv} Hq={hq} Hkv={hkv}")
    if causal and sq > skv:
        raise ValueError(f"flash_attention: causal with Sq={sq} > Skv={skv} "
                         f"leaves query rows without a key")
    return b, sq, hq, skv, hkv, d


def flash_attention_plain(q, k, v, *, causal: bool) -> torch.Tensor:
    """(B, Sq, Hq, D) attention output, plain PyTorch in float32,
    ``PLAIN_BLOCK_K`` keys at a time (online softmax; masked scores are
    ``-inf`` and key 0 is always visible, so the running max is finite
    after the first block)."""
    b, sq, hq, skv, hkv, d = _dims(q, k, v, causal)
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    dtype = q.dtype
    q, k, v = (t.to(_F32) for t in (q, k, v))        # no copy for float32
    # (B, Hkv, g, Sq, D): the g query heads of a group share one k/v head
    qh = q.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4)
    kh = k.permute(0, 2, 1, 3)[:, :, None]           # (B, Hkv, 1, Skv, D)
    vh = v.permute(0, 2, 1, 3)[:, :, None]
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    m = torch.full((b, hkv, g, sq, 1), -torch.inf, dtype=_F32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=_F32, device=q.device)
    block_k = PLAIN_BLOCK_K
    for j0 in range(0, skv, block_k):
        kb, vb = kh[..., j0:j0 + block_k, :], vh[..., j0:j0 + block_k, :]
        s = (qh @ kb.transpose(-1, -2)) * scale       # (B, Hkv, g, Sq, bk)
        if causal:
            kpos = torch.arange(j0, j0 + kb.shape[-2], device=q.device)
            s = s.masked_fill(kpos[None, :] > qpos, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p @ vb
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)             # (B, Hkv, g, Sq, D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(dtype)


def flash_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """(B, Sq, Hq, D) attention output: one kernel launch on CUDA, the
    plain version on CPU.  q, k, v contiguous, of one dtype, in the layout
    above (16-byte aligned on the card: the kernel reads rows 16 bytes at a
    time)."""
    b, sq, hq, skv, hkv, d = _dims(q, k, v, causal)
    device = q.device
    if not _build.on_card("flash_attention", device):
        return flash_attention_plain(q, k, v, causal=causal)
    for name, t, shape in (("q", q, q.shape), ("k", k, k.shape),
                           ("v", v, k.shape)):
        _build.check(name, t, q.dtype, shape, device)
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte aligned")
    p = plan(d, q.dtype)
    if b * hq >= 2 ** 31 or -(-sq // p.rows) > 65535:
        raise ValueError(f"flash_attention: grid too large for B={b} Hq={hq} "
                         f"Sq={sq}")
    out = torch.empty_like(q)
    _build.launch("flash_attention", SOURCE,
                  [_build.P] * 4 + [_build.I] * 10, device,
                  q, k, v, out, b, sq, skv, hq, hkv, d, int(causal),
                  DTYPES[q.dtype], p.rows, p.smem_bytes)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
