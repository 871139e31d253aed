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
  hand-written tensor-core kernel ``csrc/flash_attention.cu``, counted in
  ``flash_attention.launches``; on CPU tensors the plain version.  Any
  other device raises.  ``plan(d, dtype)`` is the kernel's launch plan and
  names its design: bfloat16 at D in ``WGMMA_HEAD_DIMS`` (every LM path)
  on ``wgmma`` fed by TMA, a producer warpgroup and two consumer
  warpgroups over 128 query rows and K/V tiles of 128 keys (64 at D = 64;
  ``fwd_plan``, ``fwd_walk``, ``fwd_grid``, ``fwd_deal``); bfloat16 at D
  in {8, 16, 32} on ``mma.sync`` m16n8k16; float32 as 3xTF32 on
  ``mma.sync`` m16n8k8.

Training (the gradient of the same function):

* On CUDA tensors under grad mode with an input that requires grad, the
  wrapper goes through ``FlashAttentionFn``: its forward launches kernel 7
  with the row log-sum-exp stored beside the output (``flash_attention_fwd``,
  natural log, float32 (B, Hq, Sq)), its backward ``flash_attention_bwd``:
  the hand-written kernels of ``csrc/flash_attention_bwd.cu``, counted
  once a call in ``flash_attention_bwd.launches``.  In bfloat16 that is
  three device kernels: Delta and the base-2 lse, then one wgmma pass fed
  by TMA over (batch, KV head, 128 keys) blocks (``bwd_plan``,
  ``bwd_walk``) that sums dK and dV in registers and adds each tile's dQ
  into a float32 accumulator with bulk reduce-adds, then dQ in bfloat16.
  Each query tile takes its key blocks' dQ pieces in ascending key-block
  order, a counter a tile (``bwd_counters``) keeping the order, so dQ,
  dK and dV all repeat bit for bit, as the reference's gradients do; the
  blocks launch in groups of ``bwd_plan(d).group_rows`` (batch, KV head)
  rows, key block by key block, so that few of a row start together and
  wait on each other.
  float32 runs two kernels (dQ, then dK and dV), bit for bit.  Only head
  widths ``BWD_HEAD_DIMS`` have a backward; any other raises
  ``ValueError`` under grad.
* ``flash_attention_bwd_plain`` is its plain twin: the same blocked
  recurrence in PyTorch, P recomputed from the saved log-sum-exp.  On CPU
  tensors autograd differentiates ``flash_attention_plain`` directly.

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
WGMMA_HEAD_DIMS = (64, 128)          # bfloat16 on wgmma fed by TMA
BWD_HEAD_DIMS = (64, 128)            # the backward's instances
SOURCE_BWD = "flash_attention_bwd"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PLAIN_BLOCK_K = 256              # keys per step of the plain version
SMEM_LIMIT = 232_448             # shared bytes a block may use (H100)

_F32 = torch.float32


class Plan(NamedTuple):
    """One launch of the kernel (``csrc/flash_attention.cu``, whose
    ``Tiles`` or, for the wgmma instances, ``FwdTiles`` this mirrors; it
    refuses a launch whose ``rows`` or ``smem_bytes`` differ from its
    own)."""
    threads: int      # mma.sync: 4 warps; wgmma: 3 warpgroups
    rows: int         # query rows per block (16 a warp; 64 a warpgroup)
    keys: int         # keys per K/V tile
    stages: int       # K/V tiles in the cp.async or TMA ring
    pitch: int        # bytes per tile row (wgmma: of a 64-column slab)
    smem_bytes: int   # dynamic shared memory per block: Q tile and ring
    design: str = "mma.sync"   # or "wgmma"


KEYS = {torch.bfloat16: 32, torch.float32: 64}   # mma.sync: keys a tile


class FwdPlan(NamedTuple):
    """The bfloat16 wgmma forward's tiles (``csrc/flash_attention.cu``,
    whose ``FwdTiles`` this mirrors)."""
    threads: int          # 2 consumer warpgroups + 1 producer warpgroup
    consumers: int        # consumer warpgroups, 64 query rows each
    block_m: int          # query rows a block
    block_n: int          # keys a K/V tile
    stages: int           # K/V tiles in the TMA ring
    smem_bytes: int       # dynamic shared memory a block
    blocks_per_sm: int    # resident blocks an SM (the launch bound)
    consumer_regs: int    # registers a consumer thread (setmaxnreg)
    producer_regs: int    # registers a producer thread


def fwd_plan(d: int) -> FwdPlan:
    """The wgmma forward's tiles at head width ``d``: the Q tile of 128
    rows, a 2-stage ring of K and V tiles, the output's staging tile, the
    barriers (Q full and free; K full, V full and stage free a stage) and
    1,024 bytes to round the base up to a 128-byte-swizzle atom.  D = 128:
    128-key tiles, one block an SM; D = 64: 64-key tiles, two blocks an SM
    (ptxas holds the kernel to the launch bound's registers, and two
    blocks' 80 are too few for a 128-key score tile).  The producer keeps
    24 registers of the block's pool and the consumers share the rest."""
    if d not in WGMMA_HEAD_DIMS:
        raise ValueError(f"flash_attention: no wgmma instance at head width "
                         f"{d}")
    bm, bn, stages, threads = 128, (64 if d == 64 else 128), 2, 384
    blocks = 2 if d == 64 else 1
    smem = (2 * bm * d * 2 + 2 * stages * bn * d * 2 + 8 * (2 + 3 * stages)
            + 1024)
    pool = threads * ((65536 // (threads * blocks)) & ~7)
    producer = 24
    consumer = (pool - 128 * producer) // 256 & ~7
    return FwdPlan(threads, 2, bm, bn, stages, smem, blocks, consumer,
                   producer)


def fwd_grid(b: int, sq: int, hq: int, d: int, sms: int) -> int:
    """The wgmma forward's grid on ``sms`` SMs: at D = 128 persistent, one
    block an SM (or a work item, (batch, query head, 128 query rows),
    where there are fewer); at D = 64 a block a work item."""
    n_items = b * hq * -(-sq // fwd_plan(d).block_m)
    return min(n_items, sms) if d == 128 else n_items


def fwd_deal(n_items: int, grid: int) -> list:
    """The work items (indices into ``fwd_walk``) each block takes, in
    order: rounds of ``grid`` items, dealt forward in even rounds and
    backward in odd ones, so that heaviest-first items even out."""
    return [[r * grid + (grid - 1 - j if r % 2 else j)
             for r in range(-(-n_items // grid))
             if r * grid + (grid - 1 - j if r % 2 else j) < n_items]
            for j in range(grid)]


def plan(d: int, dtype: torch.dtype) -> Plan:
    """The launch plan at head width ``d``.  bfloat16 at D in
    ``WGMMA_HEAD_DIMS``: ``fwd_plan``'s tiles in TMA's 128-byte swizzle.
    Otherwise ``mma.sync``: a bfloat16 tile row is padded to an odd number
    of 16-byte chunks (ldmatrix without bank conflicts), a float32 one by
    4 floats (fragment reads without bank conflicts)."""
    if d not in HEAD_DIMS or dtype not in DTYPES:
        raise ValueError(f"flash_attention: no kernel instance for {dtype} "
                         f"at head width {d}")
    if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS:
        p = fwd_plan(d)
        return Plan(p.threads, p.block_m, p.block_n, p.stages, 128,
                    p.smem_bytes, "wgmma")
    threads, rows, stages, keys = 128, 64, 2, KEYS[dtype]
    pitch = 16 * ((d // 8) | 1) if dtype == torch.bfloat16 else 4 * (d + 4)
    return Plan(threads, rows, keys, stages, pitch,
                pitch * (rows + 2 * stages * keys))


def fwd_walk(b: int, sq: int, skv: int, hq: int, hkv: int, d: int,
             causal: bool) -> list:
    """The wgmma forward's work items in order (batch and query head
    fastest, then the query block, reversed: the heaviest first,
    ``query_block_order``; ``fwd_deal`` deals them to the blocks): ``(batch,
    query head, KV head, first query row, [(first key, masked), ...])``,
    the K/V tiles the producer loads for the item in order, each marked
    where the consumers mask it by index (it crosses the causal diagonal at
    ``skv - sq`` or the last key)."""
    p = fwd_plan(d)
    bm, bn, group = p.block_m, p.block_n, hq // hkv
    n_qb = -(-sq // bm)
    out = []
    for y in query_block_order(n_qb):
        q0 = y * bm
        n_keys = min(skv, min(sq, q0 + bm) + skv - sq) if causal else skv
        kmin = min(skv, q0 + skv - sq + 1) if causal else skv
        tiles = [(k0, k0 + bn > kmin) for k0 in range(0, n_keys, bn)]
        for x in range(b * hq):
            bb, h = divmod(x, hq)
            out.append((bb, h, h // group, q0, tiles))
    return out


class BwdPlan(NamedTuple):
    """The bfloat16 backward's main launch (``csrc/flash_attention_bwd.cu``,
    whose ``BwdTiles`` this mirrors; it refuses a launch whose ``block_m``
    or ``smem_bytes`` differ from its own)."""
    threads: int          # 2 consumer warpgroups + 1 producer warpgroup
    consumers: int        # consumer warpgroups, 64 keys each
    block_m: int          # queries a Q/dO tile
    block_n: int          # keys a block
    stages: int           # Q/dO tiles in the TMA ring
    smem_bytes: int       # dynamic shared memory a block
    blocks_per_sm: int    # resident blocks an SM (shared memory bound)
    group_rows: int       # (batch, KV head) rows a launch group


def bwd_plan(d: int) -> BwdPlan:
    """The bfloat16 backward's tiles at head width ``d``: K and V tiles of
    128 keys, a 2-stage ring of Q and dO tiles with their rows' lse2 and
    Delta, two dS^T buffers (keys x queries, bf16) and each consumer's
    64 x 64 float32 dQ piece, plus the barriers (K/V; each stage's full
    and empty; each piece in, and the pieces' staging free) and 1,024
    bytes to round the base up to a 128-byte-swizzle atom."""
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: no kernel instance at head "
                         f"width {d}")
    bm, bn, stages = (64 if d == 128 else 128), 128, 2
    kv, qt, ds, dq = bn * d * 2, bm * d * 2, bn * bm * 2, 64 * 64 * 4
    stat, bars = stages * 2 * bm * 4, 8 * (1 + 2 * stages + 3)
    smem = 2 * kv + 2 * stages * qt + 2 * ds + 2 * dq + stat + bars + 1024
    return BwdPlan(384, 2, bm, bn, stages, smem, SMEM_LIMIT // smem, 32)


def bwd_walk(b: int, sq: int, skv: int, hq: int, hkv: int, d: int,
             causal: bool) -> list:
    """The bfloat16 backward's main kernel in launch order: the (batch,
    KV head) rows in groups of ``bwd_plan(d).group_rows`` (``blockIdx.z``),
    in a group its rows' first key blocks (the first keys, the heaviest
    under ``causal``), then their second, and so on (``blockIdx.y`` the
    key block, ``blockIdx.x`` the row in the group, fastest):
    ``(batch, KV head, first key, [(query head, first query, count),
    ...])``, the block's Q/dO tiles in the order its producer loads them:
    every head of the GQA group, each from the last query tile down to the
    first with a row that sees one of the block's keys (the diagonal at
    ``skv - sq``).  ``count`` is the value of the tile's counter
    (``bwd_counters``) that the block's dQ writer waits for before it adds
    the tile's two dQ pieces, and raises by one after them: the earlier
    key blocks of the (batch, KV head), all of which see the tile too and
    launch before it."""
    p = bwd_plan(d)
    bm, bn, group = p.block_m, p.block_n, hq // hkv
    n_mt, rows = -(-sq // bm), b * hkv
    per_group = min(rows, p.group_rows)
    out = []
    for g0 in range(0, rows, per_group):
        for x in range(-(-skv // bn)):
            k0 = x * bn
            m0 = max(0, k0 - (skv - sq)) // bm if causal else 0
            for y in range(g0, min(rows, g0 + per_group)):
                bb, hk = divmod(y, hkv)
                out.append((bb, hk, k0, [(hk * group + hh, m * bm, x)
                                         for hh in range(group)
                                         for m in range(n_mt - 1, m0 - 1,
                                                        -1)]))
    return out


def bwd_counters(b: int, sq: int, hq: int, d: int) -> tuple:
    """The shape of the bfloat16 backward's dQ counters, int32, one a
    (batch, query head, query tile of ``bwd_plan(d).block_m`` rows); the
    preprocess zeroes them."""
    return (b, hq, -(-sq // bwd_plan(d).block_m))


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


def flash_attention_plain(q, k, v, *, causal: bool,
                          return_lse: bool = False):
    """(B, Sq, Hq, D) attention output, plain PyTorch in float32,
    ``PLAIN_BLOCK_K`` keys at a time (online softmax; masked scores are
    ``-inf`` and key 0 is always visible, so the running max is finite
    after the first block).  With ``return_lse`` also each row's
    natural-log log-sum-exp of its scaled scores, (B, Hq, Sq) float32."""
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
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(l)).reshape(b, hq, sq)


def _check_card(tensors, dtype, device):
    """Device, dtype, shape, contiguity and 16-byte alignment (the kernels
    read rows 16 bytes at a time) of ``(name, tensor, shape)`` triples."""
    for name, t, shape in tensors:
        _build.check(name, t, dtype, shape, device)
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte aligned")


def _launch_forward(q, k, v, causal, with_lse):
    """One launch of kernel 7 on CUDA tensors: the output, and with
    ``with_lse`` the rows' log-sum-exp (else None)."""
    b, sq, hq, skv, hkv, d = _dims(q, k, v, causal)
    device = q.device
    if with_lse and d not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention: no backward at head width {d} "
                         f"(the backward and the lse store are built at "
                         f"{BWD_HEAD_DIMS}); call it outside grad mode or on "
                         f"inputs that need no gradient")
    _check_card((("q", q, q.shape), ("k", k, k.shape), ("v", v, k.shape)),
                q.dtype, device)
    p = plan(d, q.dtype)
    if b * hq * -(-sq // p.rows) >= 2 ** 31 or -(-sq // p.rows) > 65535:
        raise ValueError(f"flash_attention: grid too large for B={b} Hq={hq} "
                         f"Sq={sq}")
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=_F32, device=device) if with_lse
           else None)
    _build.launch("flash_attention", SOURCE,
                  [_build.P] * 5 + [_build.I] * 10, device,
                  q, k, v, out, lse, b, sq, skv, hq, hkv, d, int(causal),
                  DTYPES[q.dtype], p.rows, p.smem_bytes)
    flash_attention.launches += 1
    return out, lse


def flash_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """(B, Sq, Hq, D) attention output: one kernel launch on CUDA, the
    plain version on CPU.  q, k, v contiguous, of one dtype, in the layout
    above (16-byte aligned on the card: the kernel reads rows 16 bytes at a
    time).  On CUDA under grad mode, with an input that requires grad, the
    output carries kernel 7's backward (``FlashAttentionFn``)."""
    _dims(q, k, v, causal)
    if not _build.on_card("flash_attention", q.device):
        return flash_attention_plain(q, k, v, causal=causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal)
    return _launch_forward(q, k, v, causal, with_lse=False)[0]


flash_attention.launches = 0


def flash_attention_fwd(q, k, v, *, causal: bool):
    """``(out, lse)``: the output and each row's natural-log log-sum-exp,
    (B, Hq, Sq) float32, from one launch of kernel 7 on CUDA (recording no
    gradient), the plain version on CPU."""
    _dims(q, k, v, causal)
    if not _build.on_card("flash_attention", q.device):
        return flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    return _launch_forward(q, k, v, causal, with_lse=True)


def _bwd_dims(q, k, v, o, do, lse, causal):
    b, sq, hq, skv, hkv, d = _dims(q, k, v, causal)
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != tuple(q.shape):
            raise ValueError(f"flash_attention_bwd: {name} has shape "
                             f"{tuple(t.shape)}, want {tuple(q.shape)}")
    if tuple(lse.shape) != (b, hq, sq) or lse.dtype != _F32:
        raise ValueError(f"flash_attention_bwd: lse must be float32 "
                         f"{(b, hq, sq)}, got {lse.dtype} {tuple(lse.shape)}")
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head width {d} not in "
                         f"{BWD_HEAD_DIMS}")
    return b, sq, hq, skv, hkv, d


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal: bool):
    """``(dq, dk, dv)`` of ``flash_attention`` at output ``o`` and output
    gradient ``do``, plain PyTorch in float32 over key blocks of
    ``PLAIN_BLOCK_K``: P recomputed from the saved ``lse``, Delta =
    rowsum(do o), dS = P (do v^T - Delta); dq in q's dtype, dk and dv in
    k's.  A GQA group's gradients are summed over its query heads."""
    b, sq, hq, skv, hkv, d = _bwd_dims(q, k, v, o, do, lse, causal)
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)

    def heads(t):                                    # (B, Hkv, g, Sq, D)
        return t.to(_F32).reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4)

    qh, oh, doh = heads(q), heads(o), heads(do)
    kh = k.to(_F32).permute(0, 2, 1, 3)[:, :, None]   # (B, Hkv, 1, Skv, D)
    vh = v.to(_F32).permute(0, 2, 1, 3)[:, :, None]
    lse_h = lse.reshape(b, hkv, g, sq, 1)
    delta = torch.sum(doh * oh, dim=-1, keepdim=True)
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    dq = torch.zeros_like(qh)
    dk = torch.zeros((b, hkv, skv, d), dtype=_F32, device=q.device)
    dv = torch.zeros_like(dk)
    for j0 in range(0, skv, PLAIN_BLOCK_K):
        kb, vb = kh[..., j0:j0 + PLAIN_BLOCK_K, :], vh[..., j0:j0 + PLAIN_BLOCK_K, :]
        s = (qh @ kb.transpose(-1, -2)) * scale        # (B, Hkv, g, Sq, bk)
        if causal:
            kpos = torch.arange(j0, j0 + kb.shape[-2], device=q.device)
            s = s.masked_fill(kpos[None, :] > qpos, -torch.inf)
        p = torch.exp(s - lse_h)
        ds = p * (doh @ vb.transpose(-1, -2) - delta)
        dq = dq + (ds @ kb) * scale
        j1 = j0 + kb.shape[-2]
        dk[:, :, j0:j1] = (ds.transpose(-1, -2) @ qh).sum(dim=2) * scale
        dv[:, :, j0:j1] = (p.transpose(-1, -2) @ doh).sum(dim=2)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
    return (dq, dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool):
    """``(dq, dk, dv)``: on CUDA the kernels of
    ``csrc/flash_attention_bwd.cu`` (bfloat16: Delta and lse2, the wgmma
    pass, dQ's cast; float32: dQ, then dK and dV), counted once a call in
    ``flash_attention_bwd.launches``; on CPU the plain version.  Every
    input contiguous and 16-byte aligned, of q's dtype (lse float32); the
    tensor maps' row strides, Hq D and Hkv D bf16 elements, are multiples
    of 16 bytes at every width of ``BWD_HEAD_DIMS``."""
    b, sq, hq, skv, hkv, d = _bwd_dims(q, k, v, o, do, lse, causal)
    device = q.device
    if not _build.on_card("flash_attention_bwd", device):
        return flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal)
    _check_card((("q", q, q.shape), ("k", k, k.shape), ("v", v, k.shape),
                 ("o", o, q.shape), ("do", do, q.shape)), q.dtype, device)
    _build.check("lse", lse, _F32, (b, hq, sq), device)
    if (b * hq >= 2 ** 31 or b * hkv > 65535
            or -(-max(sq, skv) // 16) > 65535):
        raise ValueError(f"flash_attention_bwd: grid too large for B={b} "
                         f"Hq={hq} Hkv={hkv} Sq={sq} Skv={skv}")
    p = bwd_plan(d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.dtype == torch.bfloat16:
        # each query tile's base-2 lse rows, then its Delta rows
        n_mt = -(-sq // p.block_m)
        delta = torch.empty((b, hq, n_mt, 2, p.block_m), dtype=_F32,
                            device=device)
        dq_acc = torch.empty((b, hq, n_mt * p.block_m, d), dtype=_F32,
                             device=device)
        dq_sem = torch.empty(bwd_counters(b, sq, hq, d), dtype=torch.int32,
                             device=device)
    else:
        delta = torch.empty((b, hq, sq), dtype=_F32, device=device)
        dq_acc = dq_sem = None
    _build.launch("flash_attention_bwd", SOURCE_BWD,
                  [_build.P] * 12 + [_build.I] * 10, device,
                  q, k, v, o, do, lse, delta, dq_acc, dq_sem, dq, dk, dv, b,
                  sq, skv, hq, hkv, d, int(causal), DTYPES[q.dtype],
                  p.block_m, p.smem_bytes)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Kernel 7 with its backward: the forward keeps q, k, v, the output
    and the rows' log-sum-exp; the backward runs ``flash_attention_bwd``
    on them and the output gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _launch_forward(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse,
                                         causal=ctx.causal)
        return dq, dk, dv, None
