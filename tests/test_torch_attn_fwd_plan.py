"""Kernel 7's bfloat16 forward on Hopper at D in {64, 128}, modelled on the
CPU: its tiles (``flash_attention.fwd_plan``, against the static asserts of
``csrc/flash_attention.cu``), its walk over (batch, query head, 128 query
rows) blocks and their K/V tiles (``flash_attention.fwd_walk``), the
swizzled staging of the output, and a float32 emulation of the whole
schedule held to the reference's Pallas kernel in interpret mode and to
its oracle.

The emulation follows the kernel tile for tile: a block's 128 query rows
(TMA reads rows past Sq as zeros) against K/V tiles of ``fwd_plan``'s keys
(128 at D = 128, 64 at D = 64; zero rows past Skv), S = Q K^T in float32,
on a masked tile the keys a row does not see (past Skv, past the causal
diagonal at Skv - Sq) set to -inf by index, the online softmax in base 2
with log2(e) / sqrt(D) folded into one multiply and the running max
starting at -1e30, O rescaled and P V added, and at the end O / max(l,
1e-30) and the lse m / sqrt(D) + ln(l) for the rows below Sq.  It runs in float32 without the kernel's bfloat16 rounding of P,
so it is held to the references within 1e-5 of each output's largest
element, the lse within 1e-5.
"""
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest

import strategies as strat
from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import flash_attention as fa
from test_torch_attn_grad import SHAPES, TOL

CSRC = (pathlib.Path(fa.__file__).resolve().parent / "csrc"
        / "flash_attention.cu")
# chip_smoke.FA_FWD_TIMED: the bf16 rows the card times (B, Sq, Skv, Hq,
# Hkv, D, causal)
CARD_SHAPES = [(8, 512, 512, 16, 16, 128, True),
               (1, 4096, 4096, 16, 16, 128, True),
               (8, 1500, 1500, 16, 16, 64, False),
               (8, 384, 1500, 16, 16, 64, False),
               (8, 512, 512, 48, 8, 128, True),
               (2, 77, 300, 6, 2, 64, True)]
# more than one query block and K/V tile, ragged at both ends
EMULATED = SHAPES + [(2, 77, 300, 6, 2, 64, True),
                     (1, 300, 300, 6, 1, 128, True),
                     (1, 129, 257, 3, 1, 64, False)]
LOG2E = 1.4426950408889634
SM_SHARED = 233_472        # an H100 SM's shared memory, 1,024 a block kept


@pytest.mark.parametrize("d", fa.WGMMA_HEAD_DIMS)
def test_fwd_plan_fits_and_tiles_in_warpgroup_rows(d):
    """Shared bytes within a block's 232,448 and the SM's at its blocks an
    SM; the query block two consumer warpgroups of 64 rows and the key
    tile a whole wgmma N (128 keys at D = 128, one block an SM; 64 at D =
    64, two blocks an SM: ptxas holds the kernel to the launch bound's 80
    registers, too few for a 128-key score tile); the producer's 24
    registers and the consumers' fit the block's pool."""
    p = fa.fwd_plan(d)
    assert p.smem_bytes <= fa.SMEM_LIMIT == 232_448
    assert p.blocks_per_sm * (p.smem_bytes + 1024) <= SM_SHARED
    assert p.block_m == 64 * p.consumers
    assert (p.block_n, p.blocks_per_sm) == ((128, 1) if d == 128 else (64, 2))
    assert p.threads == 128 * (p.consumers + 1) and p.stages >= 2
    pool = p.threads * ((65536 // (p.threads * p.blocks_per_sm)) & ~7)
    assert 128 * p.producer_regs + 256 * p.consumer_regs <= pool
    assert p.producer_regs == 24
    assert p.consumer_regs == (240 if d == 128 else 104)


def test_fwd_plan_agrees_with_the_kernels_static_asserts():
    """The C++ ``FwdTiles`` asserts the key tile and shared bytes of each
    instance; the launch refuses a plan that differs."""
    text = CSRC.read_text()
    found = dict((int(d), (int(bn), int(smem))) for d, bn, smem in re.findall(
        r"static_assert\(FwdTiles<(\d+)>::BN == (\d+) &&\s*"
        r"FwdTiles<\d+>::SMEM == (\d+)", text))
    assert sorted(found) == sorted(fa.WGMMA_HEAD_DIMS)
    for d, (bn, smem) in found.items():
        p = fa.fwd_plan(d)
        assert (p.block_n, p.smem_bytes) == (bn, smem)
    with pytest.raises(ValueError, match="no wgmma instance"):
        fa.fwd_plan(32)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_plan_names_each_instances_design(d):
    """bfloat16 at D in {64, 128} (every LM path) on wgmma with the wgmma
    tiles; bfloat16 below and float32 at every width on mma.sync."""
    import torch

    bf = fa.plan(d, torch.bfloat16)
    if d in fa.WGMMA_HEAD_DIMS:
        p = fa.fwd_plan(d)
        assert bf.design == "wgmma"
        assert (bf.threads, bf.rows, bf.keys, bf.stages, bf.smem_bytes) == (
            p.threads, p.block_m, p.block_n, p.stages, p.smem_bytes)
    else:
        assert bf.design == "mma.sync"
    assert fa.plan(d, torch.float32).design == "mma.sync"


def _visible(sq, skv, causal):
    """(Sq, Skv) bool: query row i sees key j."""
    if not causal:
        return np.ones((sq, skv), bool)
    return np.arange(skv)[None, :] <= np.arange(sq)[:, None] + skv - sq


def _check_walk(shape):
    b, sq, skv, hq, hkv, d, causal = shape
    p = fa.fwd_plan(d)
    bm, bn, group = p.block_m, p.block_n, hq // hkv
    walk = fa.fwd_walk(b, sq, skv, hq, hkv, d, causal)
    n_qb = -(-sq // bm)
    # every (batch, query head, query block) once: a query block's heads
    # one after another, the heaviest query block first
    assert [(w[0], w[1], w[3]) for w in walk] == [
        (bb, h, y * bm) for y in fa.query_block_order(n_qb)
        for bb in range(b) for h in range(hq)]
    assert all(hk == h // group for _, h, hk, _, _ in walk)
    work = [len(w[4]) for w in walk]
    assert work == sorted(work, reverse=True)
    vis = _visible(sq, skv, causal)
    tiles_of = {}
    for _, _, _, q0, tiles in walk:   # the same tiles for every head
        assert tiles_of.setdefault(q0, tiles) == tiles
    count = np.zeros((sq, skv), np.int32)
    for q0, tiles in tiles_of.items():
        rows = slice(q0, min(sq, q0 + bm))
        assert [k0 for k0, _ in tiles] == list(range(0, bn * len(tiles), bn))
        for k0, masked in tiles:
            tile = vis[rows, k0:k0 + bn]
            # no tile without a visible pair is visited, and a tile is
            # masked exactly where one of its pairs is not visible
            assert tile.any(), (shape, q0, k0)
            assert masked == (not tile.all() or k0 + bn > skv), (q0, k0)
            count[rows, k0:k0 + bn] += 1
    # every visible pair in exactly one visited tile
    assert np.array_equal(count[vis], np.ones(vis.sum(), np.int32))


@pytest.mark.parametrize("shape", SHAPES + CARD_SHAPES)
def test_fwd_walk_covers_every_visible_pair_once(shape):
    """At the gradient tests' shapes and the card's timed shapes: each
    visible (query, key) pair falls in one visited tile, no visited tile
    is fully masked, only the tiles that cross the diagonal or the last
    key are masked, and query blocks launch heaviest first."""
    _check_walk(shape)


if strat.HAVE_HYPOTHESIS:
    from hypothesis import given, strategies as st

    @st.composite
    def _shapes(draw):
        causal = draw(st.booleans())
        sq = draw(st.integers(1, 300))
        skv = draw(st.integers(sq if causal else 1, 420))
        hkv = draw(st.integers(1, 3))
        group = draw(st.sampled_from([1, 2, 3, 6]))
        return (draw(st.integers(1, 2)), sq, skv, hkv * group, hkv,
                draw(st.sampled_from(fa.WGMMA_HEAD_DIMS)), causal)

    @given(shape=_shapes())
    def test_fwd_walk_covers_every_visible_pair_once_property(shape):
        _check_walk(shape)
else:
    def test_fwd_walk_covers_every_visible_pair_once_property():
        pytest.importorskip("hypothesis")


@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_fwd_grid_deals_every_item_once(shape):
    """The grid on an H100's 132 SMs: at D = 128 one block an SM, at D = 64
    a block a work item; every item dealt to one block, and at D = 128
    the heaviest-first items evened out: the busiest block within a
    quarter of the heaviest item's tiles of the mean, where dealing
    forward alone leaves OLMo-1B's ``train_4k`` half of it (16 tiles) and
    25% over the mean."""
    b, sq, skv, hq, hkv, d, causal = shape
    walk = fa.fwd_walk(b, sq, skv, hq, hkv, d, causal)
    grid = fa.fwd_grid(b, sq, hq, d, 132)
    assert grid == (min(len(walk), 132) if d == 128 else len(walk))
    dealt = fa.fwd_deal(len(walk), grid)
    assert sorted(i for x in dealt for i in x) == list(range(len(walk)))
    tiles = [sum(len(walk[i][4]) for i in x) for x in dealt]
    biggest = max(len(w[4]) for w in walk)
    assert max(tiles) - sum(tiles) / grid <= biggest / 4
    if shape[:2] == (1, 4096):
        forward = [sum(len(w[4]) for w in walk[j::grid]) for j in range(grid)]
        assert max(forward) - sum(forward) / grid == biggest / 2


def _stage_addr(d, r, col):
    """Byte of output element (row r of the item's 128 rows, column col)
    in the staging tile where the epilogue puts it: 64-column slabs of
    128 rows, row r at r * 128, its 16-byte chunk c at c ^ (r % 8)."""
    p = fa.fwd_plan(d)
    j = col // 8
    return ((j // 8) * p.block_m * 128 + r * 128 + (((j % 8) ^ (r % 8)) << 4)
            + (col % 8) * 2)


@pytest.mark.parametrize("d", fa.WGMMA_HEAD_DIMS)
def test_output_staging_is_the_swizzled_tile_without_bank_conflicts(d):
    """Each output element of an item has its own two bytes of the
    staging tile, a warpgroup's rows stay in its own 64 rows, and a
    warp's 4-byte store of one 8-column chunk (rows 16 warp + lane / 4 and
    + 8, columns 2 (lane % 4), + 1) hits 32 distinct banks."""
    p = fa.fwd_plan(d)
    every = sorted(_stage_addr(d, r, c) for r in range(p.block_m)
                   for c in range(d))
    assert every == list(range(0, 2 * p.block_m * d, 2))
    for j in range(d // 8):
        for wg, warp, half in ((0, 0, 0), (1, 3, 1), (1, 1, 0)):
            lanes = [(64 * wg + 16 * warp + lane // 4 + 8 * half,
                      8 * j + 2 * (lane % 4)) for lane in range(32)]
            assert len({(_stage_addr(d, r, c) // 4) % 32
                        for r, c in lanes}) == 32


def _emulate(shape, q, k, v):
    """(out, lse) by the kernel's schedule in float32 numpy."""
    b, sq, skv, hq, hkv, d, causal = shape
    p = fa.fwd_plan(d)
    bm, bn = p.block_m, p.block_n
    scale = np.float32(LOG2E / math.sqrt(d))
    out = np.full((b, sq, hq, d), np.nan, np.float32)
    lse = np.full((b, hq, sq), np.nan, np.float32)

    def rows(x, r0, n, limit):       # TMA: rows past the end read as zeros
        o = np.zeros((n,) + x.shape[1:], np.float32)
        m = max(0, min(n, limit - r0))
        o[:m] = x[r0:r0 + m]
        return o

    for bb, h, hk, q0, tiles in fa.fwd_walk(b, sq, skv, hq, hkv, d, causal):
        qt = rows(q[bb, :, h], q0, bm, sq)
        r = np.arange(q0, q0 + bm)
        kend = np.minimum(skv, r + skv - sq + 1) if causal else np.full(bm,
                                                                        skv)
        m = np.full(bm, -1e30, np.float32)
        l = np.zeros(bm, np.float32)
        acc = np.zeros((bm, d), np.float32)
        for k0, masked in tiles:
            kt = rows(k[bb, :, hk], k0, bn, skv)
            vt = rows(v[bb, :, hk], k0, bn, skv)
            s = qt @ kt.T
            if masked:
                s = np.where(np.arange(k0, k0 + bn)[None, :] >= kend[:, None],
                             np.float32(-np.inf), s)
            mx = np.maximum(m, s.max(axis=1))
            with np.errstate(invalid="ignore"):
                corr = np.exp2((m - mx) * scale)
                pt = np.exp2(s * scale - (mx * scale)[:, None])
            l = l * corr + pt.sum(axis=1)
            acc = acc * corr[:, None] + pt @ vt
            m = mx
        n = min(bm, sq - q0)
        out[bb, q0:q0 + n, h] = (acc / np.maximum(l, 1e-30)[:, None])[:n]
        lse[bb, h, q0:q0 + n] = (m * scale * np.float32(math.log(2))
                                 + np.log(l))[:n]
    assert not np.isnan(out).any() and not np.isnan(lse).any()
    return out, lse


def _block(n, cap=64):
    """The largest divisor of n up to cap: the Pallas kernel's block takes
    whole blocks only."""
    return max(x for x in range(1, min(n, cap) + 1) if n % x == 0)


def _lse64(shape, q, k):
    """Each row's natural-log log-sum-exp of its scaled visible scores, in
    float64."""
    b, sq, skv, hq, hkv, d, causal = shape
    kk = np.repeat(k.astype(np.float64), hq // hkv, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) / math.sqrt(d)
    s = np.where(_visible(sq, skv, causal)[None, None], s, -np.inf)
    top = s.max(axis=-1, keepdims=True)
    return (top + np.log(np.exp(s - top).sum(axis=-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("shape", EMULATED)
def test_emulated_schedule_matches_pallas_and_oracle(shape):
    """The kernel's walk, masks and base-2 online softmax in float32
    against the reference's Pallas kernel in interpret mode and its oracle
    ``flash_attention_ref``: within 1e-5 of each output's largest element;
    the lse within 1e-5 of float64's."""
    b, sq, skv, hq, hkv, d, causal = shape
    rng = np.random.default_rng(sum(shape[:6]))
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
            for _ in range(2))
    got, lse = _emulate(shape, q, k, v)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    wants = {"pallas": jops.flash_attention(
        jq, jk, jv, causal=causal, mode="interpret", block_q=_block(sq),
        block_k=_block(skv)),
        "oracle": jref.flash_attention_ref(jq, jk, jv, causal=causal)}
    for name, want in wants.items():
        want = np.asarray(want)
        err = float(np.max(np.abs(got - want)))
        assert err <= TOL * float(np.max(np.abs(want))), (name, err)
    want_lse = _lse64(shape, q, k)
    assert float(np.max(np.abs(lse - want_lse))) <= TOL * max(
        1.0, float(np.max(np.abs(want_lse))))
