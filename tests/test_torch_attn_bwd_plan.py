"""Kernel 7's bfloat16 backward on Hopper, modelled on the CPU: its tiles
(``flash_attention.bwd_plan``, against the static asserts of
``csrc/flash_attention_bwd.cu``), its walk over (batch, KV head, key
block) blocks and their query tiles (``flash_attention.bwd_walk``), the
order in which it adds dQ, the shared-memory and accumulator layouts it
writes, and a float32 emulation of the whole schedule held to ``jax.vjp``
of the reference's oracle.

The dQ order: each query tile's counter (``flash_attention.bwd_counters``)
lets a block's dQ writer add the tile's pieces only after every earlier
key block's, so each (batch, query head, query tile) takes its key blocks
in ascending order whatever the blocks' speeds.  ``_schedule`` models the
card's side of it: blocks made resident in launch order, a few at a time,
and resident blocks progressing at random, a tile's pieces added only
where its counter has reached the count ``bwd_walk`` gives; a schedule in
which every resident block waits is a deadlock.

The emulation follows the kernel tile for tile: a block's 128 keys
against one GQA head's query tile at a time, P^T recomputed from the
base-2 log-sum-exp (+inf on the pad rows past Sq), keys past Skv and past
the causal diagonal masked by index, dV and dK summed over the block's
tiles, and each tile's dQ pieces added to a float32 accumulator in the
kernel's tile layout, in an order ``_schedule`` allows.  It runs in
float32 without the bf16 roundings, so it is held to the reference within
the 1e-5 of ``test_torch_attn_grad.py``; two such orders give the same
bits.
"""
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import strategies as strat
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from test_torch_attn_grad import SHAPES, TOL, _inputs

CSRC = (pathlib.Path(fa.__file__).resolve().parent / "csrc"
        / "flash_attention_bwd.cu")
# chip_smoke.FA_BWD_SHAPES: the training shapes phase 22 runs on the card
CARD_SHAPES = [(8, 512, 512, 16, 16, 128, True),
               (8, 512, 512, 32, 8, 128, True),
               (8, 512, 512, 48, 8, 128, True),
               (8, 1500, 1500, 16, 16, 64, False),
               (8, 448, 1500, 16, 16, 64, False),
               (2, 77, 300, 6, 2, 64, True)]
# ragged Sq and Skv, GQA groups 1-6, causal and not, more than two key
# blocks a (batch, KV head), more rows than a launch group
ORDER_SHAPES = [(1, 300, 700, 3, 3, 64, True),
                (2, 130, 77, 5, 1, 128, False),
                (1, 257, 257, 8, 2, 128, True),
                (2, 129, 400, 6, 2, 64, True),
                (1, 200, 513, 6, 1, 64, False),
                (1, 65, 65, 2, 1, 128, True),
                (3, 40, 300, 12, 12, 64, True)]   # 36 rows: a ragged group
LOG2E = 1.4426950408889634


@pytest.mark.parametrize("d", fa.BWD_HEAD_DIMS)
def test_bwd_plan_fits_and_tiles_in_warpgroup_rows(d):
    """Shared bytes within a block's 232,448; query and key tiles whole
    64-row wgmma operands; one block an SM, two consumer warpgroups of 64
    keys and a producer."""
    p = fa.bwd_plan(d)
    assert p.smem_bytes <= fa.SMEM_LIMIT == 232_448
    assert p.block_m % 64 == 0 and p.block_n % 64 == 0
    assert p.block_n == 64 * p.consumers
    assert p.threads == 128 * (p.consumers + 1)
    assert p.blocks_per_sm == 1 and p.stages >= 2


def test_bwd_plan_agrees_with_the_kernels_static_asserts():
    """The C++ ``BwdTiles`` asserts the query tile and shared bytes of
    each instance; the launch refuses a plan that differs."""
    text = CSRC.read_text()
    found = dict((int(d), (int(bm), int(smem))) for d, bm, smem in re.findall(
        r"static_assert\(BwdTiles<(\d+)>::BM == (\d+) &&\s*"
        r"BwdTiles<\d+>::SMEM == (\d+)", text))
    assert sorted(found) == sorted(fa.BWD_HEAD_DIMS)
    for d, (bm, smem) in found.items():
        p = fa.bwd_plan(d)
        assert (p.block_m, p.smem_bytes) == (bm, smem)
    groups = re.findall(r"static_assert\(BwdTiles<128>::GROUP == (\d+) && "
                        r"BwdTiles<64>::GROUP == (\d+)", text)
    assert groups == [(str(fa.bwd_plan(128).group_rows),
                       str(fa.bwd_plan(64).group_rows))]
    with pytest.raises(ValueError, match="no kernel instance"):
        fa.bwd_plan(32)


def _visible(sq, skv, causal):
    """(Sq, Skv) bool: query row i sees key j."""
    if not causal:
        return np.ones((sq, skv), bool)
    return np.arange(skv)[None, :] <= np.arange(sq)[:, None] + skv - sq


def _check_walk(shape):
    b, sq, skv, hq, hkv, d, causal = shape
    p = fa.bwd_plan(d)
    walk = fa.bwd_walk(b, sq, skv, hq, hkv, d, causal)
    n_kb, rows = -(-skv // p.block_n), b * hkv
    # every (batch, KV head, key block) once: the rows in groups, a
    # group's first key blocks first, its rows fastest
    per = min(rows, p.group_rows)
    assert [blk[:3] for blk in walk] == [
        divmod(y, hkv) + (x * p.block_n,) for g0 in range(0, rows, per)
        for x in range(n_kb) for y in range(g0, min(rows, g0 + per))]
    vis = _visible(sq, skv, causal)
    group = hq // hkv
    for bb in range(b):
        for hk in range(hkv):
            blocks = [blk for blk in walk if blk[:2] == (bb, hk)]
            work = [len(blk[3]) for blk in blocks]
            assert work == sorted(work, reverse=True)    # heaviest first
            for h in range(hk * group, (hk + 1) * group):
                count = np.zeros((sq, skv), np.int32)
                for _, _, k0, tiles in blocks:
                    for th, q0, _ in tiles:
                        if th != h:
                            continue
                        tile = (slice(q0, q0 + p.block_m),
                                slice(k0, k0 + p.block_n))
                        # no tile without a visible pair is visited
                        assert vis[tile].any(), (shape, h, q0, k0)
                        count[tile] += 1
                # every visible pair in exactly one visited tile
                assert np.array_equal(count[vis], np.ones(vis.sum(), np.int32))
            # the group's heads, each over the same query tiles
            for _, _, _, tiles in blocks:
                heads = sorted({th for th, *_ in tiles})
                assert heads == list(range(hk * group, (hk + 1) * group))
                # each head's tiles from the last down
                for h in heads:
                    firsts = [q0 for th, q0, _ in tiles if th == h]
                    assert firsts == sorted(firsts, reverse=True)


@pytest.mark.parametrize("shape", SHAPES + CARD_SHAPES)
def test_bwd_walk_covers_every_visible_pair_once(shape):
    """At the gradient tests' shapes and the card's training shapes: each
    visible (query, key) pair of every (batch, query head) falls in one
    visited tile, no visited tile is fully masked (the first query tile
    of a key block is the one holding its diagonal), and a KV head's key
    blocks launch heaviest first."""
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
                draw(st.sampled_from(fa.BWD_HEAD_DIMS)), causal)

    @given(shape=_shapes())
    def test_bwd_walk_covers_every_visible_pair_once_property(shape):
        _check_walk(shape)
else:
    def test_bwd_walk_covers_every_visible_pair_once_property():
        pytest.importorskip("hypothesis")


def _schedule(walk, slots, rng):
    """One order in which the card may add the dQ pieces of ``walk``
    (``bwd_walk``'s blocks in launch order): blocks made resident in
    launch order, at most ``slots`` at a time, a finished block's slot
    taken by the next; at each step a resident block picked at random has
    its dQ writer add both pieces of its next tile, where the tile's
    counter has reached the tile's count (the counter then rises by one).
    Returns ``[(block, tile, warpgroup)]`` in add order; fails where every
    resident block waits."""
    counter = {}
    done = [0] * len(walk)
    resident, nxt, order = [], 0, []
    while resident or nxt < len(walk):
        while len(resident) < slots and nxt < len(walk):
            resident.append(nxt)
            nxt += 1
        start = int(rng.integers(len(resident)))
        for j in range(len(resident)):
            i = resident[(start + j) % len(resident)]
            bb, _, _, tiles = walk[i]
            h, q0, count = tiles[done[i]]
            if counter.get((bb, h, q0), 0) >= count:
                break
        else:
            raise AssertionError(f"deadlock: every resident block waits "
                                 f"({resident}, {len(order)} pieces added)")
        counter[bb, h, q0] = counter.get((bb, h, q0), 0) + 1
        order += [(i, done[i], w) for w in (0, 1)]
        done[i] += 1
        if done[i] == len(tiles):
            resident.remove(i)
    return order


def _visitors(walk):
    """{(batch, query head, first query): [launch index of each block that
    visits the tile, in launch order]}."""
    seen = {}
    for i, (bb, _, _, tiles) in enumerate(walk):
        for h, q0, _ in tiles:
            seen.setdefault((bb, h, q0), []).append(i)
    return seen


@pytest.mark.parametrize("slots", [1, 4, 132])
@pytest.mark.parametrize("shape", SHAPES + CARD_SHAPES + ORDER_SHAPES)
def test_dq_pieces_add_in_ascending_key_block_order(shape, slots):
    """Whatever the blocks' speeds, from one resident block to a card's
    132: no deadlock, and each warpgroup's piece of every (batch, query
    head, query tile) is added by each key block that sees the tile
    exactly once, in ascending key-block order."""
    walk = fa.bwd_walk(*shape)
    order = _schedule(walk, slots, np.random.default_rng(slots + sum(shape)))
    got = {}
    for i, t, w in order:
        bb, _, k0, tiles = walk[i]
        got.setdefault((bb,) + tiles[t][:2] + (w,), []).append(k0)
    want = {key + (w,): sorted(walk[i][2] for i in blocks)
            for key, blocks in _visitors(walk).items() for w in (0, 1)}
    assert got == want
    assert all(keys == sorted(set(keys)) for keys in got.values())


@pytest.mark.parametrize("shape", SHAPES + CARD_SHAPES + ORDER_SHAPES)
def test_dq_counts_wait_only_on_earlier_blocks(shape):
    """A block waits for its tile's counter to count every block that
    visits the tile before it in launch order: the earlier key blocks of
    its own (batch, KV head), a smaller ``blockIdx.y`` at its
    ``blockIdx.x`` and ``blockIdx.z``, all launched before it."""
    b, sq, skv, hq, hkv, d, causal = shape
    p = fa.bwd_plan(d)
    walk = fa.bwd_walk(*shape)
    n_kb, rows = -(-skv // p.block_n), b * hkv
    per = min(rows, p.group_rows)
    grid = (per, n_kb, -(-rows // per))
    visitors = _visitors(walk)
    index, last = {}, -1
    for i, (bb, hk, k0, tiles) in enumerate(walk):
        y = bb * hkv + hk
        x = k0 // p.block_n
        block = (y % per, x, y // per)                 # blockIdx x, y, z
        linear = block[0] + grid[0] * (block[1] + grid[1] * block[2])
        assert linear > last, (shape, i, block)        # in launch order
        last = linear
        index[y, x] = i
        for h, q0, count in tiles:
            before = [j for j in visitors[bb, h, q0] if j < i]
            assert count == len(before) == x, (shape, i, h, q0)
            assert before == [index[y, e] for e in range(x)]


@pytest.mark.parametrize("shape", SHAPES + ORDER_SHAPES)
def test_dq_counters_are_the_ones_the_wrapper_allocates(shape,
                                                        monkeypatch):
    """``flash_attention_bwd`` on the card path (the launch captured, not
    run) passes int32 counters of ``bwd_counters``' shape, one a (batch,
    query head, query tile of the plan's rows), beside the float32
    accumulator of those tiles; the float32 backward passes neither."""
    from repro_torch.kernels import _build

    b, sq, skv, hq, hkv, d, causal = shape
    calls = []
    monkeypatch.setattr(_build, "on_card", lambda name, device: True)
    monkeypatch.setattr(_build, "check", lambda *a: None)
    monkeypatch.setattr(_build, "launch",
                        lambda name, src, types, device, *args:
                        calls.append((types, args)))
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(shape, 3))
    o = torch.zeros_like(q)
    lse = torch.zeros((b, hq, sq))
    for dtype in (torch.bfloat16, torch.float32):
        fa.flash_attention_bwd(*(t.to(dtype) for t in (q, k, v, o, do)),
                               lse, causal=causal)
    (types, bf16), (_, f32) = calls
    n_mt = -(-sq // fa.bwd_plan(d).block_m)
    assert fa.bwd_counters(b, sq, hq, d) == (b, hq, n_mt)
    assert bf16[8].dtype == torch.int32
    assert tuple(bf16[8].shape) == fa.bwd_counters(b, sq, hq, d)
    assert tuple(bf16[7].shape) == (b, hq, n_mt * fa.bwd_plan(d).block_m, d)
    assert bf16[12:22] == (b, sq, skv, hq, hkv, d, int(causal), 1,
                           fa.bwd_plan(d).block_m, fa.bwd_plan(d).smem_bytes)
    assert len(types) == len(bf16) == 22
    assert f32[7] is None and f32[8] is None


def _piece_index(d):
    """The accumulator tile's element order (``fa_bwd_main_bf16`` writes
    it, ``fa_bwd_post_bf16`` reads it): (row, column) of the tile for
    each flat index: piece w (a consumer warpgroup's 64 x 64: D = 128 its
    64 columns, D = 64 its 64 query rows), chunk j, thread t, element e
    of the m64n64 accumulator."""
    bm = fa.bwd_plan(d).block_m
    idx = np.arange(bm * d)
    w, j, t, e = idx // 4096, (idx // 512) % 8, (idx // 4) % 128, idx % 4
    row = (64 * w if bm == 128 else 0) + 16 * (t // 32) + (t % 32) // 4 \
        + 8 * (e // 2)
    col = (64 * w if d == 128 else 0) + 8 * j + 2 * (t % 4) + e % 2
    return row, col


@pytest.mark.parametrize("d", fa.BWD_HEAD_DIMS)
def test_dq_accumulator_tile_layout_is_a_permutation(d):
    """Each (query row, column) of a BM x D tile has one place in the
    accumulator's tile layout, so the pieces of both warpgroups add into
    disjoint places and the postprocess reads each element once."""
    bm = fa.bwd_plan(d).block_m
    row, col = _piece_index(d)
    flat = row * d + col
    assert np.array_equal(np.sort(flat), np.arange(bm * d))


@pytest.mark.parametrize("d", fa.BWD_HEAD_DIMS)
def test_ds_store_is_the_swizzled_tile_without_bank_conflicts(d):
    """dS^T (keys x queries, bf16) in 128-byte-swizzled slabs of 64
    queries, as the dQ product's MN-major A operand reads it: every
    element has its own two bytes, and a warp's 4-byte store of chunk j
    hits 32 distinct banks."""
    p = fa.bwd_plan(d)
    bm, bn = p.block_m, p.block_n

    def addr(r, qcol):
        j = qcol // 8
        return ((j // 8) * bn * 128 + r * 128 + (((j % 8) ^ (r % 8)) << 4)
                + (qcol % 8) * 2)

    every = sorted(addr(r, c) for r in range(bn) for c in range(bm))
    assert every == list(range(0, 2 * bn * bm, 2))
    for j in range(bm // 8):
        for wg, warp, half in ((0, 0, 0), (1, 3, 1)):
            lanes = [(64 * wg + 16 * warp + lane // 4 + 8 * half,
                      8 * j + 2 * (lane % 4)) for lane in range(32)]
            banks = {(addr(r, c) // 4) % 32 for r, c in lanes}
            assert len(banks) == 32


def _emulate(shape, q, k, v, do, order):
    """(dq, dk, dv) by the kernel's schedule in float32 numpy, the dQ
    pieces added in ``order`` (``_schedule``'s)."""
    b, sq, skv, hq, hkv, d, causal = shape
    p = fa.bwd_plan(d)
    bm, bn, group = p.block_m, p.block_n, hq // hkv
    n_mt = -(-sq // bm)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                      return_lse=True)
    o, lse = o.numpy(), lse.numpy()
    scale = np.float32(1 / math.sqrt(d))
    scale_log2 = np.float32(LOG2E / math.sqrt(d))
    # the preprocess: lse2 (+inf past sq) and Delta, per query tile
    pad = n_mt * bm
    lse2 = np.full((b, hq, pad), np.inf, np.float32)
    lse2[:, :, :sq] = lse * np.float32(LOG2E)
    delta = np.zeros((b, hq, pad), np.float32)
    delta[:, :, :sq] = np.einsum("bqhd,bqhd->bhq", o, do)

    def rows(x, r0, n, limit):       # TMA: rows past the end read as zeros
        out = np.zeros((n,) + x.shape[1:], np.float32)
        m = max(0, min(n, limit - r0))
        out[:m] = x[r0:r0 + m]
        return out

    row_of, col_of = _piece_index(d)
    acc = np.zeros((b, hq, n_mt, bm * d), np.float32)
    pieces = {}
    dk = np.zeros((b, skv, hkv, d), np.float32)
    dv = np.zeros_like(dk)
    walk = fa.bwd_walk(b, sq, skv, hq, hkv, d, causal)
    for i, (bb, hk, k0, tiles) in enumerate(walk):
        kb = rows(k[bb, :, hk], k0, bn, skv)          # (BN, D)
        vb = rows(v[bb, :, hk], k0, bn, skv)
        dka = np.zeros((bn, d), np.float32)
        dva = np.zeros((bn, d), np.float32)
        keys = np.arange(k0, k0 + bn)[:, None]
        for t, (h, q0, _) in enumerate(tiles):
            qt = rows(q[bb, :, h], q0, bm, sq)         # (BM, D)
            dot = rows(do[bb, :, h], q0, bm, sq)
            qs = np.arange(q0, q0 + bm)[None, :]
            st = kb @ qt.T                             # S^T (BN, BM)
            pt = np.exp2(st * scale_log2 - lse2[bb, h, q0:q0 + bm])
            mask = keys >= skv
            if causal:
                mask = mask | (keys > qs + skv - sq)
            pt = np.where(mask, np.float32(0), pt)
            dst = pt * (vb @ dot.T - delta[bb, h, q0:q0 + bm])
            dva += pt @ dot
            dka += dst @ qt
            part = dst.T @ kb                          # dQ pieces (BM, D)
            pieces[i, t] = part[row_of, col_of]
        m = min(bn, skv - k0)
        dk[bb, k0:k0 + m, hk] = dka[:m] * scale
        dv[bb, k0:k0 + m, hk] = dva[:m]
    for i, t, w in order:                 # a warpgroup's 4,096 elements
        h, q0, _ = walk[i][3][t]
        piece = slice(4096 * w, 4096 * (w + 1))
        acc[walk[i][0], h, q0 // bm, piece] += pieces[i, t][piece]
    # the postprocess: back to (row, column), scaled, rows below sq
    tile = np.zeros((b, hq, n_mt, bm, d), np.float32)
    tile[:, :, :, row_of, col_of] = acc
    dq = (tile.reshape(b, hq, pad, d)[:, :, :sq] * scale).transpose(0, 2, 1, 3)
    return dq, dk, dv


def _order(shape, slots, seed):
    return _schedule(fa.bwd_walk(*shape), slots,
                     np.random.default_rng(seed))


@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_schedule_matches_jax_vjp(shape):
    """The kernel's walk, masks and dQ accumulation in float32, the dQ
    pieces added in an order the counters allow, against ``jax.vjp`` of
    the reference's ``flash_attention_ref``: within 1e-5 of each
    gradient's largest element."""
    q, k, v, do = _inputs(shape, 11 + sum(shape[:6]))
    causal = shape[6]
    got = _emulate(shape, q, k, v, do, _order(shape, 4, sum(shape[:6])))
    _, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_ref(
        q, k, v, causal=causal), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    for g, w, which in zip(got, vjp(jnp.asarray(do)), "qkv"):
        w = np.asarray(w)
        err = float(np.max(np.abs(g - w)))
        assert err <= TOL * float(np.max(np.abs(w))), (which, err)


@pytest.mark.parametrize("shape", [s for s in SHAPES + ORDER_SHAPES
                                   if s[2] > 256])
def test_emulated_dq_repeats_bit_for_bit_in_any_order_the_counters_allow(
        shape):
    """Two schedules of other speeds (one resident block; a card's 132 at
    random) add every tile's pieces in the same order, so dQ's float32
    sums agree bit for bit; the same pieces added in a shuffled order (the
    unordered reduce-adds' any finishing order) differ somewhere, at these
    shapes with three key blocks or more."""
    q, k, v, do = _inputs(shape, 5 + sum(shape[:6]))
    one = _emulate(shape, q, k, v, do, _order(shape, 1, 0))[0]
    many = _emulate(shape, q, k, v, do, _order(shape, 132, 1))[0]
    assert np.array_equal(one, many)
    order = _order(shape, 132, 1)
    shuffled = [order[i] for i in np.random.default_rng(2).permutation(
        len(order))]
    assert not np.array_equal(one, _emulate(shape, q, k, v, do, shuffled)[0])
