"""Kernels 8 and 7 of the port on the LM path, against the JAX reference.

Kernel 8 (decode attention) and kernel 7 (flash attention) in bfloat16 and
at head width 128: the plain PyTorch versions (what the wrappers run on CPU
tensors, and what ``chip_smoke.py`` holds the CUDA kernels to on the card)
against the reference's Pallas kernels in interpret mode and its oracles,
on inputs made with numpy from a seed, at the reference's tolerances
(``tests/test_kernels.py``: 3e-5 in float32, 2e-2 in bfloat16).
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import (decode_attention as tda,
                                 flash_attention as tfa, ops as tops)

DTYPES = {"float32": (jnp.float32, torch.float32, np.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, ml_dtypes.bfloat16)}


def tol(name):
    return (dict(rtol=2e-2, atol=2e-2) if name == "bfloat16"
            else dict(rtol=3e-5, atol=3e-5))


def _arrays(shapes, dtype, seed):
    """Normal draws from a numpy seed, rounded to ``dtype`` once, so both
    packages see the same values."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 .astype(DTYPES[dtype][2]) for s in shapes)


def _torch(a, dtype):
    return torch.tensor(np.asarray(a, np.float32)).to(DTYPES[dtype][1])


def _np(t):
    return t.to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# kernel 8: decode attention
# ---------------------------------------------------------------------------

# the reference's sweep (tests/test_kernels.py): (B, Hq, Hkv, S, D)
DECODE_SWEEP = [(1, 4, 4, 128, 32), (2, 8, 2, 256, 64), (3, 4, 1, 512, 16)]


def _decode_inputs(b, hq, hkv, s, d, dtype, seed=0):
    return _arrays(((b, hq, d), (b, hkv, s, d), (b, hkv, s, d)), dtype, seed)


def _reference(q, k, v, kv_len, dtype):
    jd = DTYPES[dtype][0]
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    n = jnp.asarray(kv_len, jnp.int32)
    pallas = jops.decode_attention(jq, jk, jv, n, mode="interpret", block_k=64)
    return (np.asarray(pallas, np.float32),
            np.asarray(jref.decode_attention_ref(jq, jk, jv, n), np.float32))


@pytest.mark.parametrize("shape", DECODE_SWEEP)
@pytest.mark.parametrize("kv_len", [1, 17, -1, "ragged"])   # -1 = full
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_pallas_interpret(shape, kv_len, dtype):
    """The reference's sweep, plus a (B,) kv_len per row."""
    b, hq, hkv, s, d = shape
    q, k, v = _decode_inputs(*shape, dtype)
    if kv_len == "ragged":
        n = np.random.default_rng(b).integers(1, s + 1, b).astype(np.int32)
        tn = torch.tensor(n)
    else:
        n = tn = s if kv_len == -1 else kv_len
    pallas, oracle = _reference(q, k, v, n, dtype)
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    got = tops.decode_attention(tq, tk, tv, tn)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (b, hq, d)
    np.testing.assert_allclose(_np(got), pallas, **tol(dtype))
    np.testing.assert_allclose(_np(got), oracle, **tol(dtype))
    np.testing.assert_allclose(
        _np(tops.decode_attention(tq, tk, tv, tn, mode="ref")), oracle,
        **tol(dtype))


def test_decode_attention_reads_a_strided_cache_view():
    """The model's (B, S, Hkv, D) cache, permuted to (B, Hkv, S, D) without
    a copy, gives what the contiguous copy gives."""
    b, s, hkv, hq, d = 2, 128, 2, 4, 32
    q, ck, cv = _arrays(((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)),
                        "float32", 3)
    kview = torch.tensor(ck).permute(0, 2, 1, 3)
    vview = torch.tensor(cv).permute(0, 2, 1, 3)
    assert not kview.is_contiguous()
    got = tda.decode_attention(torch.tensor(q), kview, vview, 50)
    want, _ = _reference(q, ck.transpose(0, 2, 1, 3), cv.transpose(0, 2, 1, 3),
                         50, "float32")
    np.testing.assert_allclose(got.numpy(), want, **tol("float32"))


def test_decode_attention_kv_len_zero_gives_zeros_as_the_pallas_kernel():
    """kv_len = 0: the TPU kernel's acc / max(l, 1e-30) is 0; the
    reference's oracle gives the mean of V.  The port follows the kernel."""
    q, k, v = _decode_inputs(2, 4, 2, 64, 16, "float32", seed=4)
    pallas, oracle = _reference(q, k, v, 0, "float32")
    got = tda.decode_attention(*(torch.tensor(a) for a in (q, k, v)), 0)
    np.testing.assert_array_equal(got.numpy(), np.zeros_like(pallas))
    np.testing.assert_array_equal(pallas, np.zeros_like(pallas))
    np.testing.assert_allclose(
        oracle, np.broadcast_to(v.mean(axis=2).repeat(2, axis=1), oracle.shape),
        rtol=1e-5, atol=1e-5)
    # one row empty, one full, in one call
    got = tda.decode_attention(*(torch.tensor(a) for a in (q, k, v)),
                               torch.tensor([0, 64], dtype=torch.int32))
    np.testing.assert_array_equal(got[0].numpy(), np.zeros((4, 16), np.float32))
    np.testing.assert_allclose(got[1].numpy(),
                               _reference(q, k, v, 64, "float32")[0][1],
                               **tol("float32"))


def test_decode_attention_wrapper_on_cpu_is_the_plain_version():
    q, k, v = (torch.tensor(a) for a in _decode_inputs(2, 4, 2, 64, 16,
                                                        "float32"))
    before = tda.decode_attention.launches
    got = tda.decode_attention(q, k, v, 40)
    assert tda.decode_attention.launches == before    # no kernel on the CPU
    torch.testing.assert_close(got, tda.decode_attention_plain(q, k, v, 40))


@pytest.mark.parametrize("bad", ["e5m2", "mixed", "head_width", "kv_heads",
                                 "shapes", "kv_len", "mode"])
def test_decode_attention_refuses_what_the_kernel_does_not_take(bad):
    """Refused on every device, so the CPU sees what the card would.  A
    float8_e4m3fn cache is taken (below); float8_e5m2 is not."""
    q, k, v = (torch.tensor(a) for a in _decode_inputs(1, 4, 2, 32, 16,
                                                        "float32"))
    n = 8
    if bad == "e5m2":
        k, v = k.to(torch.float8_e5m2), v.to(torch.float8_e5m2)
    elif bad == "mixed":
        k = k.to(torch.bfloat16)
    elif bad == "head_width":
        q, k, v = q[..., :12], k[..., :12], v[..., :12]
    elif bad == "kv_heads":
        k, v = k[:, :1].expand(1, 3, 32, 16), v[:, :1].expand(1, 3, 32, 16)
    elif bad == "shapes":
        v = v[:, :, :16]
    elif bad == "kv_len":
        n = torch.tensor([1.0])
    else:
        with pytest.raises(ValueError, match="mode"):
            tops.decode_attention(q, k, v, n, mode="pallas")
        with pytest.raises(ValueError, match="cuda"):
            tops.decode_attention(q, k, v, n, mode="cuda")
        return
    for fn in (tda.decode_attention, tda.decode_attention_plain):
        with pytest.raises(ValueError):
            fn(q, k, v, n)


# an e4m3 cache (the reference's cache_dtype="float8_e4m3fn") at the GQA
# groups of src/repro/configs: q in bfloat16 or float32, (B, Hq, Hkv, S, D)
E4M3_GROUPS = [6, 8, 12, 16]


@pytest.mark.parametrize("group", E4M3_GROUPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_takes_an_e4m3_cache(group, dtype):
    """k, v in float8_e4m3fn (the same bits in both packages, through
    ml_dtypes), q in bfloat16 or float32, a ragged kv_len holding 0: the
    plain version and ``mode="ref"`` against the Pallas kernel in
    interpret mode and the reference's oracle (which cast the cache to
    float32, exactly, as the plain version does)."""
    b, hkv, s, d = 3, 2, 128, 32
    hq = group * hkv
    q, k, v = _arrays(((b, hq, d), (b, hkv, s, d), (b, hkv, s, d)),
                      dtype, group)
    k8, v8 = (a.astype(np.float32).astype(ml_dtypes.float8_e4m3fn)
              for a in (k, v))
    n = np.array([0, 77, s], np.int32)
    jd = DTYPES[dtype][0]
    jq = jnp.asarray(q, jd)
    jk, jv = (jnp.asarray(a) for a in (k8, v8))
    assert jk.dtype == jnp.float8_e4m3fn
    pallas = np.asarray(jops.decode_attention(jq, jk, jv, jnp.asarray(n),
                                              mode="interpret", block_k=64),
                        np.float32)
    oracle = np.asarray(jref.decode_attention_ref(jq, jk, jv, jnp.asarray(n)),
                        np.float32)
    tq = _torch(q, dtype)
    tk, tv = (torch.from_numpy(a.view(np.uint8).copy()).view(
        torch.float8_e4m3fn) for a in (k8, v8))
    np.testing.assert_array_equal(tk.to(torch.float32).numpy(),
                                  k8.astype(np.float32))
    got = tops.decode_attention(tq, tk, tv, torch.tensor(n))
    assert got.dtype == DTYPES[dtype][1] and got.shape == (b, hq, d)
    np.testing.assert_allclose(_np(got), pallas, **tol(dtype))
    np.testing.assert_allclose(_np(got)[1:], oracle[1:], **tol(dtype))
    np.testing.assert_array_equal(_np(got)[0], np.zeros((hq, d), np.float32))
    np.testing.assert_allclose(
        _np(tops.decode_attention(tq, tk, tv, torch.tensor(n), mode="ref")),
        oracle, **tol(dtype))


# the capacities of the path's instances on an H100 (132 SMs; the clusters
# of 1..8 blocks cudaOccupancyMaxActiveClusters gives, PERF.md): bfloat16
# or float8 cache at D = 128 (one block of 8 warps an SM), bfloat16 at
# D = 64 (two); tile = 8 warps x 16 keys
H100_D128 = (132, 66, 39, 30, 22, 17, 15, 15)
H100_D64 = (264, 132, 79, 62, 47, 39, 32, 30)


def _cap(clusters):
    return tda.Capacity(128, clusters, 132)


# plan(B, Hq, Hkv, S, kv_len, capacity) -> (chunks, splits) at the paths'
# shapes (the same for a bfloat16 and a float8 cache: their D = 128
# instances hold the same clusters)
@pytest.mark.parametrize("case", [
    ((8, 16, 16, 544, 543, H100_D128), (1, 1)),        # OLMo-1B decode
    ((8, 16, 16, 32768, 32768, H100_D128), (1, 1)),    # OLMo, 32k
    ((8, 32, 8, 32768, 32768, H100_D128), (1, 2)),     # granite 32k
    ((8, 32, 8, 544, 543, H100_D128), (1, 2)),         # granite decode
    ((8, 48, 8, 544, 543, H100_D128), (1, 2)),         # dbrx's 6:1 decode
    ((8, 16, 16, 1500, 1500, H100_D64), (1, 1)),       # whisper's cross cache
    ((2, 128, 8, 4096, 4096, H100_D128), (1, 6)),      # 16:1 GQA
    ((1, 8, 1, 4096, 4096, H100_D128), (1, 8)),        # one pair
    ((4, 32, 8, 32768, 32768, H100_D128), (1, 3)),     # 30 clusters of 4
    ((4, 96, 2, 300, 300, H100_D128), (3, 2)),         # 48:1 (3 chunks)
    ((8, 16, 16, 544, 0, H100_D128), (1, 1)),          # nothing to attend to
    ((1, 4, 4, 128, 17, H100_D128), (1, 1)),           # shorter than a tile
])
def test_decode_attention_launch_plan(case):
    """Query-head chunks and key splits at the paths' shapes on an H100's
    capacities."""
    (b, hq, hkv, s, n, clusters), want = case
    p = tda.plan(b, hq, hkv, s, n, _cap(clusters))
    assert (p.chunks, p.splits) == want
    assert p.span == min(n, s) and p.pairs == b * hkv * p.chunks


def _plan_cover(p, b, hq, hkv):
    """A numpy model of the kernel's grid: for each block (pair, rank) the
    query heads and keys it takes, counted per (batch, query head, key)."""
    group = hq // hkv
    cover = np.zeros((b, hq, max(p.span, 1)), np.int64)
    lengths = []
    for blk in range(p.blocks):
        pair, rank = divmod(blk, p.splits)
        pair, c = divmod(pair, p.chunks)
        bb, hk = divmod(pair, hkv)
        h0 = hk * group + c * tda.ROWS
        rows = min(tda.ROWS, group - c * tda.ROWS)
        t0 = rank * p.span // p.splits
        t1 = (rank + 1) * p.span // p.splits
        cover[bb, h0:h0 + rows, t0:t1] += 1
        lengths.append(t1 - t0)
    return cover, lengths


@pytest.mark.parametrize("shape", [
    (8, 16, 16, 544), (8, 32, 8, 32768), (8, 48, 8, 544), (8, 16, 16, 1500),
    (2, 128, 8, 4096), (3, 4, 1, 512), (1, 40, 2, 1000), (5, 96, 4, 300),
    (1, 8, 8, 65), (2, 12, 1, 130)])
@pytest.mark.parametrize("clusters", [H100_D128, H100_D64,
                                      (8, 4, 2, 2, 1, 1, 1, 1)])
def test_decode_attention_plan_covers_every_key_once(shape, clusters):
    """Every (batch, query head, key) below the span lies in exactly one
    block; at most CLUSTER_MAX splits a cluster; no split shorter than a
    tile; and a split grid is one wave: at most a block an SM, and no more
    clusters than the card holds at once."""
    b, hq, hkv, s = shape
    cap = _cap(clusters)
    for n in sorted({0, 1, 127, 128, 300, s // 2, s - 1, s}):
        n = max(0, min(n, s))
        p = tda.plan(b, hq, hkv, s, n, cap)
        assert 1 <= p.splits <= tda.CLUSTER_MAX
        assert p.chunks * tda.ROWS >= hq // hkv > (p.chunks - 1) * tda.ROWS
        cover, lengths = _plan_cover(p, b, hq, hkv)
        assert (cover[:, :, :n] == 1).all() and (cover[:, :, n:] == 0).all()
        if p.splits > 1:
            assert min(lengths) >= cap.tile
            assert p.blocks <= cap.sms
            assert p.pairs <= clusters[p.splits - 1]


# ---------------------------------------------------------------------------
# kernel 7 in bfloat16 and at D = 128
# ---------------------------------------------------------------------------

# the reference's sweep (tests/test_kernels.py) in bfloat16, and head width
# 128 (the LM prefill's) in both dtypes: (B, Sq, Skv, Hq, Hkv, D), dtype.
# The float32 sweep is in tests/test_torch_seqkernels.py.
SWEEP = [(1, 64, 64, 4, 4, 32), (2, 128, 128, 4, 2, 32),
         (2, 64, 128, 8, 1, 16), (1, 256, 256, 2, 2, 64)]
D128 = (2, 64, 96, 4, 2, 128)
FLASH_CASES = ([(shape, "bfloat16") for shape in SWEEP]
               + [(D128, "bfloat16"), (D128, "float32")])
# The plain version against the Pallas kernel: both keep the probabilities
# in float32 for the PV product (the Pallas kernel's v is float32 by then),
# so in bfloat16 they differ by the order of float32 sums and at most one
# rounding of the bfloat16 output (9.8e-4 at most over these cases).
PALLAS_TOL = {"bfloat16": dict(rtol=2e-3, atol=2e-3),
              "float32": dict(rtol=3e-5, atol=3e-5)}


@pytest.mark.parametrize("shape,dtype", FLASH_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_bf16_and_d128_match_pallas_interpret(
        shape, dtype, causal):
    b, sq, skv, hq, hkv, d = shape
    q, k, v = _arrays(((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)),
                      dtype, sum(shape))
    jd = DTYPES[dtype][0]
    jq, jk, jv = (jnp.asarray(a, jd) for a in (q, k, v))
    want = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal,
                                           mode="interpret", block_q=32,
                                           block_k=32), np.float32)
    got = tfa.flash_attention(*(_torch(a, dtype) for a in (q, k, v)),
                              causal=causal)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(got), want, **PALLAS_TOL[dtype])
    oracle = np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=causal),
                        np.float32)
    np.testing.assert_allclose(_np(got), oracle, **tol(dtype))


def test_flash_attention_rows_per_block():
    """mma.sync (float32 at every width, bfloat16 below D = 64): 4 warps of
    16 query rows and a two-stage ring of K/V tiles, of 32 keys in
    bfloat16 and 64 in float32.  wgmma (bfloat16 at D in {64, 128}, every
    LM path): three warpgroups over 128 query rows and a two-stage TMA ring
    of ``fwd_plan``'s K/V tiles."""
    for d in tfa.HEAD_DIMS:
        for dtype, keys in ((torch.bfloat16, 32), (torch.float32, 64)):
            p = tfa.plan(d, dtype)
            wgmma = dtype == torch.bfloat16 and d in tfa.WGMMA_HEAD_DIMS
            assert p.design == ("wgmma" if wgmma else "mma.sync")
            if wgmma:
                assert (p.threads, p.rows, p.keys, p.stages) == (
                    384, 128, tfa.fwd_plan(d).block_n, 2)
            else:
                assert (p.threads, p.rows, p.keys, p.stages) == (128, 64,
                                                                 keys, 2)


PLAN_CASES = [(d, dtype) for d in tfa.HEAD_DIMS
              for dtype in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("d,dtype", PLAN_CASES)
def test_flash_attention_plan_fits_shared_memory(d, dtype):
    """Dynamic shared bytes within a block's 232,448.  mma.sync: the Q
    tile and the K/V ring, rows whole 16-byte chunks (cp.async and
    ldmatrix) that hold a row of D elements.  wgmma: ``fwd_plan``'s, rows
    of 64-column slabs in TMA's 128-byte swizzle."""
    p = tfa.plan(d, dtype)
    assert p.smem_bytes <= tfa.SMEM_LIMIT == 232_448
    if p.design == "wgmma":
        assert p.smem_bytes == tfa.fwd_plan(d).smem_bytes and p.pitch == 128
    else:
        assert p.smem_bytes == p.pitch * (p.rows + 2 * p.stages * p.keys)
        assert p.pitch % 16 == 0 and p.pitch >= d * dtype.itemsize


def test_flash_attention_plan_at_the_paths_widths():
    """The LM paths' bf16 D = 128 takes 197,696 bytes (one block an SM),
    D = 64 66,624 (two); the policy class's float32 D = 8 15,360."""
    assert tfa.plan(128, torch.bfloat16).smem_bytes == 197_696
    assert tfa.plan(64, torch.bfloat16).smem_bytes == 66_624
    assert tfa.plan(128, torch.float32).smem_bytes == 168_960
    assert tfa.plan(8, torch.float32).smem_bytes == 15_360
    with pytest.raises(ValueError, match="no kernel instance"):
        tfa.plan(12, torch.float32)
    with pytest.raises(ValueError, match="no kernel instance"):
        tfa.plan(8, torch.float16)


def _banks(words):
    """The 32 four-byte shared-memory banks a set of word addresses hits;
    a warp's access without conflicts hits each bank at most once."""
    banks = [w % 32 for w in words]
    return len(banks) == len(set(banks))


@pytest.mark.parametrize("d", tfa.HEAD_DIMS)
def test_flash_attention_tile_rows_avoid_bank_conflicts(d):
    """bf16 on mma.sync: ldmatrix reads one 16-byte chunk of 8 consecutive
    rows, so the 8 must fall in 8 distinct 16-byte bank groups; on wgmma
    (TMA's 128-byte swizzle, 8 rows an atom of 1,024 bytes) the Q tile,
    every K and V stage and the output's staging tile start on an atom.  float32: a warp's
    K-fragment read (key g, dim tig) and V-fragment read (key 2 tig, dim
    g), g < 8 and tig < 4, must hit 32 distinct banks."""
    bp = tfa.plan(d, torch.bfloat16)
    if bp.design == "wgmma":
        fp = tfa.fwd_plan(d)
        tiles = ([fp.block_m * d * 2] * 2
                 + [fp.block_n * d * 2] * (2 * fp.stages))
        assert all(t % 1024 == 0 for t in tiles) and bp.pitch == 128
    else:
        assert len({(r * bp.pitch // 16) % 8 for r in range(8)}) == 8
    pf = tfa.plan(d, torch.float32).pitch // 4
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    assert _banks([g * pf + tig for g, tig in lanes])
    assert _banks([2 * tig * pf + g for g, tig in lanes])
    assert _banks([(2 * tig + 1) * pf + g for g, tig in lanes])


@pytest.mark.parametrize("sq,skv", [(1, 1), (64, 64), (65, 130), (512, 512),
                                    (5000, 5000), (100, 4096)])
def test_flash_attention_query_blocks_run_heaviest_first(sq, skv):
    """The launch order visits every query block once, and under causal
    the keys a block sees never grow along it."""
    rows = tfa.plan(128, torch.bfloat16).rows
    n = -(-sq // rows)
    order = tfa.query_block_order(n)
    assert sorted(order) == list(range(n))
    seen = [min(skv, min(sq, (y + 1) * rows) + skv - sq) for y in order]
    assert seen == sorted(seen, reverse=True)
