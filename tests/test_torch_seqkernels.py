"""Kernels 6 and 7 of the port (selective scan, flash attention) against
the JAX reference.

Inputs are made with numpy from a seed and go through both packages.  The
plain PyTorch versions (what the wrappers run on CPU tensors, and what
``chip_smoke.py`` holds the CUDA kernels to on the card) are compared with
the reference's Pallas kernels in interpret mode, its XLA paths and its
oracles, at the reference's own tolerances (``tests/test_kernels.py``:
3e-5 for attention, 4e-5 for the scan).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import flash_attention as tfa, mamba_scan as tms
from repro_torch.kernels import ops as tops

FA_TOL = dict(rtol=3e-5, atol=3e-5)
SCAN_TOL = dict(rtol=4e-5, atol=4e-5)


def _qkv(b, sq, skv, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))


def _t(*arrays):
    return tuple(torch.tensor(a) for a in arrays)


# the fp32 shapes of tests/test_kernels.py's flash-attention sweep
SWEEP = [(1, 64, 64, 4, 4, 32), (2, 128, 128, 4, 2, 32),
         (2, 64, 128, 8, 1, 16), (1, 256, 256, 2, 2, 64)]


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas_interpret(shape, causal):
    q, k, v = _qkv(*shape)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        mode="interpret", block_q=32, block_k=64))
    got = tops.flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **FA_TOL)
    oracle = np.asarray(jref.flash_attention_ref(q, k, v, causal=causal))
    np.testing.assert_allclose(got.numpy(), oracle, **FA_TOL)
    np.testing.assert_allclose(
        tops.flash_attention(*_t(q, k, v), causal=causal, mode="ref").numpy(),
        oracle, **FA_TOL)


@pytest.mark.parametrize("s", [1, 37, 300])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_xla_at_ragged_lengths(s, causal):
    """S not a multiple of any block: the TPU kernel asserts divisibility,
    the port masks by index.  The policy path's shape family (2 heads of
    width 8), against the reference's XLA path and its oracle."""
    q, k, v = _qkv(3, s, s, 2, 2, 8, seed=s)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = tops.flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **FA_TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.flash_attention_ref(q, k, v,
                                                         causal=causal)),
        **FA_TOL)


@pytest.mark.parametrize("block_k", [1, 7, 64, 1000])
def test_flash_attention_plain_is_blocking_invariant(block_k, monkeypatch):
    """The online-softmax walk gives the oracle's result at any key block,
    including blocks that split the causal diagonal, cross-length."""
    monkeypatch.setattr(tfa, "PLAIN_BLOCK_K", block_k)
    q, k, v = _qkv(2, 37, 100, 4, 2, 16, seed=1)
    for causal in (True, False):
        got = tfa.flash_attention_plain(*_t(q, k, v), causal=causal)
        np.testing.assert_allclose(
            got.numpy(),
            np.asarray(jref.flash_attention_ref(q, k, v, causal=causal)),
            **FA_TOL)


def test_flash_attention_wrapper_on_cpu_is_the_plain_version():
    q, k, v = _t(*_qkv(2, 50, 50, 2, 2, 8))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=False)
    assert tfa.flash_attention.launches == before    # no kernel on the CPU
    torch.testing.assert_close(got, tfa.flash_attention_plain(q, k, v,
                                                              causal=False))


@pytest.mark.parametrize("bad", ["head_width", "dtype", "causal_rows",
                                 "kv_heads", "shapes", "mode"])
def test_flash_attention_refuses_what_the_kernel_does_not_take(bad):
    """Refused on every device, so the CPU sees what the card would."""
    q, k, v = _t(*_qkv(1, 16, 16, 4, 2, 8))
    kw = dict(causal=False)
    if bad == "head_width":
        q, k, v = _t(*_qkv(1, 16, 16, 4, 2, 12))
    elif bad == "dtype":
        q = q.to(torch.float64)
    elif bad == "causal_rows":
        q, kw = _t(*_qkv(1, 32, 16, 4, 2, 8))[0], dict(causal=True)
    elif bad == "kv_heads":
        k, v = _t(*_qkv(1, 16, 16, 3, 3, 8))[1:]
    elif bad == "shapes":
        v = v[:, :8].contiguous()
    else:
        with pytest.raises(ValueError, match="mode"):
            tops.flash_attention(q, k, v, causal=False, mode="pallas")
        with pytest.raises(ValueError, match="cuda"):
            tops.flash_attention(q, k, v, causal=False, mode="cuda")
        return
    for fn in (tfa.flash_attention, tfa.flash_attention_plain):
        with pytest.raises(ValueError):
            fn(q, k, v, **kw)


# ---------------------------------------------------------------------------
# a numpy model of the CUDA kernel's float32 instance: 3xTF32 products
# ---------------------------------------------------------------------------


def _tf32(x):
    """float32 rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` does, by bit masks."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _tf32_part(x):
    """The TF32 value the tensor core reads from a float32 register: the
    low 13 bits ignored."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _matmul_tf32(a, b, terms):
    """a @ b from TF32 parts in float32 sums: x rounded to TF32 alone
    (``terms=1``, what TF32 products give), or the kernel's split, hi = x
    with the low 13 bits cleared and lo = x - hi as the tensor core reads
    it, lo·hi + hi·lo + hi·hi (``terms=3``)."""
    if terms == 1:
        return _tf32(a) @ _tf32(b)
    ah, bh = _tf32_part(a), _tf32_part(b)
    al, bl = _tf32_part(a - ah), _tf32_part(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _attention_tf32(q, k, v, terms):
    """The kernel's arithmetic in float32: scores from split products,
    base-2 softmax with one scale, P split again for the PV product."""
    d = q.shape[-1]
    qh, kh, vh = (np.swapaxes(t, 1, 2) for t in (q, k, v))   # (B, H, S, D)
    scale = np.float32(1.4426950408889634 / np.sqrt(d))
    s = _matmul_tf32(qh, np.swapaxes(kh, -1, -2), terms)
    m = s.max(-1, keepdims=True)
    p = np.exp2(s * scale - m * scale).astype(np.float32)
    o = _matmul_tf32(p, vh, terms) / p.sum(-1, keepdims=True)
    return np.swapaxes(o, 1, 2)


def _attention_f64(q, k, v):
    qh, kh, vh = (np.swapaxes(t, 1, 2).astype(np.float64) for t in (q, k, v))
    s = qh @ np.swapaxes(kh, -1, -2) / np.sqrt(q.shape[-1])
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.swapaxes(p @ vh / p.sum(-1, keepdims=True), 1, 2)


def _policy_qkv(n, b=2, seed=4):
    """q, k, v as the attention class makes them: tanh embeddings of
    afterstate rows through its random projections, 2 heads of 8."""
    from repro_torch.core import policy as tpol

    params = tpol.init_attention(torch.Generator().manual_seed(seed),
                                 device="cpu")
    feats = np.random.default_rng(seed).uniform(
        0.0, 1.5, (b, n, tpol.FEATURE_DIM)).astype(np.float32)
    x = tpol._attn_embed(params, torch.tensor(feats))
    return tuple((x @ params[w]).reshape(b, n, 2, 8).numpy()
                 for w in ("wq", "wk", "wv"))


def test_tf32_split_is_exact_and_its_parts_are_tf32():
    """The kernel's split: hi (low 13 bits cleared) + lo == x exactly, and
    the TF32 part the tensor core reads of lo is within 2^-20 of x; and
    TF32 rounding (the model of TF32 alone) rounds ties away from zero."""
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    hi = _tf32_part(x)
    lo = x - hi
    assert np.array_equal(hi + lo, x)
    assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert (np.abs(x - hi - _tf32_part(lo)) <= np.abs(x) * 2.0 ** -20).all()
    one, ulp = np.float32(1.0), np.float32(2.0 ** -10)   # TF32's step at 1
    assert _tf32(np.float32(1.0 + 2.0 ** -11)) == one + ulp
    assert _tf32(np.float32(-(1.0 + 2.0 ** -11))) == -(one + ulp)
    assert _tf32(np.float32(1.0 + 2.0 ** -12)) == one


@pytest.mark.parametrize("inputs", ["policy", "normal"])
def test_3xtf32_split_holds_the_float32_tolerance(inputs):
    """The float32 kernel's products as 3xTF32 stay within the reference's
    3e-5 of float64 attention, at the attention class's values and at
    chip_smoke.py's standard normal ones, (2, 1000, 2, 8); TF32 alone
    does not."""
    if inputs == "policy":
        q, k, v = _policy_qkv(1000)
    else:
        q, k, v = _qkv(2, 1000, 1000, 2, 2, 8, seed=3)
    exact = _attention_f64(q, k, v)
    err3 = np.abs(_attention_tf32(q, k, v, terms=3) - exact).max()
    err1 = np.abs(_attention_tf32(q, k, v, terms=1) - exact).max()
    assert err3 < FA_TOL["atol"] / 10, err3
    assert err1 > FA_TOL["atol"], err1


def _scan_inputs(b, s, di, n, seed=2):
    """The distributions of tests/test_kernels.py's scan sweep, in numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, di)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di)) * 0.3 - 1.0)
                  ).astype(np.float32)
    a = (-np.exp(rng.standard_normal((di, n)) * 0.3)).astype(np.float32)
    bm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, s, n)) * 0.5).astype(np.float32)
    d_skip = np.ones((di,), np.float32)
    h0 = (rng.standard_normal((b, di, n)) * 0.1).astype(np.float32)
    return x, dt, a, bm, cm, d_skip, h0


@pytest.mark.parametrize("b,s,di,n", [(1, 32, 8, 4), (2, 64, 16, 8),
                                      (1, 128, 32, 16)])
@pytest.mark.parametrize("block_s", [16, 32])
def test_mamba_scan_plain_matches_pallas_interpret(b, s, di, n, block_s):
    args = _scan_inputs(b, s, di, n)
    wy, wh = jops.mamba_scan(*(jnp.asarray(x) for x in args),
                             mode="interpret", block_d=max(di // 2, 4),
                             block_s=block_s)
    gy, gh = tops.mamba_scan(*_t(*args))
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **SCAN_TOL)
    np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **SCAN_TOL)


@pytest.mark.parametrize("s", [1, 37])
def test_mamba_scan_plain_matches_oracles_at_ragged_lengths(s):
    """Any S: no ``block_s`` divisibility (the TPU kernel asserts it)."""
    args = _scan_inputs(3, s, 8, 4, seed=s)
    wy, wh = jref.mamba_scan_ref(*(jnp.asarray(x) for x in args))
    for mode in (None, "ref"):
        gy, gh = tops.mamba_scan(*_t(*args), mode=mode)
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **SCAN_TOL)
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **SCAN_TOL)
    xla_y, xla_h = jops.mamba_scan(*(jnp.asarray(x) for x in args))
    np.testing.assert_allclose(np.asarray(xla_y), np.asarray(wy), **SCAN_TOL)
    np.testing.assert_allclose(np.asarray(xla_h), np.asarray(wh), **SCAN_TOL)


def test_mamba_scan_zero_dt_steps_leave_the_state_bit_exact():
    """``dt = 0`` on trailing steps: ``exp(0·a)·h + 0 = h`` exactly — what
    the daemon relies on to keep its pad rows out of the history carry."""
    x, dt, a, bm, cm, d_skip, h0 = _t(*_scan_inputs(2, 12, 8, 4))
    _, h_real = tms.mamba_scan_plain(x[:, :9], dt[:, :9], a, bm[:, :9],
                                     cm[:, :9], d_skip, h0)
    dt_pad = dt.clone()
    dt_pad[:, 9:] = 0.0
    _, h_pad = tms.mamba_scan_plain(x, dt_pad, a, bm, cm, d_skip, h0)
    assert torch.equal(h_pad, h_real)


@pytest.mark.parametrize("bad", ["state_size", "dtype", "h0_shape",
                                 "rank"])
def test_mamba_scan_refuses_what_the_kernel_does_not_take(bad):
    args = list(_t(*_scan_inputs(1, 8, 8, 4)))
    if bad == "state_size":
        args = list(_t(*_scan_inputs(1, 8, 8, 5)))
    elif bad == "dtype":
        args[1] = args[1].to(torch.float64)
    elif bad == "h0_shape":
        args[6] = args[6][:, :4].contiguous()
    else:
        args[0] = args[0][0]
    for fn in (tms.mamba_scan, tms.mamba_scan_plain):
        with pytest.raises(ValueError):
            fn(*args)


def test_mamba_scan_wrapper_on_cpu_is_the_plain_version():
    args = _t(*_scan_inputs(2, 20, 16, 8))
    before = tms.mamba_scan.launches
    y, h = tms.mamba_scan(*args)
    assert tms.mamba_scan.launches == before          # no kernel on the CPU
    wy, wh = tms.mamba_scan_plain(*args)
    assert torch.equal(y, wy) and torch.equal(h, wh)
