"""Kernel 6's association (csrc/mamba_scan.cu) against the JAX reference,
on the CPU.

``scan_model`` repeats the CUDA kernel's order of operations in numpy
float32 for a launch plan (``mamba_scan.scan_plan``): chunks of CH steps
with the carry passed from chunk to chunk; in a chunk, lane segments of L
steps composed in order (segment 0 from the carry), an inclusive
Hillis-Steele scan over the segments, each segment's steps run again from
the state at its start; y_t summed over a lane's SPL states, then over the
G lanes of a step by the kernel's butterfly, plus D x_t.  The kernel's
fused multiply-adds are taken in float64 and rounded once to float32
(exact but for a double rounding, which the tolerance dwarfs).  The model
is held to the reference's oracle and its Pallas kernel in interpret mode
within the kernel's 4e-5, for the plan and for every built (SPL, L);
``dt = 0`` pad rows must leave its hT bit for bit that of the truncated
sequence, and a NaN at step t must reach no earlier output.  The plan's
thread map must cover every (batch, step, channel, state) exactly once.

The backward's plan (``scan_bwd_plan``, a ``ScanBwdPlan``): every
channel walked once by one warp of one block for ragged di, the
forward's chunks wherever the forward takes a built (SPL, L), shared
bytes equal to the kernel's static asserts and two blocks an SM, and
the dB / dC partials the wrapper allocates (the launch captured on the
CPU).  Its association is held to the reference in
``tests/test_torch_scan_grad.py``.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import mamba_scan as ms

SCAN_TOL = dict(rtol=4e-5, atol=4e-5)
F32 = np.float32
# the shapes the card tests and chip_smoke.py run: the reference's sweep,
# the mamba class's path, S across the chunk edges and long, di not a
# multiple of the warps, every state size
SWEEP = [(1, 32, 8, 4), (2, 64, 16, 8), (1, 128, 32, 16)]
EDGES = [(2, s, di, n) for s in (1, 31, 33, 257) for di, n in
         ((8, 4), (200, 8), (24, 16))]


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(F32)


def scan_inputs(b, s, di, n, seed=2, decay=1.0):
    """The distributions of tests/test_kernels.py's scan sweep; ``decay``
    scales A (strong decay > 1, weak < 1)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, di)) * 0.5).astype(F32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di)) * 0.3 - 1.0)
                  ).astype(F32)
    a = (-np.exp(rng.standard_normal((di, n)) * 0.3) * decay).astype(F32)
    bm = (rng.standard_normal((b, s, n)) * 0.5).astype(F32)
    cm = (rng.standard_normal((b, s, n)) * 0.5).astype(F32)
    d_skip = np.ones((di,), F32)
    h0 = (rng.standard_normal((b, di, n)) * 0.1).astype(F32)
    return x, dt, a, bm, cm, d_skip, h0


def scan_model(x, dt, a, bm, cm, d_skip, h0, plan):
    """(y, hT) in the kernel's association for ``plan`` (float32)."""
    b, s, di = x.shape
    n = a.shape[1]
    spl, seg_len, g_lanes = plan.states, plan.seg_len, plan.lanes
    segs, ch = plan.segments, plan.chunk
    y = np.zeros((b, s, di), F32)
    h = h0.astype(F32).copy()                                 # (B, di, N)
    for t0 in range(0, s, ch):
        # the chunk as the kernel's zero-filled tiles: (B, di, SEG, L)
        # and (B, SEG, L, N)
        def tile(v, last):
            out = np.zeros((b, ch, last), F32)
            m = min(ch, s - t0)
            out[:, :m] = v[:, t0:t0 + m]
            return out.reshape(b, segs, seg_len, last)
        xs = np.moveaxis(tile(x, di), 3, 1)                   # (B, di, SEG, L)
        dts = np.moveaxis(tile(dt, di), 3, 1)
        bt, ct = tile(bm, n), tile(cm, n)                     # (B, SEG, L, N)
        u = dts * xs
        da = np.exp(dts[..., None] * a[None, :, None, None, :])
        ub = u[..., None] * bt[:, None]                 # (B, di, SEG, L, N)
        # 1. each segment's maps composed in order, segment 0 from the carry
        sa = np.ones((b, di, segs, n), F32)
        sb = np.zeros((b, di, segs, n), F32)
        sb[:, :, 0] = h
        for j in range(seg_len):
            sa = da[:, :, :, j] * sa
            sb = _fma(da[:, :, :, j], sb, ub[:, :, :, j])
        # 2. inclusive Hillis-Steele scan over the segments
        d = 1
        while d < segs:
            nb, na = sb.copy(), sa.copy()
            nb[:, :, d:] = _fma(sa[:, :, d:], sb[:, :, :-d], sb[:, :, d:])
            na[:, :, d:] = sa[:, :, d:] * sa[:, :, :-d]
            sa, sb, d = na, nb, 2 * d
        # 3. each segment's steps from the state at its start
        hs = np.concatenate([h[:, :, None], sb[:, :, :-1]], axis=2)
        yc = np.zeros((b, di, segs, seg_len), F32)
        for j in range(seg_len):
            hs = _fma(da[:, :, :, j], hs, ub[:, :, :, j])
            part = np.zeros((b, di, segs, g_lanes), F32)
            for k in range(spl):              # lane g holds states g SPL + k
                st = np.arange(g_lanes) * spl + k
                part = _fma(hs[..., st], ct[:, None, :, j][..., st], part)
            o = 1
            while o < g_lanes:                # the xor butterfly; lane 0's sum
                part = part + part[..., np.arange(g_lanes) ^ o]
                o *= 2
            yc[..., j] = _fma(xs[..., j], d_skip[None, :, None], part[..., 0])
        m = min(ch, s - t0)
        y[:, t0:t0 + m] = np.moveaxis(yc.reshape(b, di, ch), 1, 2)[:, :m]
        h = hs[:, :, segs - 1]                                # the carry
    return y, h


def _reference(args):
    wy, wh = jref.mamba_scan_ref(*(jnp.asarray(v) for v in args))
    return np.asarray(wy), np.asarray(wh)


def _assert_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **SCAN_TOL)


@pytest.mark.parametrize("shape", SWEEP + EDGES)
def test_model_of_the_plan_matches_the_reference(shape):
    args = scan_inputs(*shape, seed=sum(shape))
    plan = ms.scan_plan(shape[0], shape[2], shape[3])
    _assert_close(scan_model(*args, plan), _reference(args))


@pytest.mark.parametrize("b,s,di,n", SWEEP)
@pytest.mark.parametrize("block_s", [16, 32])
def test_model_matches_the_pallas_kernel_in_interpret_mode(b, s, di, n,
                                                           block_s):
    args = scan_inputs(b, s, di, n)
    wy, wh = jops.mamba_scan(*(jnp.asarray(v) for v in args),
                             mode="interpret", block_d=max(di // 2, 4),
                             block_s=block_s)
    _assert_close(scan_model(*args, ms.scan_plan(b, di, n)),
                  (np.asarray(wy), np.asarray(wh)))


@pytest.mark.parametrize("decay", [0.01, 30.0])
@pytest.mark.parametrize("n", ms.STATE_SIZES)
def test_model_holds_at_long_sequences_with_weak_and_strong_decay(decay, n):
    """S = 2048: with weak decay the state grows over the whole run, with
    strong decay every cumulative product of dA underflows to 0 (no
    division by one, so no NaN)."""
    args = scan_inputs(1, 2048, 8, n, seed=n, decay=decay)
    got = scan_model(*args, ms.scan_plan(1, 8, n))
    assert all(np.isfinite(v).all() for v in got)
    _assert_close(got, _reference(args))


@pytest.mark.parametrize("n,states,seg_len", ms.SCAN_BUILT)
def test_every_built_variant_matches_the_reference(n, states, seg_len):
    """Every (SPL, L) the kernel is built for, so any of them may be
    planned: S across three chunks of the longest (CH = 128) and ragged."""
    shape = (2, 300, 12, n)
    args = scan_inputs(*shape, seed=n + 10 * states + seg_len)
    plan = ms.ScanPlan.of(2, 12, n, states, seg_len, 4)
    _assert_close(scan_model(*args, plan), _reference(args))


@pytest.mark.parametrize("n_real", [1, 9, 20, 31, 37, 64, 95])
@pytest.mark.parametrize("n,states,seg_len", ms.SCAN_BUILT)
def test_zero_dt_pad_rows_leave_the_carry_bit_exact(n_real, n, states,
                                                    seg_len):
    """dt = 0 rows after ``n_real`` (the daemon's pad rows) leave hT bit
    for bit the hT of the sequence cut at ``n_real``, in one chunk or
    across several."""
    x, dt, a, bm, cm, d_skip, h0 = scan_inputs(2, 96, 8, n, seed=n_real)
    plan = ms.ScanPlan.of(2, 8, n, states, seg_len, 8)
    dt_pad = dt.copy()
    dt_pad[:, n_real:] = 0.0
    _, h_pad = scan_model(x, dt_pad, a, bm, cm, d_skip, h0, plan)
    cut = (x[:, :n_real], dt[:, :n_real], a, bm[:, :n_real], cm[:, :n_real],
           d_skip, h0)
    _, h_cut = scan_model(*cut, plan)
    assert np.array_equal(h_pad, h_cut)


@pytest.mark.parametrize("t", [0, 3, 4, 10, 31, 32, 45])
def test_nan_at_a_step_reaches_no_earlier_output(t):
    """A NaN in dt at step t: y of that channel from t on and its hT are
    NaN; no y before t and no other channel is."""
    x, dt, a, bm, cm, d_skip, h0 = scan_inputs(1, 64, 8, 4, seed=t)
    dt[0, t, 2] = np.nan
    y, h = scan_model(x, dt, a, bm, cm, d_skip, h0, ms.scan_plan(1, 8, 4))
    assert np.isnan(y[0, t:, 2]).all() and np.isnan(h[0, 2]).all()
    assert np.isfinite(y[0, :t]).all()
    assert np.isfinite(np.delete(y[0], 2, axis=1)).all()
    assert np.isfinite(np.delete(h[0], 2, axis=0)).all()


def _covered(plan, b, s, di):
    """(batch, step, channel, state) of every state element a lane of the
    plan's grid updates, as the kernel maps blocks, warps, lanes, chunks,
    segment steps and a lane's states; elements past S or di dropped."""
    n = plan.n
    gx, gy, gz = plan.grid
    assert gz == 1
    bx, by, w, lane, c, j, k = (v.ravel() for v in np.meshgrid(
        np.arange(gx), np.arange(gy), np.arange(plan.warps), np.arange(32),
        np.arange(-(-s // plan.chunk)), np.arange(plan.seg_len),
        np.arange(plan.states), indexing="ij"))
    seg, g = lane // plan.lanes, lane % plan.lanes
    ch = bx * plan.warps + w
    t = c * plan.chunk + seg * plan.seg_len + j
    st = g * plan.states + k
    keep = (t < s) & (ch < di)
    return ((by[keep] * s + t[keep]) * di + ch[keep]) * n + st[keep]


PLAN_SHAPES = [(1, 32, 8, 4), (2, 256, 1024, 16), (3, 37, 200, 4),
               (2, 64, 16, 8), (1, 1, 1, 4), (5, 33, 3, 8), (2, 129, 13, 16)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("warps", [None, 4, 16])
def test_plan_covers_every_element_exactly_once(shape, warps):
    b, s, di, n = shape
    plan = ms.scan_plan(b, di, n)
    if warps:
        plan = ms.ScanPlan.of(b, di, n, plan.states, plan.seg_len, warps)
    got = np.sort(_covered(plan, b, s, di))
    np.testing.assert_array_equal(got, np.arange(b * s * di * n))


@pytest.mark.parametrize("shape", PLAN_SHAPES + [(65535, 4, 8, 4),
                                                 (1, 8, 100000, 16)])
def test_plan_is_a_built_instance_within_the_launch_limits(shape):
    b, s, di, n = shape
    plan = ms.scan_plan(b, di, n)
    assert (n, plan.states, plan.seg_len) in ms.SCAN_BUILT
    assert 1 <= plan.warps <= ms.SCAN_MAX_WARPS
    assert plan.warps & (plan.warps - 1) == 0     # the kernel's thread map
    assert plan.grid[1] == b <= 65535 and plan.grid[0] < 2 ** 31
    assert (plan.grid[0] - 1) * plan.warps < di <= plan.grid[0] * plan.warps
    assert plan.lanes * plan.segments == 32 and plan.chunk <= 128
    assert plan.shared_bytes <= 48 * 1024        # no opt-in needed


@pytest.mark.parametrize("n,states,seg_len", ms.SCAN_BUILT)
def test_every_built_variant_fits_a_block_at_the_most_warps(n, states,
                                                            seg_len):
    plan = ms.ScanPlan.of(1, 64, n, states, seg_len, ms.SCAN_MAX_WARPS)
    assert plan.shared_bytes <= 232448


def test_plan_at_the_paths_shapes():
    """The mamba class's batch, (1, 32, 8, 4), is one block and one chunk
    of short segments: the whole input in one round trip.  The wide shape
    fills the card, about 2 blocks on each of the H100's 132 SMs, with
    long segments."""
    path = ms.scan_plan(1, 8, 4)
    assert path.blocks == 1 and path.chunk == 32
    assert (path.states, path.seg_len) == ms.SCAN_LANES_FEW[4]
    wide = ms.scan_plan(2, 1024, 16)
    assert wide.blocks >= 256
    assert (wide.states, wide.seg_len) == ms.SCAN_LANES[16]


@pytest.mark.parametrize("n", ms.STATE_SIZES)
def test_both_regimes_are_built_and_one_chunk_covers_the_paths_steps(n):
    for lanes in (ms.SCAN_LANES_FEW, ms.SCAN_LANES):
        assert (n, *lanes[n]) in ms.SCAN_BUILT
    few = ms.ScanPlan.of(1, 8, n, *ms.SCAN_LANES_FEW[n], 8)
    assert few.chunk == 32


# ---------------------------------------------------------------------------
# the backward's launch plan (csrc/mamba_scan_bwd.cu, ``scan_bwd_plan``)
# ---------------------------------------------------------------------------

BWD_CSRC = (pathlib.Path(ms.__file__).resolve().parent / "csrc"
            / "mamba_scan_bwd.cu")
BWD_BUILT = [(n, spl, seg, k) for (n, spl, seg), ks in
             sorted(ms.SCAN_BWD_BUILT.items()) for k in ks]
SM_SHARED, BLOCK_RESERVED = 233_472, 1_024      # an H100 SM's, a block's


def _bwd_channels(plan, di):
    """The channel each (block, warp, turn) of the plan's grid walks, as
    the kernel maps them (block x serves channels x R .. x R + R - 1, warp
    w its K consecutive ones in turn), those past di dropped."""
    bx, w, kc = (v.ravel() for v in np.meshgrid(
        np.arange(plan.grid[0]), np.arange(plan.warps),
        np.arange(plan.per_warp), indexing="ij"))
    ch = bx * plan.channels + w * plan.per_warp + kc
    return ch[ch < di]


@pytest.mark.parametrize("n,states,seg_len,per_warp", BWD_BUILT)
@pytest.mark.parametrize("warps", [1, 2, 4, 8])
@pytest.mark.parametrize("di", [1, 3, 37, 200, 1024])
def test_bwd_plan_covers_every_channel_exactly_once(n, states, seg_len,
                                                   per_warp, warps, di):
    """Every channel of a batch row is walked by exactly one warp of one
    block, for ragged di too (the last block's last warps idle)."""
    plan = ms.ScanBwdPlan.of(3, di, n, states, seg_len, warps, per_warp)
    np.testing.assert_array_equal(np.sort(_bwd_channels(plan, di)),
                                  np.arange(di))
    assert plan.grid[1] == 3
    assert (plan.grid[0] - 1) * plan.channels < di


@pytest.mark.parametrize("n,states,seg_len", ms.SCAN_BUILT)
def test_bwd_plan_keeps_the_forwards_chunks_at_every_built_instance(
        n, states, seg_len):
    """Wherever ``scan_plan`` takes a built (SPL, L), in either regime,
    ``scan_bwd_plan`` takes the same, so its chunks are the forward's, and
    a K it is built for."""
    few = (states, seg_len) == ms.SCAN_LANES_FEW[n]
    shapes = [(1, 8), (2, 40)] if few else [(2, 1024), (8, 8192), (512, 8)]
    for b, di in shapes:
        fwd, plan = ms.scan_plan(b, di, n), ms.scan_bwd_plan(b, di, n)
        if (fwd.states, fwd.seg_len) != (states, seg_len):
            continue
        assert (plan.states, plan.seg_len, plan.chunk) == (
            fwd.states, fwd.seg_len, fwd.chunk)
        assert plan.per_warp in ms.SCAN_BWD_BUILT[(n, states, seg_len)]
        break
    else:
        pytest.fail(f"no shape takes {(n, states, seg_len)}")


def test_bwd_shared_bytes_are_the_kernels_and_fit_two_blocks_an_sm():
    """The plan's shared bytes are ``BwdTiles::smem_floats``'s (the
    kernel's static asserts at 8 warps), the instances are
    ``SCAN_BWD_BUILT``'s, and two blocks fit an H100 SM at every warp
    count the plan may take."""
    text = BWD_CSRC.read_text()
    built = re.findall(r"X\((\d+), (\d+), (\d+), (\d+)\)", text)
    assert sorted(tuple(map(int, x)) for x in built) == BWD_BUILT
    found = {tuple(map(int, m[:4])): int(m[4]) for m in re.findall(
        r"BwdTiles<(\d+), (\d+), (\d+), (\d+)>::smem_floats\(8\) ==\s*"
        r"(\d+)", text)}
    assert sorted(found) == BWD_BUILT
    for (n, spl, seg, k), nbytes in found.items():
        assert ms.ScanBwdPlan.of(1, 4096, n, spl, seg, 8,
                                 k).shared_bytes == nbytes
        for warps in (1, 2, 4, 8):
            plan = ms.ScanBwdPlan.of(1, 4096, n, spl, seg, warps, k)
            assert 2 * (plan.shared_bytes + BLOCK_RESERVED) <= SM_SHARED


@pytest.mark.parametrize("shape", [(8, 512, 8192, 16), (2, 256, 1024, 16),
                                   (1, 32, 8, 4), (3, 77, 200, 8)])
def test_bwd_partials_are_the_ones_the_wrapper_allocates(shape,
                                                        monkeypatch):
    """``mamba_scan_bwd`` on the card path (the launch captured, not run)
    allocates the dB and dC partials at ``plan.partials(S)`` and passes
    the plan's (SPL, L, K, W, grid)."""
    from repro_torch.kernels import _build

    b, s, di, n = shape
    if b * s * di > 2 ** 22:            # falcon's: the plan alone, no tensors
        plan = ms.scan_bwd_plan(b, di, n)
        assert plan.partials(s) == (b, plan.grid[0], s, n)
        return
    calls = []
    monkeypatch.setattr(_build, "on_card", lambda name, device: True)
    monkeypatch.setattr(_build, "check", lambda *a: None)
    monkeypatch.setattr(_build, "launch",
                        lambda name, src, types, device, *args:
                        calls.append(args))
    x, dt, a, bm, cm, d_skip, h0 = (torch.from_numpy(v) for v in
                                    scan_inputs(b, s, di, n))
    _, _, states = ms.mamba_scan_plain(x, dt, a, bm, cm, d_skip, h0,
                                       return_states=True)
    ms.mamba_scan_bwd(x, dt, a, bm, cm, d_skip, states, torch.ones_like(x))
    plan = ms.scan_bwd_plan(b, di, n)
    (args,) = calls
    assert tuple(args[11].shape) == tuple(args[12].shape) == \
        plan.partials(s) == (b, plan.grid[0], s, n)
    assert args[24:30] == plan.args()
