"""Kernel 6's backward (csrc/mamba_scan_bwd.cu) and its plain twins against
the JAX reference's gradients, on the CPU.

The reference trains through XLA's autodiff of its chunked scan
(``repro.models.mamba.selective_scan``); its oracle is
``repro.kernels.ref.mamba_scan_ref``.  The port's gradients are held to
``jax.vjp`` of both, within 1e-5 of each gradient's largest element (as
``tests/test_torch_lm_train.py`` measures a leaf): the port sums in
another order (step by step, or in the kernel's association, against a
chunked associative scan).

* ``mamba_scan_bwd_plain``'s seven gradients, with h0 and dhT nonzero and
  dhT absent, at every state size;
* the chunk states of ``mamba_scan_plain(..., return_states=True)``
  against the reference's state at each chunk edge;
* ``scan_bwd_model``: the backward kernel's association in numpy float32
  for a launch plan (``scan_bwd_plan``): chunks walked from the last to
  the first with P = dA G carried between them; in a chunk, each
  segment's forward maps and its reverse maps composed in forward order,
  an inclusive Hillis-Steele scan over the segments for each (up and
  down), the states rerun from each segment's start, the steps run
  again in reverse; sums over a lane's SPL states, then over the G lanes
  by the kernel's butterfly; dB and dC summed over a warp's K channels by
  fused multiply-adds, then over a block's warps and over the blocks, in
  order; dA and dD over the segments by a butterfly a chunk, then over
  the chunks and the batch rows;
* ``MambaScanFn.apply`` on CPU tensors (its plain twins) against autograd
  of ``mamba_scan_plain``, the gradient reaching ``A_log`` through ``a =
  -exp(A_log)`` included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import mamba as jmamba
from repro_torch.kernels import mamba_scan as ms, ops
from repro_torch.models import mamba as tmamba
from test_torch_scan_plan import _fma, scan_inputs, scan_model

TOL = 1e-5
F32 = np.float32
NAMES = ("dx", "ddt", "da", "dbmat", "dcmat", "dd_skip", "dh0")


def grad_inputs(b, s, di, n, seed=3, dht=True):
    """``scan_inputs`` (the reference's sweep distributions, D not one)
    with dy and dhT (None when ``dht`` is False)."""
    x, dt, a, bm, cm, d_skip, h0 = scan_inputs(b, s, di, n, seed=seed)
    rng = np.random.default_rng(seed + 1000)
    d_skip = (1.0 + rng.standard_normal(di) * 0.1).astype(F32)
    dy = (rng.standard_normal((b, s, di)) * 0.5).astype(F32)
    dh = (rng.standard_normal((b, di, n)) * 0.5).astype(F32) if dht else None
    return (x, dt, a, bm, cm, d_skip, h0), dy, dh


def reference_grads(fn, args, dy, dht):
    """``jax.vjp`` of ``fn`` at ``args`` for (dy, dhT), dhT zero if None."""
    _, vjp = jax.vjp(fn, *(jnp.asarray(v) for v in args))
    dh = np.zeros_like(args[6]) if dht is None else dht
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dh)))]


def _selective_scan(s):
    """The reference's training scan with a chunk that divides S."""
    chunk = max(c for c in (64, 32, 16, 8, 4, 2, 1) if s % c == 0)
    return lambda *args: jmamba.selective_scan(*args, chunk=chunk)


def _t(*arrays):
    return tuple(None if v is None else torch.from_numpy(np.ascontiguousarray(v))
                 for v in arrays)


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def assert_grads_close(got, want, what):
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w, F32)
        err = float(np.max(np.abs(_np(g) - w)))
        scale = max(float(np.max(np.abs(w))), 1e-30)
        assert err <= TOL * scale, (what, name, err, scale)


def _plain_states(args):
    _, _, states = ms.mamba_scan_plain(*_t(*args), return_states=True)
    return states


# ---------------------------------------------------------------------------
# (a) the plain backward against jax.vjp of the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", ms.STATE_SIZES)
@pytest.mark.parametrize("dht", [True, False])
@pytest.mark.parametrize("b,s,di", [(2, 64, 12), (1, 96, 8), (3, 32, 20)])
def test_plain_backward_matches_vjp_of_selective_scan(b, s, di, n, dht):
    args, dy, dh = grad_inputs(b, s, di, n, seed=b + s + di + n, dht=dht)
    want = reference_grads(_selective_scan(s), args, dy, dh)
    got = ms.mamba_scan_bwd_plain(*_t(*args[:6]), _plain_states(args),
                                  *_t(dy, dh))
    assert_grads_close(got, want, ("selective_scan", b, s, di, n, dht))


@pytest.mark.parametrize("n", ms.STATE_SIZES)
@pytest.mark.parametrize("dht", [True, False])
@pytest.mark.parametrize("b,s,di", [(2, 37, 12), (1, 1, 8), (2, 130, 5)])
def test_plain_backward_matches_vjp_of_the_oracle(b, s, di, n, dht):
    """Ragged S, a single step, across chunk edges."""
    args, dy, dh = grad_inputs(b, s, di, n, seed=7 * s + n, dht=dht)
    want = reference_grads(jref.mamba_scan_ref, args, dy, dh)
    got = ms.mamba_scan_bwd_plain(*_t(*args[:6]), _plain_states(args),
                                  *_t(dy, dh))
    assert_grads_close(got, want, ("mamba_scan_ref", b, s, di, n, dht))


def test_plain_backward_leaves_dh0_out_when_not_asked():
    args, dy, dh = grad_inputs(1, 16, 8, 4)
    got = ms.mamba_scan_bwd_plain(*_t(*args[:6]), _plain_states(args),
                                  *_t(dy, dh), need_dh0=False)
    assert got[6] is None and len(got) == 7


# ---------------------------------------------------------------------------
# (b) the chunk states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 130, 12, 4), (1, 64, 8, 16),
                                   (3, 33, 200, 8), (2, 200, 1024, 16)])
def test_chunk_states_are_the_reference_state_at_each_chunk_edge(shape):
    """The few-blocks regime's chunks of 32 steps and the wide one's 64."""
    b, s, di, n = shape
    args, _, _ = grad_inputs(b, s, di, n, seed=s)
    y, h_t, states = ms.mamba_scan_plain(*_t(*args), return_states=True)
    chunk = ms.scan_plan(b, di, n).chunk
    assert states.shape == (b, -(-s // chunk), di, n)
    np.testing.assert_array_equal(states[:, 0].numpy(), args[6])
    for c in range(1, states.shape[1]):
        cut = tuple(v[:, :c * chunk] if v.ndim == 3 and v.shape[1] == s
                    else v for v in args)
        _, want = jref.mamba_scan_ref(*(jnp.asarray(v) for v in cut))
        np.testing.assert_allclose(states[:, c].numpy(), np.asarray(want),
                                   rtol=4e-5, atol=4e-5)
    wy, wh = jref.mamba_scan_ref(*(jnp.asarray(v) for v in args))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=4e-5, atol=4e-5)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(wh), rtol=4e-5,
                               atol=4e-5)


# ---------------------------------------------------------------------------
# (c) the backward kernel's association
# ---------------------------------------------------------------------------

def _lane_dot(u, v, spl, lanes):
    """sum_n u v as the kernel takes it: each of the G lanes sums its SPL
    states in order by fused multiply-adds, then the xor butterfly."""
    part = np.zeros(u.shape[:-1] + (lanes,), F32)
    for k in range(spl):
        st = np.arange(lanes) * spl + k
        part = _fma(u[..., st], v[..., st], part)
    o = 1
    while o < lanes:
        part = part + part[..., np.arange(lanes) ^ o]
        o *= 2
    return part[..., 0]


def _butterfly(v, axis):
    """The xor butterfly over ``axis`` (a power of two long); its index 0."""
    v = np.moveaxis(v, axis, 0)
    o = 1
    while o < v.shape[0]:
        v = v + v[np.arange(v.shape[0]) ^ o]
        o *= 2
    return v[0]


def scan_bwd_model(x, dt, a, bm, cm, d_skip, states, dy, dht, plan):
    """The seven gradients in the backward kernel's association for
    ``plan`` (``scan_bwd_plan``, a ``ScanBwdPlan``), numpy float32."""
    b, s, di = x.shape
    n = a.shape[1]
    spl, seg_len, lanes = plan.states, plan.seg_len, plan.lanes
    segs, ch, nbx = plan.segments, plan.chunk, plan.grid[0]
    warps, per_warp = plan.warps, plan.per_warp
    dx = np.zeros((b, s, di), F32)
    ddt = np.zeros((b, s, di), F32)
    db_part = np.zeros((b, nbx, s, n), F32)
    dc_part = np.zeros((b, nbx, s, n), F32)
    da_tot = np.zeros((b, di, n), F32)
    dd_tot = np.zeros((b, di), F32)
    carry = np.zeros((b, di, n), F32) if dht is None else dht.copy()
    for c in range(-(-s // ch) - 1, -1, -1):
        t0, m = c * ch, min(ch, s - c * ch)

        def tile(v, last):
            out = np.zeros((b, ch, last), F32)
            out[:, :m] = v[:, t0:t0 + m]
            return out.reshape(b, segs, seg_len, last)
        xs, dts, dys = (np.moveaxis(tile(v, di), 3, 1) for v in (x, dt, dy))
        bt, ct = tile(bm, n), tile(cm, n)                  # (B, SEG, L, N)
        u = dts * xs                                       # (B, di, SEG, L)
        da = np.exp(dts[..., None] * a[None, :, None, None, :])
        ub = u[..., None] * bt[:, None]                # (B, di, SEG, L, N)
        ec = dys[..., None] * ct[:, None]              # dy_t C_t
        hc = states[:, c]
        # A. the forward maps and the reverse maps, both composed in
        # forward order, and the scans over the segments
        sa = np.ones((b, di, segs, n), F32)
        sb = np.zeros((b, di, segs, n), F32)
        sb[:, :, 0] = hc
        rb = np.zeros((b, di, segs, n), F32)
        for j in range(seg_len):
            sa = da[:, :, :, j] * sa
            sb = _fma(da[:, :, :, j], sb, ub[:, :, :, j])
            rb = _fma(sa, ec[:, :, :, j], rb)
        ra = sa.copy()
        rb[:, :, segs - 1] = _fma(ra[:, :, segs - 1], carry,
                                  rb[:, :, segs - 1])
        d = 1
        while d < segs:
            nb, na = sb.copy(), sa.copy()
            nb[:, :, d:] = _fma(sa[:, :, d:], sb[:, :, :-d], sb[:, :, d:])
            na[:, :, d:] = sa[:, :, d:] * sa[:, :, :-d]
            sa, sb = na, nb
            nb, na = rb.copy(), ra.copy()
            nb[:, :, :-d] = _fma(ra[:, :, :-d], rb[:, :, d:], rb[:, :, :-d])
            na[:, :, :-d] = ra[:, :, :-d] * ra[:, :, d:]
            ra, rb, d = na, nb, 2 * d
        h_in = np.concatenate([hc[:, :, None], sb[:, :, :-1]], axis=2)
        v = np.concatenate([rb[:, :, 1:], carry[:, :, None]], axis=2)
        # B. the states again, from each segment's start
        hs, h = [], h_in
        for j in range(seg_len):
            h = _fma(da[:, :, :, j], h, ub[:, :, :, j])
            hs.append(h)
        # C. the steps in reverse
        gks = np.zeros((b, di, segs, seg_len, n), F32)
        dxc = np.zeros((b, di, segs, seg_len), F32)
        ddtc = np.zeros((b, di, segs, seg_len), F32)
        da_acc = np.zeros((b, di, segs, n), F32)
        dd_acc = np.zeros((b, di, segs), F32)
        for j in range(seg_len - 1, -1, -1):
            hp = hs[j - 1] if j else h_in
            dtj, xj, dyj = dts[:, :, :, j], xs[:, :, :, j], dys[:, :, :, j]
            gk = _fma(dyj[..., None], ct[:, None, :, j], v)
            pk = da[:, :, :, j] * gk
            gb = _lane_dot(gk, np.broadcast_to(bt[:, None, :, j], gk.shape),
                           spl, lanes)
            gah = _lane_dot(pk * a[None, :, None, :], hp, spl, lanes)
            da_acc = _fma(pk * dtj[..., None], hp, da_acc)
            gks[:, :, :, j] = gk
            v = pk
            dxc[..., j] = _fma(d_skip[None, :, None], dyj, dtj * gb)
            ddtc[..., j] = _fma(xj, gb, gah)
            dd_acc = _fma(dyj, xj, dd_acc)
        dx[:, t0:t0 + m] = np.moveaxis(dxc.reshape(b, di, ch), 1, 2)[:, :m]
        ddt[:, t0:t0 + m] = np.moveaxis(ddtc.reshape(b, di, ch), 1, 2)[:, :m]
        # dA and dD: each chunk's sum over the segments, then the chunks
        da_tot = da_tot + _butterfly(da_acc, 2)
        dd_tot = dd_tot + _butterfly(dd_acc, 2)
        carry = v[:, :, 0]
        # dB and dC: a warp's channels in order into its slab (fused
        # multiply-adds), the block's warps' slabs summed in order
        gu = np.moveaxis(gks.reshape(b, di, ch, n), 1, 2)[:, :m]
        us = np.moveaxis(u.reshape(b, di, ch), 1, 2)[:, :m, :, None]
        dyt = np.moveaxis(dys.reshape(b, di, ch), 1, 2)[:, :m, :, None]
        hst = np.moveaxis(np.stack(hs, axis=3).reshape(b, di, ch, n), 1,
                          2)[:, :m]
        for bx in range(nbx):
            slabs_b, slabs_c = [], []
            for w in range(warps):
                sb_, sc_ = np.zeros((b, m, n), F32), np.zeros((b, m, n), F32)
                for kc in range(per_warp):
                    chan = bx * warps * per_warp + w * per_warp + kc
                    if chan < di:
                        sb_ = _fma(gu[:, :, chan], us[:, :, chan], sb_)
                        sc_ = _fma(dyt[:, :, chan], hst[:, :, chan], sc_)
                slabs_b.append(sb_)
                slabs_c.append(sc_)
            tb, tc = slabs_b[0], slabs_c[0]
            for w in range(1, warps):
                tb, tc = tb + slabs_b[w], tc + slabs_c[w]
            db_part[:, bx, t0:t0 + m], dc_part[:, bx, t0:t0 + m] = tb, tc
    dbm, dcm = np.zeros((b, s, n), F32), np.zeros((b, s, n), F32)
    for bx in range(nbx):
        dbm, dcm = dbm + db_part[:, bx], dcm + dc_part[:, bx]
    dA, dD = np.zeros((di, n), F32), np.zeros((di,), F32)
    for bb in range(b):
        dA, dD = dA + da_tot[bb], dD + dd_tot[bb]
    return dx, ddt, dA, dbm, dcm, dD, carry


# S across the chunk edges (the few-blocks regime's CH = 32, the wide
# one's 64 and 128), ragged, one step; di not a multiple of the warps
MODEL_SHAPES = [(2, 33, 12, 4), (1, 64, 8, 8), (2, 100, 20, 16),
                (3, 1, 5, 4), (1, 257, 3, 8), (2, 129, 13, 16)]


@pytest.mark.parametrize("shape", MODEL_SHAPES)
@pytest.mark.parametrize("dht", [True, False])
def test_model_of_the_backward_matches_vjp(shape, dht):
    args, dy, dh = grad_inputs(*shape, seed=sum(shape), dht=dht)
    b, _, di, n = shape
    plan = ms.scan_bwd_plan(b, di, n)
    states = _plain_states(args).numpy()
    got = scan_bwd_model(*args[:6], states, dy, dh, plan)
    want = reference_grads(jref.mamba_scan_ref, args, dy, dh)
    assert_grads_close(got, want, ("model", shape, dht))


# every built instance of the backward, (N, SPL, L, K)
BWD_BUILT = [(n, spl, seg_len, k) for (n, spl, seg_len), ks in
             sorted(ms.SCAN_BWD_BUILT.items()) for k in ks]


@pytest.mark.parametrize("n,states,seg_len,per_warp", BWD_BUILT)
@pytest.mark.parametrize("warps", [1, 4, 8])
def test_model_holds_for_every_built_variant(n, states, seg_len, per_warp,
                                             warps):
    """Every (SPL, L, K) the backward is built for, S across three chunks
    of the longest (CH = 128), di ragged against W K (a block's last warps
    without a channel)."""
    shape = (2, 300, 11, n)
    args, dy, dh = grad_inputs(*shape, seed=n + 10 * states + seg_len)
    plan = ms.ScanBwdPlan.of(2, 11, n, states, seg_len, warps, per_warp)
    fwd = ms.ScanPlan.of(2, 11, n, states, seg_len, 8)
    st = np.stack([args[6]] + [scan_model(*(      # the chunk states
        v[:, :c * plan.chunk] if v.ndim == 3 and v.shape[1] == 300 else v
        for v in args), fwd)[1] for c in range(1, plan.chunks(300))], axis=1)
    got = scan_bwd_model(*args[:6], st, dy, dh, plan)
    want = reference_grads(jref.mamba_scan_ref, args, dy, dh)
    assert_grads_close(got, want, ("variant", n, states, seg_len, per_warp,
                                   warps))


def test_model_at_long_sequences_with_strong_decay():
    """S = 1024 with every cumulative product of dA underflowing: the
    reverse maps forget, nothing is divided, nothing is NaN."""
    x, dt, a, bm, cm, d_skip, h0 = scan_inputs(1, 1024, 8, 16, seed=5,
                                               decay=30.0)
    rng = np.random.default_rng(9)
    dy = rng.standard_normal((1, 1024, 8)).astype(F32)
    dh = rng.standard_normal((1, 8, 16)).astype(F32)
    args = (x, dt, a, bm, cm, d_skip, h0)
    plan = ms.scan_bwd_plan(1, 8, 16)
    got = scan_bwd_model(*args[:6], _plain_states(args).numpy(), dy, dh, plan)
    assert all(np.isfinite(g).all() for g in got)
    assert_grads_close(got, reference_grads(jref.mamba_scan_ref, args, dy, dh),
                       "strong decay")


@pytest.mark.parametrize("shape", [(1, 32, 8, 4), (2, 256, 1024, 16),
                                   (8, 512, 8192, 16), (3, 37, 200, 8),
                                   (1, 1, 1, 4), (65535, 4, 8, 4)])
def test_backward_plan_takes_the_forwards_chunks(shape):
    """The backward's chunks are the forward's (the chunk states line up),
    its (N, SPL, L, K) is built, its block fits the launch bound and two
    blocks the H100's shared memory, and its grid covers every channel."""
    b, s, di, n = shape
    fwd, plan = ms.scan_plan(b, di, n), ms.scan_bwd_plan(b, di, n)
    assert (plan.states, plan.seg_len, plan.chunk) == (fwd.states,
                                                       fwd.seg_len, fwd.chunk)
    assert plan.per_warp in ms.SCAN_BWD_BUILT[(n, plan.states, plan.seg_len)]
    assert 1 <= plan.warps <= ms.SCAN_BWD_MAX_WARPS
    assert plan.warps & (plan.warps - 1) == 0
    assert plan.grid[1] == b <= 65535
    r = plan.channels
    assert (plan.grid[0] - 1) * r < di <= plan.grid[0] * r
    assert plan.per_warp == 1 or plan.warps * plan.per_warp <= di
    # two blocks an SM: the H100's 233,472 bytes, 1,024 reserved a block
    assert 2 * (plan.shared_bytes + 1024) <= 233_472
    assert plan.chunks(s) == -(-s // fwd.chunk)


def test_backward_plan_at_falcons_training_shape():
    """(8, 512, 8192, 16): CH = 64, 8 chunks, 33.5 MB of chunk states; 8
    warps of 4 channels a block, 2,048 blocks, and 134 MB of dB / dC
    partials (a quarter of one block for 8 channels)."""
    plan = ms.scan_bwd_plan(8, 8192, 16)
    assert plan.chunk == 64 and plan.chunks(512) == 8
    assert 4 * 8 * plan.chunks(512) * 8192 * 16 == 33_554_432
    assert (plan.warps, plan.per_warp, plan.channels) == (8, 4, 32)
    assert plan.grid == (256, 8, 1) and plan.blocks == 2048
    assert plan.partials(512) == (8, 256, 512, 16)
    assert 2 * 4 * int(np.prod(plan.partials(512))) == 134_217_728
    assert plan.shared_bytes == 115_072


# ---------------------------------------------------------------------------
# (d) the autograd Function on CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 40, 12, 4), (1, 70, 8, 16)])
def test_function_matches_autograd_of_the_plain_forward(shape):
    """``MambaScanFn.apply`` (its plain twins) against autograd of
    ``mamba_scan_plain``, with a = -exp(A_log) in the graph: every input's
    gradient and A_log's, for a loss through y and hT."""
    args, dy, dh = grad_inputs(*shape, seed=sum(shape))
    a_log = np.log(-args[2]).astype(F32)
    runs = []
    for fn in (ms.MambaScanFn.apply, ms.mamba_scan_plain):
        live = [torch.from_numpy(v.copy()).requires_grad_() for v in args]
        log_a = torch.from_numpy(a_log.copy()).requires_grad_()
        y, h_t = fn(live[0], live[1], -torch.exp(log_a), *live[3:])
        loss = (y * torch.from_numpy(dy)).sum() + (h_t * torch.from_numpy(dh)
                                                   ).sum()
        loss.backward()
        runs.append([float(loss.detach())] + [t.grad for t in live[:2]] + [log_a.grad]
                    + [t.grad for t in live[3:]])
    assert abs(runs[0][0] - runs[1][0]) <= 1e-5 * abs(runs[1][0])
    for name, g, w in zip(("x", "dt", "A_log", "b", "c", "d", "h0"),
                          runs[0][1:], runs[1][1:]):
        err = float((g - w).abs().max())
        assert err <= TOL * float(w.abs().max()), (name, err)


def test_function_returns_only_the_gradients_asked_for():
    """Inputs that need no gradient get None, and dhT unused is None."""
    args, dy, _ = grad_inputs(1, 16, 8, 4)
    x = torch.from_numpy(args[0]).requires_grad_()
    rest = _t(*args[1:])
    y, _ = ms.MambaScanFn.apply(x, *rest)
    (y * torch.from_numpy(dy)).sum().backward()
    want = reference_grads(jref.mamba_scan_ref, args, dy, None)[0]
    assert float(np.abs(x.grad.numpy() - want).max()) <= TOL * np.abs(
        want).max()
    assert all(not t.requires_grad for t in rest)


def test_mixer_trains_through_the_scan_on_cpu():
    """``selective_scan`` under autograd on the CPU (the plain version) and
    ``ops.mamba_scan`` in every mode give the reference's gradients."""
    args, dy, dh = grad_inputs(2, 64, 12, 8, seed=11)
    want = reference_grads(_selective_scan(64), args, dy, dh)
    for mode in (None, "plain", "ref"):
        live = [torch.from_numpy(v.copy()).requires_grad_() for v in args]
        y, h_t = (tmamba.selective_scan(*live) if mode is None
                  else ops.mamba_scan(*live, mode=mode))
        torch.autograd.backward((y, h_t), _t(dy, dh))
        assert_grads_close([t.grad for t in live], want, ("mixer", mode))
