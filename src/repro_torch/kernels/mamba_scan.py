"""Mamba-1 selective scan (port of ``repro.kernels.mamba_scan``), kernel 6
of ROADMAP queue 2, with its backward.

From ``h0`` (B, di, N), for every step t of x, dt (B, S, di):

    h   = exp(dt_t · A) · h + (dt_t · x_t) ⊗ B_t
    y_t = h · C_t + D · x_t

with A (di, N), B and C (B, S, N), D (di,), all float32.  Returns
``(y (B, S, di), hT (B, di, N))``.  Two versions of one function:

* ``mamba_scan_plain`` — plain PyTorch, a Python loop over t with the
  reference's arithmetic.  The CPU tests use it and ``chip_smoke.py``
  holds the kernel to it.
* ``mamba_scan`` — the wrapper: on CUDA tensors ONE launch of the
  hand-written kernel ``csrc/mamba_scan.cu``, counted in
  ``mamba_scan.launches``; on CPU tensors the plain version (under
  autograd too).  Any other device raises.

Training (the gradient of the same function):

* On CUDA tensors under grad mode with an input that requires grad, the
  wrapper goes through ``MambaScanFn``: its forward is the kernel's
  training instance (``mamba_scan_fwd``, one launch counted in
  ``mamba_scan.launches``), which also writes the state at the start of
  each chunk of ``scan_plan``'s CH steps, (B, ceil(S / CH), di, N); its
  backward ``mamba_scan_bwd``: ``csrc/mamba_scan_bwd.cu``, two device
  kernels (the reverse scan, which reruns each chunk from its state, then
  a fixed-order sum of the dB, dC, dA and dD partials) counted once a call
  in ``mamba_scan_bwd.launches``.  Every gradient repeats bit for bit.
* ``mamba_scan_plain(..., return_states=True)`` and
  ``mamba_scan_bwd_plain`` are their plain twins: the recurrence and its
  reverse step by step, h recomputed in each chunk from its state.

Both refuse, on every device, what the kernel does not take: another
dtype than float32, a state size outside ``STATE_SIZES``, and mismatched
shapes.  Any S is taken (the TPU kernel needs ``S % block_s == 0``).

``scan_plan`` is the kernel's launch geometry: W warps a block (a channel
each), SPL states a lane and L steps a lane's segment, so that a warp's
chunk of ``32 / (N / SPL) * L`` steps is one scan of step maps
(``csrc/mamba_scan.cu``); ``scan_bwd_plan`` the backward's
(``ScanBwdPlan``), on the same chunks, K channels a warp.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import _build

SOURCE = "mamba_scan"
SOURCE_BWD = "mamba_scan_bwd"
STATE_SIZES = (4, 8, 16)         # the kernel's state sizes

_F32 = torch.float32

# Launch geometry (csrc/mamba_scan.cu).  For each state size N, the states
# a lane holds (SPL) and the steps of a lane's segment (L): the kernel's
# association of a step depends on them and on nothing else, never on S,
# so that dt = 0 pad rows leave hT bit for bit that of the truncated
# sequence.  Two regimes, chosen by timing every built pair on an H100
# SXM (scripts/scan_timings.py --variants, PERF.md section 6): a grid of
# fewer blocks than the card has SMs (the mamba class's one block) is a
# chain of latencies, and short segments, a chunk of 32 steps, keep it
# short; a grid that fills the card is issue-bound, and long segments
# spend fewer scan steps and barriers a step.
SCAN_LANES_FEW = {4: (2, 2), 8: (4, 2), 16: (4, 4)}
SCAN_LANES = {4: (2, 8), 8: (4, 8), 16: (4, 8)}
SCAN_FEW_BLOCKS = 132            # a grid under one block an SM (H100 SXM)
# every (N, SPL, L) the launch function instantiates (MS_INSTANCES): the
# pairs of both regimes
SCAN_BUILT = tuple(sorted({(n, *lanes[n]) for lanes in (SCAN_LANES_FEW,
                                                          SCAN_LANES)
                           for n in STATE_SIZES}))
SCAN_WARPS = 8                   # channels a block, at most
SCAN_MAX_WARPS = 16              # the kernel's launch bound (512 threads)
SCAN_BWD_MAX_WARPS = 8           # the backward's launch bound (256 threads)
# The backward's channels a warp (K), walked in turn, for each (N, SPL, L)
# it is built for (MSB_INSTANCES of csrc/mamba_scan_bwd.cu): the few-blocks
# regime's pairs at K = 1, the wide regime's also at the K whose R = 8 K
# channels a block still fit two blocks an SM (H100: 233,472 bytes of
# shared memory an SM, 1,024 of them reserved a block).
SCAN_BWD_BUILT = {(4, 2, 2): (1,), (8, 4, 2): (1,), (16, 4, 4): (1,),
                  (4, 2, 8): (1, 2), (8, 4, 8): (1, 2), (16, 4, 8): (1, 2, 4)}
# The plan takes the largest built K whose grid still has this many blocks
# (about one an SM), else K = 1: chosen by timing every built K on an H100
# (scripts/scan_timings.py --bwd-variants, PERF.md section 6): at
# falcon-mamba-7b's (8, 512, 8192, 16) K = 4 (2,048 blocks) is the
# fastest, at (2, 256, 1024, 16) K = 2 (128 blocks), and K = 4 there (64
# blocks) the slowest.
SCAN_BWD_MIN_BLOCKS = 128
SCAN_REDUCE_THREADS = 256        # the backward's fixed-order sums
SCAN_REDUCE_MAX_BLOCKS = 132 * 8


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    grid: tuple          # (ceil(di / warps), B, 1)
    warps: int           # W: warps a block, one channel each
    states: int          # SPL: states a lane
    seg_len: int         # L: consecutive steps a lane's segment
    n: int               # N: the state size

    @property
    def lanes(self) -> int:
        """G: lanes that share a step, N / SPL."""
        return self.n // self.states

    @property
    def segments(self) -> int:
        """SEG: segments a warp, 32 / G."""
        return 32 // self.lanes

    @property
    def chunk(self) -> int:
        """CH: steps a chunk, SEG · L."""
        return self.segments * self.seg_len

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def shared_bytes(self) -> int:
        """Dynamic shared memory a block (``Scan::smem_floats``): two
        buffers of the B and C tiles (SEG segments of L rows at a stride of
        SS = N mod 32 floats) and the x and dt tiles (W rows of CH + 1
        floats), each buffer rounded up to 16 bytes, and the y tile."""
        ss = self.seg_len * self.n + (self.n * (1 - self.seg_len)) % 32
        tile = self.warps * (self.chunk + 1)
        buf = -(-(2 * self.segments * ss + 2 * tile) // 4) * 4
        return 4 * (2 * buf + tile)

    @classmethod
    def of(cls, b: int, di: int, n: int, states: int, seg_len: int,
           warps: int) -> "ScanPlan":
        return cls((-(-di // warps), b, 1), warps, states, seg_len, n)

    def chunks(self, s: int) -> int:
        """Chunks of S steps: the chunk states' second dimension."""
        return -(-s // self.chunk)

    def args(self) -> tuple:
        """The launch function's (states, seg_len, warps, grid_x, grid_y)."""
        return (self.states, self.seg_len, self.warps, self.grid[0],
                self.grid[1])


@functools.lru_cache(maxsize=256)
def scan_plan(b: int, di: int, n: int) -> ScanPlan:
    """Kernel 6's launch for B batch rows of di channels and N states:
    W = ``SCAN_WARPS`` warps a block, fewer (a power of two) where di is
    smaller, and (SPL, L) from ``SCAN_LANES_FEW[n]`` where the grid has
    fewer than ``SCAN_FEW_BLOCKS`` blocks, else ``SCAN_LANES[n]``.  S is
    not an input (see ``SCAN_LANES``)."""
    warps = min(SCAN_WARPS, 1 << (di - 1).bit_length())
    blocks = -(-di // warps) * b
    lanes = SCAN_LANES_FEW if blocks < SCAN_FEW_BLOCKS else SCAN_LANES
    return ScanPlan.of(b, di, n, *lanes[n], warps)


@dataclasses.dataclass(frozen=True)
class ScanBwdPlan:
    """The backward's launch geometry (``csrc/mamba_scan_bwd.cu``): a
    block of W warps serves R = W K channels of one batch row, each warp
    walking its K channels in turn, on the forward's chunks."""
    grid: tuple          # (ceil(di / (warps per_warp)), B, 1)
    warps: int           # W
    per_warp: int        # K: channels a warp
    states: int          # SPL
    seg_len: int         # L
    n: int               # N

    lanes = ScanPlan.lanes
    segments = ScanPlan.segments
    chunk = ScanPlan.chunk
    blocks = ScanPlan.blocks
    chunks = ScanPlan.chunks

    @property
    def channels(self) -> int:
        """R: channels a block, W K."""
        return self.warps * self.per_warp

    @property
    def shared_bytes(self) -> int:
        """Dynamic shared memory a block (``BwdTiles::smem_floats``): two
        stages, each the B and C tiles (SEG segments of L rows at a stride
        of SS = N mod 32 floats), the x and dt rows of the R channels (2 CH
        + 1 floats a channel) and their chunk-start states, rounded up to
        16 bytes; the warps' slabs of dC (then dB) slots, CH N floats each,
        and half slabs of dB slots, L / 2 steps of 32 SPL floats each; each
        channel's carry, dA sums and row of A; each lane's state before its
        segment; each channel's dD sum."""
        ss = self.seg_len * self.n + (self.n * (1 - self.seg_len)) % 32
        r = self.channels
        stage = -(-(2 * self.segments * ss + r * (2 * self.chunk + 1)
                    + r * self.n) // 4) * 4
        slabs = self.warps * (self.chunk * self.n
                              + self.seg_len // 2 * 32 * self.states)
        return 4 * (2 * stage + slabs + r * (3 * self.n + 1)
                    + self.warps * 32 * self.states)

    def partials(self, s: int) -> tuple:
        """Shape of each of the dB and dC block partials, (B, blocks, S,
        N)."""
        return (self.grid[1], self.grid[0], s, self.n)

    @classmethod
    def of(cls, b: int, di: int, n: int, states: int, seg_len: int,
           warps: int, per_warp: int) -> "ScanBwdPlan":
        return cls((-(-di // (warps * per_warp)), b, 1), warps, per_warp,
                   states, seg_len, n)

    def args(self) -> tuple:
        """The launch function's (states, seg_len, per_warp, warps,
        grid_x, grid_y)."""
        return (self.states, self.seg_len, self.per_warp, self.warps,
                self.grid[0], self.grid[1])


@functools.lru_cache(maxsize=256)
def scan_bwd_plan(b: int, di: int, n: int) -> ScanBwdPlan:
    """The backward's launch: ``scan_plan``'s (SPL, L), so that its chunks
    are the forward's and the chunk states line up; its W (at most
    ``SCAN_BWD_MAX_WARPS``); the largest K of ``SCAN_BWD_BUILT`` that
    leaves no warp without a channel and whose grid has at least
    ``SCAN_BWD_MIN_BLOCKS`` blocks, else 1."""
    fwd = scan_plan(b, di, n)
    warps = min(fwd.warps, SCAN_BWD_MAX_WARPS)
    ks = SCAN_BWD_BUILT[(n, fwd.states, fwd.seg_len)]
    per_warp = max((k for k in ks if warps * k <= di
                    and -(-di // (warps * k)) * b >= SCAN_BWD_MIN_BLOCKS),
                   default=1)
    return ScanBwdPlan.of(b, di, n, fwd.states, fwd.seg_len, warps, per_warp)


def scan_bwd_occupancy(plan: ScanBwdPlan) -> int:
    """Blocks of ``plan``'s reverse-scan instance that one SM of the
    current card holds at once (the runtime's occupancy calculator, at the
    plan's warps and shared memory).  Needs a card."""
    import ctypes

    lib = _build.load(SOURCE_BWD)
    fn = lib.mamba_scan_bwd_occupancy
    fn.argtypes = [_build.I] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    err = fn(plan.n, plan.states, plan.seg_len, plan.per_warp, plan.warps,
             ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"mamba_scan_bwd_occupancy: CUDA error {err}"
                           f"{_build._why(lib)}")
    return blocks.value


def _dims(x, dt, a, bmat, cmat, d_skip, h0):
    """(B, S, di, N), raising on what the kernel does not take."""
    args = (("x", x), ("dt", dt), ("a", a), ("bmat", bmat), ("cmat", cmat),
            ("d_skip", d_skip), ("h0", h0))
    for name, t in args:
        if t.dtype != _F32:
            raise ValueError(f"mamba_scan: {name} must be float32, got "
                             f"{t.dtype}")
    if x.dim() != 3 or a.dim() != 2:
        raise ValueError(f"mamba_scan: want x (B, S, di) and a (di, N), got "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")
    b, s, di = x.shape
    n = a.shape[1]
    want = {"x": (b, s, di), "dt": (b, s, di), "a": (di, n),
            "bmat": (b, s, n), "cmat": (b, s, n), "d_skip": (di,),
            "h0": (b, di, n)}
    for name, t in args:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"mamba_scan: {name} has shape {tuple(t.shape)}, "
                             f"want {want[name]}")
    if n not in STATE_SIZES:
        raise ValueError(f"mamba_scan: state size {n} not in {STATE_SIZES}")
    if min(b, s, di) < 1:
        raise ValueError(f"mamba_scan: empty shape B={b} S={s} di={di}")
    return b, s, di, n


def mamba_scan_plain(x, dt, a, bmat, cmat, d_skip, h0, *,
                     return_states: bool = False):
    """``(y, hT)``, plain PyTorch: one step of the recurrence per t.  With
    ``return_states``, ``(y, hT, states)``: also the state at the start of
    every chunk of ``scan_plan``'s CH steps, (B, ceil(S / CH), di, N), as
    the kernel's training instance writes them."""
    b, s, di, n = _dims(x, dt, a, bmat, cmat, d_skip, h0)
    chunk = scan_plan(b, di, n).chunk
    h = h0
    ys, states = [], []
    for t in range(s):
        if t % chunk == 0:
            states.append(h)
        x_t, dt_t = x[:, t], dt[:, t]                        # (B, di)
        da = torch.exp(dt_t[..., None] * a)                  # (B, di, N)
        h = da * h + (dt_t * x_t)[..., None] * bmat[:, t, None, :]
        ys.append(torch.sum(h * cmat[:, t, None, :], dim=-1) + x_t * d_skip)
    if return_states:
        return torch.stack(ys, dim=1), h, torch.stack(states, dim=1)
    return torch.stack(ys, dim=1), h


def _bwd_dims(x, dt, a, bmat, cmat, d_skip, states, dy, dht):
    """(B, S, di, N, chunk), raising on what the backward does not take."""
    b, s, di, n = _dims(x, dt, a, bmat, cmat, d_skip, states[:, 0])
    plan = scan_plan(b, di, n)
    want = {"states": (b, plan.chunks(s), di, n), "dy": (b, s, di),
            "dht": (b, di, n)}
    for name, t in (("states", states), ("dy", dy), ("dht", dht)):
        if t is None and name == "dht":
            continue
        if t.dtype != _F32 or tuple(t.shape) != want[name]:
            raise ValueError(f"mamba_scan_bwd: {name} must be float32 "
                             f"{want[name]}, got {t.dtype} {tuple(t.shape)}")
    return b, s, di, n, plan.chunk


def mamba_scan_bwd_plain(x, dt, a, bmat, cmat, d_skip, states, dy, dht=None,
                         *, need_dh0: bool = True):
    """``(dx, ddt, da, dbmat, dcmat, dd_skip, dh0)`` of the scan, plain
    PyTorch: with P_t = dA_t G_t (G_t = dL/dh_t), one step of the reverse
    recurrence P_t = dA_t (P_{t+1} + dy_t C_t) per t, from the last step
    (P_S = ``dht``, zero when None) to the first; h_{t-1} and h_t from the
    chunk's state in ``states`` (``mamba_scan_plain(...,
    return_states=True)``).  ``dh0`` is None unless ``need_dh0``."""
    b, s, di, n, chunk = _bwd_dims(x, dt, a, bmat, cmat, d_skip, states, dy,
                                   dht)
    p = torch.zeros_like(states[:, 0]) if dht is None else dht
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dbm, dcm = torch.empty_like(bmat), torch.empty_like(cmat)
    da = torch.zeros_like(a)
    for c in range(states.shape[1] - 1, -1, -1):
        t0, t1 = c * chunk, min(s, (c + 1) * chunk)
        hs, h = [], states[:, c]                  # h_{t0 - 1} .. h_{t1 - 1}
        for t in range(t0, t1):
            hs.append(h)
            e = torch.exp(dt[:, t, :, None] * a)
            h = e * h + (dt[:, t] * x[:, t])[..., None] * bmat[:, t, None, :]
        hs.append(h)
        for t in range(t1 - 1, t0 - 1, -1):
            x_t, dt_t, dy_t = x[:, t], dt[:, t], dy[:, t]     # (B, di)
            e = torch.exp(dt_t[..., None] * a)                # (B, di, N)
            g = p + dy_t[..., None] * cmat[:, t, None, :]     # G_t
            p = e * g                                         # P_t
            gb = torch.sum(g * bmat[:, t, None, :], dim=-1)
            dx[:, t] = d_skip * dy_t + dt_t * gb
            ddt[:, t] = x_t * gb + torch.sum(p * a * hs[t - t0], dim=-1)
            da = da + torch.sum(p * dt_t[..., None] * hs[t - t0], dim=0)
            dbm[:, t] = torch.sum(g * (dt_t * x_t)[..., None], dim=1)
            dcm[:, t] = torch.sum(dy_t[..., None] * hs[t - t0 + 1], dim=1)
    dd = torch.sum(dy * x, dim=(0, 1))
    return dx, ddt, da, dbm, dcm, dd, (p if need_dh0 else None)


_INPUTS = ("x", "dt", "a", "bmat", "cmat", "d_skip", "h0")


def _launch_forward(x, dt, a, bmat, cmat, d_skip, h0, with_states):
    """The serving launch, or the training instance's with the chunk
    states: ``(y, hT, states or None)``, counted in ``mamba_scan``."""
    b, s, di, n = _dims(x, dt, a, bmat, cmat, d_skip, h0)
    device = x.device
    for name, t in zip(_INPUTS, (x, dt, a, bmat, cmat, d_skip, h0)):
        _build.check(name, t, _F32, t.shape, device)
    if b > 65535:                                            # grid.y = B
        raise ValueError(f"mamba_scan: batch {b} > 65535")
    plan = scan_plan(b, di, n)
    y = torch.empty_like(x)
    h_t = torch.empty_like(h0)
    if with_states:
        states = torch.empty((b, plan.chunks(s), di, n), dtype=_F32,
                             device=device)
        _build.launch("mamba_scan_states", SOURCE,
                      [_build.P] * 10 + [_build.I] * 9, device,
                      x, dt, a, bmat, cmat, d_skip, h0, y, h_t, states, b, s,
                      di, n, *plan.args())
    else:
        states = None
        _build.launch("mamba_scan", SOURCE,
                      [_build.P] * 9 + [_build.I] * 9, device,
                      x, dt, a, bmat, cmat, d_skip, h0, y, h_t, b, s, di, n,
                      *plan.args())
    mamba_scan.launches += 1
    return y, h_t, states


def mamba_scan(x, dt, a, bmat, cmat, d_skip, h0):
    """``(y (B, S, di), hT (B, di, N))``: one kernel launch on CUDA, the
    plain version on CPU.  Every input contiguous float32 on one device.
    On CUDA under grad mode, with an input that requires grad, the outputs
    carry the hand-written backward (``MambaScanFn``)."""
    _dims(x, dt, a, bmat, cmat, d_skip, h0)
    if not _build.on_card("mamba_scan", x.device):
        return mamba_scan_plain(x, dt, a, bmat, cmat, d_skip, h0)
    inputs = (x, dt, a, bmat, cmat, d_skip, h0)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return MambaScanFn.apply(*inputs)
    y, h_t, _ = _launch_forward(*inputs, with_states=False)
    return y, h_t


mamba_scan.launches = 0


def mamba_scan_fwd(x, dt, a, bmat, cmat, d_skip, h0):
    """``(y, hT, states)``: the training forward, the kernel's instance
    that also writes the chunk states (one launch, counted in
    ``mamba_scan.launches``) on CUDA, ``mamba_scan_plain(...,
    return_states=True)`` on CPU."""
    _dims(x, dt, a, bmat, cmat, d_skip, h0)
    if not _build.on_card("mamba_scan", x.device):
        return mamba_scan_plain(x, dt, a, bmat, cmat, d_skip, h0,
                                return_states=True)
    return _launch_forward(x, dt, a, bmat, cmat, d_skip, h0, with_states=True)


def mamba_scan_bwd(x, dt, a, bmat, cmat, d_skip, states, dy, dht=None, *,
                   need_dh0: bool = True):
    """``(dx, ddt, da, dbmat, dcmat, dd_skip, dh0)``: on CUDA the kernels
    of ``csrc/mamba_scan_bwd.cu`` (the reverse scan on ``scan_bwd_plan``,
    then the fixed-order sums), counted once a call in
    ``mamba_scan_bwd.launches``; on CPU the plain version.  ``states`` from
    ``mamba_scan_fwd``; ``dht`` None is zero; ``dh0`` None unless
    ``need_dh0``.  Every input contiguous float32 on one device."""
    b, s, di, n, _ = _bwd_dims(x, dt, a, bmat, cmat, d_skip, states, dy, dht)
    device = x.device
    if not _build.on_card("mamba_scan_bwd", device):
        return mamba_scan_bwd_plain(x, dt, a, bmat, cmat, d_skip, states, dy,
                                    dht, need_dh0=need_dh0)
    for name, t in zip(_INPUTS[:6] + ("states", "dy", "dht"),
                       (x, dt, a, bmat, cmat, d_skip, states, dy, dht)):
        if t is not None:
            _build.check(f"mamba_scan_bwd: {name}", t, _F32, t.shape, device)
    if b > 65535:
        raise ValueError(f"mamba_scan_bwd: batch {b} > 65535")
    plan = scan_bwd_plan(b, di, n)
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    db_part = torch.empty(plan.partials(s), dtype=_F32, device=device)
    dc_part = torch.empty_like(db_part)
    da_part = torch.empty((b, di, n), dtype=_F32, device=device)
    dd_part = torch.empty((b, di), dtype=_F32, device=device)
    dh0 = torch.empty((b, di, n), dtype=_F32, device=device) if need_dh0 \
        else None
    dbm, dcm = torch.empty_like(bmat), torch.empty_like(cmat)
    da, dd = torch.empty_like(a), torch.empty_like(d_skip)
    total = 2 * b * s * n + di * n + di
    blocks = min(-(-total // SCAN_REDUCE_THREADS), SCAN_REDUCE_MAX_BLOCKS)
    _build.launch("mamba_scan_bwd", SOURCE_BWD,
                  [_build.P] * 20 + [_build.I] * 11, device,
                  x, dt, a, bmat, cmat, d_skip, states, dy, dht, dx, ddt,
                  db_part, dc_part, da_part, dd_part, dh0, dbm, dcm, da, dd,
                  b, s, di, n, *plan.args(), blocks)
    mamba_scan_bwd.launches += 1
    return dx, ddt, da, dbm, dcm, dd, dh0


mamba_scan_bwd.launches = 0


class MambaScanFn(torch.autograd.Function):
    """Kernel 6 with its backward: the forward keeps the inputs and the
    chunk states (``mamba_scan_fwd``); the backward runs ``mamba_scan_bwd``
    on them, dy and dhT (None where hT was not used), and returns the
    gradient of every input that needs one.  On CPU tensors both run the
    plain twins."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat, d_skip, h0):
        y, h_t, states = mamba_scan_fwd(x, dt, a, bmat, cmat, d_skip, h0)
        ctx.save_for_backward(x, dt, a, bmat, cmat, d_skip, states)
        ctx.set_materialize_grads(False)
        return y, h_t

    @staticmethod
    def backward(ctx, dy, dht):
        x, dt, a, bmat, cmat, d_skip, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = mamba_scan_bwd(
            x, dt, a, bmat, cmat, d_skip, states, dy.contiguous(),
            None if dht is None else dht.contiguous(),
            need_dh0=ctx.needs_input_grad[6])
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))
