"""Mamba-1 selective-scan forward (port of ``repro.kernels.mamba_scan``),
kernel 6 of ROADMAP queue 2.

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
  ``mamba_scan.launches``; on CPU tensors the plain version.  Any other
  device raises.

Both refuse, on every device, what the kernel does not take: another
dtype than float32, a state size outside ``STATE_SIZES``, and mismatched
shapes.  Any S is taken (the TPU kernel needs ``S % block_s == 0``).

``scan_plan`` is the kernel's launch geometry: W warps a block (a channel
each), SPL states a lane and L steps a lane's segment, so that a warp's
chunk of ``32 / (N / SPL) * L`` steps is one scan of step maps
(``csrc/mamba_scan.cu``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import _build

SOURCE = "mamba_scan"
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


def mamba_scan_plain(x, dt, a, bmat, cmat, d_skip, h0):
    """``(y, hT)``, plain PyTorch: one step of the recurrence per t."""
    _dims(x, dt, a, bmat, cmat, d_skip, h0)
    h = h0
    ys = []
    for t in range(x.shape[1]):
        x_t, dt_t = x[:, t], dt[:, t]                        # (B, di)
        da = torch.exp(dt_t[..., None] * a)                  # (B, di, N)
        h = da * h + (dt_t * x_t)[..., None] * bmat[:, t, None, :]
        ys.append(torch.sum(h * cmat[:, t, None, :], dim=-1) + x_t * d_skip)
    return torch.stack(ys, dim=1), h


def mamba_scan(x, dt, a, bmat, cmat, d_skip, h0):
    """``(y (B, S, di), hT (B, di, N))``: one kernel launch on CUDA, the
    plain version on CPU.  Every input contiguous float32 on one device."""
    b, s, di, n = _dims(x, dt, a, bmat, cmat, d_skip, h0)
    device = x.device
    if not _build.on_card("mamba_scan", device):
        return mamba_scan_plain(x, dt, a, bmat, cmat, d_skip, h0)
    _build.refuse_grad(
        "mamba_scan", (x, dt, a, bmat, cmat, d_skip, h0), NotImplementedError,
        "the selective scan's backward is not ported (ROADMAP queue 1, "
        "\"kernel 6 backward\"): ssm and hybrid models train on the CPU only")
    for name, t in (("x", x), ("dt", dt), ("a", a), ("bmat", bmat),
                    ("cmat", cmat), ("d_skip", d_skip), ("h0", h0)):
        _build.check(name, t, _F32, t.shape, device)
    if b > 65535:                                            # grid.y = B
        raise ValueError(f"mamba_scan: batch {b} > 65535")
    y = torch.empty_like(x)
    h_t = torch.empty_like(h0)
    _build.launch("mamba_scan", SOURCE,
                  [_build.P] * 9 + [_build.I] * 9, device,
                  x, dt, a, bmat, cmat, d_skip, h0, y, h_t, b, s, di, n,
                  *scan_plan(b, di, n).args())
    mamba_scan.launches += 1
    return y, h_t


mamba_scan.launches = 0
