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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

SOURCE = "mamba_scan"
STATE_SIZES = (4, 8, 16)         # the kernel's template instances

_F32 = torch.float32


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
    for name, t in (("x", x), ("dt", dt), ("a", a), ("bmat", bmat),
                    ("cmat", cmat), ("d_skip", d_skip), ("h0", h0)):
        _build.check(name, t, _F32, t.shape, device)
    if b > 65535:                                            # grid.y = B
        raise ValueError(f"mamba_scan: batch {b} > 65535")
    y = torch.empty_like(x)
    h_t = torch.empty_like(h0)
    _build.launch("mamba_scan", SOURCE,
                  [_build.P] * 9 + [_build.I] * 4, device,
                  x, dt, a, bmat, cmat, d_skip, h0, y, h_t, b, s, di, n)
    mamba_scan.launches += 1
    return y, h_t


mamba_scan.launches = 0
