"""The Mamba-1 selective-state-space block (port of ``repro.models.mamba``):
the mixer of the ssm (falcon-mamba) and hybrid (jamba) families.

Prefill and training run the selective scan through
``kernels.ops.mamba_scan``: kernel 6 (``csrc/mamba_scan.cu``) on CUDA
tensors, ONE launch a mamba layer, and its plain version on the CPU.  In
training the launch is ``MambaScanFn``'s (the forward that keeps the
chunk states, then the hand-written backward ``csrc/mamba_scan_bwd.cu``);
autograd carries ``selective_scan``'s casts of x to float32 and of y back
and ``a = -exp(A_log)`` around it, so ``A_log`` gets its gradient through
the kernel's dA.  The reference runs its own chunked XLA
scan there (``lax.scan`` over chunks of an ``associative_scan``); the
kernel computes the same recurrence from ``h0`` and takes any S, so the
reference's ``chunk`` (and its ``S % chunk == 0``) is ignored, as
``q_chunk`` is in ``layers.attention``.  Decode carries (conv_state,
ssm_state) and is one step of the recurrence in plain PyTorch, as the
reference's is (no kernel there).

Parameters are the reference's tree; ``dt_bias``, ``A_log`` and ``D`` are
float32 whatever the weights' dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers

_F32 = torch.float32


def init_mamba(gen: torch.Generator, cfg, dtype, device=None) -> dict:
    d, di, n, r, cw = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                       cfg.ssm_conv)
    in_proj = layers.dense_init(gen, (d, 2 * di), dtype, device=device)
    conv_w = layers.dense_init(gen, (cw, di), dtype, scale=1.0 / math.sqrt(cw),
                               device=device)
    x_proj = layers.dense_init(gen, (di, r + 2 * n), dtype, device=device)
    dt_proj = layers.dense_init(gen, (r, di), dtype, scale=r ** -0.5,
                                device=device)
    u = torch.rand((di,), generator=gen, dtype=_F32, device=gen.device)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    dt_bias = dt + torch.log(-torch.expm1(-dt))          # inverse softplus
    a = torch.arange(1, n + 1, dtype=_F32, device=device).expand(di, n)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": x_proj,
        "dt_proj": dt_proj,
        "dt_bias": dt_bias.to(device),
        "A_log": torch.log(a).contiguous(),
        "D": torch.ones((di,), dtype=_F32, device=device),
        "out_proj": layers.dense_init(
            gen, (di, d), dtype, scale=1.0 / math.sqrt(2 * cfg.num_layers * di),
            device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in x's dtype.  x: (B, S, di), w: (cw, di)."""
    cw, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, cw - 1, 0))
    out = torch.zeros_like(x)
    for j in range(cw):      # cw is tiny (4): unrolled taps, as the reference
        out = out + pad[:, j:j + s] * w[j]
    return out + b


def _ssm_params(params: dict, x: torch.Tensor, n: int, r: int):
    """x: (B, S, di) -> dt (B, S, di), bmat and cmat (B, S, N), float32."""
    proj = (x @ params["x_proj"]).to(_F32)
    dt, bmat, cmat = torch.split(proj, [r, n, n], dim=-1)
    dt = F.softplus(dt @ params["dt_proj"].to(_F32) + params["dt_bias"])
    return dt, bmat, cmat


def selective_scan(x, dt, a, bmat, cmat, d_skip, h0, chunk: int = 64, *,
                   mode: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan from ``h0``: x (B, S, di) in any float dtype, dt
    (B, S, di), a (di, N), bmat and cmat (B, S, N), d_skip (di,), h0
    (B, di, N), all float32.  Returns (y (B, S, di) in x's dtype, h_final
    (B, di, N) float32).  x is cast to float32 for the kernel, which takes
    float32 only, and y back, as the reference does inside its scan.
    ``mode`` is that of ``kernels.ops`` (None: kernel 6 on CUDA tensors,
    the plain version on the CPU); ``chunk`` is ignored."""
    del chunk
    y, h = ops.mamba_scan(x.to(_F32).contiguous(), dt.contiguous(),
                          a.contiguous(), bmat.contiguous(), cmat.contiguous(),
                          d_skip.contiguous(), h0.contiguous(), mode=mode)
    return y.to(x.dtype), h


def apply_mamba(params: dict, x: torch.Tensor, cfg, h0=None, conv0=None,
                chunk: int = 64, *, mode: Optional[str] = None):
    """The block for train and prefill, x (B, S, D) -> (B, S, D).  Returns
    (out, (conv_state (B, cw - 1, di), ssm_state (B, di, N))) so prefill
    can seed decode; the conv state is the tail of the pre-conv
    ``in_proj`` half, continued from ``conv0`` where given."""
    bsz = x.shape[0]
    di, n, r, cw = cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    xz = x @ params["in_proj"]
    xi, z = torch.split(xz, di, dim=-1)
    if conv0 is not None:                  # continue from the cached tail
        xi_ext = torch.cat([conv0.to(xi.dtype), xi], dim=1)
        conv_out = _causal_conv(xi_ext, params["conv_w"],
                                params["conv_b"])[:, cw - 1:]
    else:
        conv_out = _causal_conv(xi, params["conv_w"], params["conv_b"])
    xi = F.silu(conv_out)
    dt, bmat, cmat = _ssm_params(params, xi, n, r)
    a = -torch.exp(params["A_log"])
    if h0 is None:
        h0 = torch.zeros((bsz, di, n), dtype=_F32, device=x.device)
    y, h_final = selective_scan(xi, dt, a, bmat, cmat, params["D"], h0, chunk,
                                mode=mode)
    out = (y * F.silu(z)) @ params["out_proj"]
    # the reference concatenates conv0 (B, cw - 1, di) with the whole
    # (B, S, 2·di) projection there, which raises; the port takes the x half
    tail = xz[..., :di] if conv0 is None else torch.cat(
        [conv0.to(xz.dtype), xz[..., :di]], dim=1)
    return out, (tail[:, -(cw - 1):], h_final)


def decode_mamba(params: dict, x: torch.Tensor, cfg, state):
    """One token.  x: (B, 1, D); state = (conv_state (B, cw - 1, di),
    h (B, di, N)).  Returns (out (B, 1, D), (new conv_state, new h)), new
    tensors (the caller writes them into its cache)."""
    conv_state, h = state
    di, n, r = cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    xz = x @ params["in_proj"]                                # (B, 1, 2di)
    xi, z = torch.split(xz, di, dim=-1)
    window = torch.cat([conv_state.to(xi.dtype), xi], dim=1)  # (B, cw, di)
    conv = torch.einsum("bcd,cd->bd", window, params["conv_w"]) + params[
        "conv_b"]
    xi1 = F.silu(conv)[:, None, :]                            # (B, 1, di)
    dt, bmat, cmat = _ssm_params(params, xi1, n, r)
    a = -torch.exp(params["A_log"])
    x32 = xi1[:, 0].to(_F32)
    da = torch.exp(dt[:, 0, :, None] * a)                     # (B, di, N)
    dbx = (dt[:, 0] * x32)[..., None] * bmat[:, 0, None, :]
    h_new = da * h + dbx
    y = torch.einsum("bdn,bn->bd", h_new, cmat[:, 0]) + x32 * params["D"]
    out = (y.to(x.dtype)[:, None, :] * F.silu(z)) @ params["out_proj"]
    return out, (window[:, 1:], h_new)


def init_mamba_state(cfg, batch: int, device=None):
    """Zero (conv_state bfloat16, ssm_state float32), as the reference's."""
    return (torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                        dtype=torch.bfloat16, device=device),
            torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=_F32,
                        device=device))
