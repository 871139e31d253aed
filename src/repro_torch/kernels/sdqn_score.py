"""Fused SDQN afterstate scoring: raw ClusterState columns -> Q (B, N).

Counterpart of the Pallas ``sdqn_score_afterstate`` of
``repro.kernels.sdqn_score``.  Two versions of one function:

* ``sdqn_score_afterstate_plain`` — plain PyTorch with the arithmetic of the
  reference's ``_afterstate_norm_features`` + ``sdqn_score_afterstate_xla``
  (broadcast multiply-accumulates, no GEMM), over an explicit batch of B
  pods.  The CPU tests use it and ``chip_smoke.py`` holds the kernel to it.
* ``sdqn_score_afterstate`` — the wrapper: on CUDA tensors it launches the
  hand-written kernel ``csrc/sdqn_score_afterstate.cu`` once for the whole
  batch and counts the launch in ``sdqn_score_afterstate.launches``; on CPU
  tensors it runs the plain version.  Any other device raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

# scalar-pack layout (the reference's ``_S_*``).  On the card the per-pod
# demands ride as (B,) columns instead of slots 0/1, and b2 is read from the
# params tensor on the device, so slots 0, 1 and 11 of the host pack are
# unused by the CUDA path.
_S_CPU_DEMAND, _S_MEM_DEMAND, _S_PULL, _S_WARM, _S_OVERHEAD = 0, 1, 2, 3, 4
_S_CROWD_KNEE, _S_CROWD_COEFF, _S_CONT_KNEE, _S_CONT_COEFF = 5, 6, 7, 8
_S_UPTIME_SCALE, _S_EXP_SCALE, _S_B2 = 9, 10, 11
_S_CPU_REQ, _S_MEM_REQ = 12, 13
_N_SCALARS = 16

# the 12 raw node columns, in kernel argument order, with their dtypes
COLUMNS = ("base_cpu", "pods_cpu", "startup_cpu", "num_pods", "exp_pods",
           "mem_used", "image_cached", "healthy", "uptime_hours",
           "cpu_capacity", "mem_capacity", "max_pods")
COLUMN_DTYPES = (torch.float32, torch.float32, torch.float32, torch.int32,
                 torch.int32, torch.float32, torch.bool, torch.bool,
                 torch.float32, torch.float32, torch.float32, torch.int32)
KERNEL_SOURCE = "sdqn_score_afterstate"
HIDDEN = 32


def _afterstate_norm_features(base_cpu, pods_cpu, startup_cpu, num_pods,
                              exp_pods, mem_used, cached, healthy, uptime,
                              cap, mem_cap, max_pods, cpu_demand, mem_demand,
                              s):
    """Normalized Table-2 afterstate features, elementwise.

    Columns are (N,) float32; ``cpu_demand`` / ``mem_demand`` are (B, 1), so
    the two pod-dependent features come out (B, N) and the other four (N,).
    ``s(i)`` reads scalar ``i`` of the pack as a Python float."""
    start_cost = torch.where(cached > 0.5, s(_S_WARM), s(_S_PULL))
    num_pods1 = num_pods + 1.0
    exp_pods1 = exp_pods + 1.0
    crowd = torch.clamp(num_pods1 - s(_S_CROWD_KNEE), min=0.0)
    # the placed node is always active, so the overhead term is unconditional
    raw = (base_cpu + s(_S_OVERHEAD) + pods_cpu + cpu_demand
           + startup_cpu + start_cost + s(_S_CROWD_COEFF) * crowd * crowd)
    util = raw / cap
    over = torch.clamp(util - s(_S_CONT_KNEE), min=0.0)
    used = torch.minimum(raw + s(_S_CONT_COEFF) * over * over * cap, cap)
    return (
        used / cap,                                  # 100 * used/cap, /100
        (mem_used + mem_demand) / mem_cap,           # 100 * mem/cap, /100
        num_pods1 / max_pods,                        # 100 * pods/max, /100
        healthy,
        uptime / s(_S_UPTIME_SCALE),
        exp_pods1 / s(_S_EXP_SCALE),
    )


def sdqn_score_afterstate_plain(cols, cpu_demand, mem_demand, scalars,
                                w1, b1, w2, b2) -> torch.Tensor:
    """Q-values (B, N) of every (pod, node) afterstate, plain PyTorch."""
    cols = [c.to(torch.float32) for c in cols]

    def s(i):
        return float(scalars[i])

    feats = _afterstate_norm_features(*cols, cpu_demand[:, None],
                                      mem_demand[:, None], s)
    hid = b1                                         # (H,)
    for f in range(6):
        hid = hid + feats[f][..., None] * w1[f]      # -> (B, N, H)
    return torch.sum(torch.clamp(hid, min=0.0) * w2[:, 0], dim=-1) + b2[0]


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{name}: want {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _lib():
    lib = _build.load(KERNEL_SOURCE)
    fn = lib.sdqn_score_afterstate_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_float] * 9
                       + [ctypes.c_void_p] * 5
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def sdqn_score_afterstate(cols, cpu_demand, mem_demand, scalars, w1, b1, w2,
                          b2) -> torch.Tensor:
    """Q-values (B, N): one kernel launch on CUDA, the plain version on CPU.

    ``cols``: the 12 raw (N,) columns of ``COLUMNS`` in their native dtypes;
    ``cpu_demand`` / ``mem_demand``: (B,) float32; ``scalars``: the (16,)
    float32 host pack (numpy); ``w1 (6, 32)``, ``b1 (32,)``, ``w2 (32, 1)``,
    ``b2 (1,)`` float32 on the columns' device."""
    device = cols[0].device
    if device.type == "cpu":
        return sdqn_score_afterstate_plain(cols, cpu_demand, mem_demand,
                                           scalars, w1, b1, w2, b2)
    if device.type != "cuda":
        raise ValueError(f"sdqn_score_afterstate runs on cuda or cpu, "
                         f"not {device}")
    n = cols[0].shape[0]
    b = cpu_demand.shape[0]
    if len(cols) != len(COLUMNS):
        raise ValueError(f"want {len(COLUMNS)} columns, got {len(cols)}")
    for name, col, dtype in zip(COLUMNS, cols, COLUMN_DTYPES):
        _check(name, col, dtype, (n,), device)
    _check("cpu_demand", cpu_demand, torch.float32, (b,), device)
    _check("mem_demand", mem_demand, torch.float32, (b,), device)
    _check("w1", w1, torch.float32, (6, HIDDEN), device)
    _check("b1", b1, torch.float32, (HIDDEN,), device)
    _check("w2", w2, torch.float32, (HIDDEN, 1), device)
    _check("b2", b2, torch.float32, (1,), device)
    if n < 1 or not 1 <= b <= 65535 or n * b >= 2 ** 31:   # grid.y = B
        raise ValueError(f"unsupported shape: N={n}, B={b}")
    scalars = np.asarray(scalars, np.float32)
    q = torch.empty((b, n), dtype=torch.float32, device=device)
    fn = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(c.data_ptr() for c in cols), cpu_demand.data_ptr(),
                 mem_demand.data_ptr(),
                 *(float(scalars[i]) for i in range(_S_PULL, _S_EXP_SCALE + 1)),
                 w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                 q.data_ptr(), n, b, stream)
    if err != 0:
        raise RuntimeError(f"sdqn_score_afterstate launch failed: CUDA error "
                           f"{err}")
    sdqn_score_afterstate.launches += 1
    return q


sdqn_score_afterstate.launches = 0
