"""Public wrappers around the port's kernels with mode dispatch.

Modes of ``sdqn_score_afterstate``:
  * ``"cuda"`` (default for CUDA tensors) -> the hand-written kernel, one
    launch per call whatever the batch size; a CUDA tensor reaches the
    kernel or raises, there is no fallback;
  * ``"plain"`` (default for CPU tensors) -> the plain PyTorch twin;
  * ``"ref"`` -> the unfused oracle: ``env.hypothetical_place`` +
    ``dqn.qvalues``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import dqn, env as kenv
from repro_torch.core.types import FEATURE_DIM, ClusterState, EnvConfig, PodSpec
from repro_torch.kernels import sdqn_score as _ss

MODES = ("cuda", "plain", "ref")


def _mlp_weights(params):
    """The fused kernel hardwires the Table-4 MLP over the canonical
    ``FEATURE_DIM``-wide afterstate row; reject other params up front."""
    w1 = params["w1"]
    if w1.shape[0] != FEATURE_DIM:
        raise ValueError(
            f"fused SDQN kernels score {FEATURE_DIM}-wide afterstate rows; "
            f"got w1 input width {w1.shape[0]} (non-MLP policy params?)")
    return w1, params["b1"], params["w2"], params["b2"]


def _pod_column(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device).reshape(-1)


def _afterstate_inputs(state: ClusterState, pods: PodSpec, cfg: EnvConfig,
                       params, pull_cost=None):
    """(12 raw columns, (B,) cpu demand, (B,) mem demand, host scalar pack,
    w1, b1, w2, b2) for the afterstate kernel.

    ``pull_cost`` pins the pull-contention scalar, a GLOBAL reduction over
    ``startup_cpu``; without it the reduction runs on the state here and
    its value is read back to the host once for the whole batch."""
    cols = tuple(getattr(state, name) for name in _ss.COLUMNS)
    device = state.base_cpu.device
    pull = kenv.pull_cost_now(state, cfg) if pull_cost is None else pull_cost
    scalars = np.zeros((_ss._N_SCALARS,), np.float32)
    scalars[_ss._S_PULL] = float(pull)
    scalars[_ss._S_WARM] = cfg.warm_start_cost
    scalars[_ss._S_OVERHEAD] = cfg.node_active_overhead
    scalars[_ss._S_CROWD_KNEE] = cfg.crowd_knee
    scalars[_ss._S_CROWD_COEFF] = cfg.crowd_coeff
    scalars[_ss._S_CONT_KNEE] = cfg.contention_knee
    scalars[_ss._S_CONT_COEFF] = cfg.contention_coeff
    scalars[_ss._S_UPTIME_SCALE] = float(kenv.FEATURE_SCALE[4])
    scalars[_ss._S_EXP_SCALE] = float(kenv.FEATURE_SCALE[5])
    w1, b1, w2, b2 = _mlp_weights(params)
    return (cols, _pod_column(pods.cpu_demand, device),
            _pod_column(pods.mem_demand, device), scalars, w1, b1, w2, b2)


def sdqn_score_afterstate(state: ClusterState, pods: PodSpec, cfg: EnvConfig,
                          params, mode: Optional[str] = None,
                          pull_cost=None) -> torch.Tensor:
    """Q-values of every candidate afterstate for a batch of pods.

    ``pods`` fields are scalars (result (N,)) or (B,) (result (B, N)); the
    whole batch is scored in one kernel launch.  ``mode``: see the module
    docstring."""
    device = state.base_cpu.device
    mode = mode or ("cuda" if device.type == "cuda" else "plain")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    single = torch.as_tensor(pods.cpu_demand).dim() == 0
    if mode == "ref":
        batch = PodSpec(*(_pod_column(x, device)[:, None] for x in pods))
        after = kenv.hypothetical_place(state, batch, cfg, pull_cost=pull_cost)
        q = dqn.qvalues(params, kenv.normalize_features(after))
    else:
        inputs = _afterstate_inputs(state, pods, cfg, params, pull_cost)
        if mode == "cuda":
            if device.type != "cuda":
                raise ValueError(f"mode='cuda' needs CUDA tensors, got {device}")
            q = _ss.sdqn_score_afterstate(*inputs)
        else:
            q = _ss.sdqn_score_afterstate_plain(*inputs)
    return q[0] if single else q
