"""Public wrappers around the port's kernels with mode dispatch.

Modes of every entry point:
  * ``"cuda"`` (default for CUDA tensors) -> the hand-written kernel, one
    launch per call whatever the batch size; a CUDA tensor reaches the
    kernel or raises, there is no fallback;
  * ``"plain"`` (default for CPU tensors) -> the plain PyTorch twin;
  * ``"ref"`` -> the unfused oracle (``env.hypothetical_place`` /
    a stacked feature matrix + ``dqn.qvalues``, ``env.feasible``, and a
    stable sort for the top-k).

``flash_attention``, ``decode_attention`` and ``mamba_scan`` take the
reference's arguments and layouts (``repro.kernels.ops``); their ``ref``
mode is the direct oracle of ``kernels.ref``.

The top-k entry points return per-shard candidates ``(B, shards, k)``
with a ``layout`` (``launch.mesh.FleetLayout``) and ``(B, k)`` without
(the whole fleet as one shard); a scalar pod or a (6,) delta drops the B
axis.  Indices are global, ``-1`` where the value is not finite.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core import dqn, env as kenv
from repro_torch.core.types import FEATURE_DIM, ClusterState, EnvConfig, PodSpec
from repro_torch.kernels import (decode_attention as _da,
                                 flash_attention as _fa, mamba_scan as _ms,
                                 ref, sdqn_score as _ss)

MODES = ("cuda", "plain", "ref")

# the six feature normalizers (``env.FEATURE_SCALE``) as host floats
FEATURE_SCALE = tuple(float(x) for x in kenv.FEATURE_SCALE)
# PlacementEngine's default ceilings: cpu %, mem %, job-util %
DEFAULT_CEILINGS = (88.0, 95.0, 100.0 + 1e-6)


def _mode(mode, device) -> str:
    card = kernels.on_card(device)
    mode = mode or ("cuda" if card else "plain")
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "cuda" and not card:
        raise ValueError(f"mode='cuda' needs CUDA tensors, got {device}")
    return mode


def _mlp_weights(params):
    """The fused kernels hardwire the Table-4 MLP over the canonical
    ``FEATURE_DIM``-wide afterstate row; reject other params up front."""
    w1 = params["w1"]
    if w1.shape[0] != FEATURE_DIM:
        raise ValueError(
            f"fused SDQN kernels score {FEATURE_DIM}-wide afterstate rows; "
            f"got w1 input width {w1.shape[0]} (non-MLP policy params?)")
    return w1, params["b1"], params["w2"], params["b2"]


def _pod_column(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device).reshape(-1)


def _geometry(n, k, layout):
    """(shards, shard_size, k clamped to the shard); ``k`` past the
    kernels' ``TOPK_MAX`` raises in every mode."""
    _ss.check_k(k)
    shards, size = (1, n) if layout is None else (layout.shards,
                                                  layout.shard_size)
    return shards, size, max(1, min(k, size))


def _squeeze(vals, idx, layout, single):
    if layout is None:
        vals, idx = vals[:, 0], idx[:, 0]
    return (vals[0], idx[0]) if single else (vals, idx)


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
    scalars[_ss._S_UPTIME_SCALE] = FEATURE_SCALE[4]
    scalars[_ss._S_EXP_SCALE] = FEATURE_SCALE[5]
    w1, b1, w2, b2 = _mlp_weights(params)
    return (cols, _pod_column(pods.cpu_demand, device),
            _pod_column(pods.mem_demand, device), scalars, w1, b1, w2, b2)


def sdqn_score_afterstate(state: ClusterState, pods: PodSpec, cfg: EnvConfig,
                          params, mode: Optional[str] = None,
                          pull_cost=None) -> torch.Tensor:
    """Q-values of every candidate afterstate for a batch of pods.

    ``pods`` fields are scalars (result (N,)) or (B,) (result (B, N)); the
    whole batch is scored in one kernel launch."""
    device = state.base_cpu.device
    mode = _mode(mode, device)
    single = torch.as_tensor(pods.cpu_demand).dim() == 0
    if mode == "ref":
        batch = PodSpec(*(_pod_column(x, device)[:, None] for x in pods))
        after = kenv.hypothetical_place(state, batch, cfg, pull_cost=pull_cost)
        q = dqn.qvalues(params, kenv.normalize_features(after))
    else:
        inputs = _afterstate_inputs(state, pods, cfg, params, pull_cost)
        if mode == "cuda":
            q = _ss.sdqn_score_afterstate(*inputs)
        else:
            q = _ss.sdqn_score_afterstate_plain(*inputs)
    return q[0] if single else q


def sdqn_topk_afterstate(state: ClusterState, pods: PodSpec, cfg: EnvConfig,
                         params, *, k: int = 4, mode: Optional[str] = None,
                         pull_cost=None, layout=None):
    """The feasible top-k of every pod's candidate afterstates, per shard
    of ``layout``: scored, filtered (``env.feasible``) and reduced in ONE
    kernel launch for the whole batch."""
    device = state.base_cpu.device
    mode = _mode(mode, device)
    shards, size, k = _geometry(state.n_nodes, k, layout)
    single = torch.as_tensor(pods.cpu_demand).dim() == 0
    if mode == "ref":
        batch = PodSpec(*(_pod_column(x, device)[:, None] for x in pods))
        after = kenv.hypothetical_place(state, batch, cfg, pull_cost=pull_cost)
        q = dqn.qvalues(params, kenv.normalize_features(after))
        ok = kenv.feasible(state, batch, cfg)
        vals, idx = _ss.shard_topk(torch.where(ok, q, -torch.inf), shards,
                                   size, k)
    else:
        cols, cd, md, scalars, w1, b1, w2, b2 = _afterstate_inputs(
            state, pods, cfg, params, pull_cost)
        fn = (_ss.sdqn_score_afterstate_topk if mode == "cuda"
              else _ss.sdqn_score_afterstate_topk_plain)
        vals, idx = fn(cols + (state.cpu_requested, state.mem_requested),
                       cd, md, _pod_column(pods.cpu_request, device),
                       _pod_column(pods.mem_request, device), scalars,
                       w1, b1, w2, b2, k=k, shards=shards, shard_size=size)
    return _squeeze(vals, idx, layout, single)


def sdqn_score(feats: torch.Tensor, params, *,
               mode: Optional[str] = None) -> torch.Tensor:
    """Q (N,) of normalized (N, 6) feature rows through the Table-4 Q-net
    (kernel 2; its plain version is the unfused oracle itself)."""
    mode = _mode(mode, feats.device)
    w1, b1, w2, b2 = _mlp_weights(params)
    if mode == "cuda":
        return _ss.sdqn_score(feats, w1, b1, w2, b2)
    return ref.sdqn_score_ref(feats, w1, b1, w2, b2)


def _ref_delta_scores(cols, d, w1, b1, w2, b2):
    feats = ((torch.stack(cols, dim=-1)[None] + d[:, None, :])
             / kenv.FEATURE_SCALE.to(d.device))
    return ref.sdqn_score_ref(feats, w1, b1, w2, b2)


def sdqn_score_delta(cols, deltas: torch.Tensor, params, *,
                     mode: Optional[str] = None) -> torch.Tensor:
    """Q((cols + delta) / FEATURE_SCALE) for column-structured fleets:
    (6,) delta -> (N,), (B, 6) deltas -> (B, N) in one launch."""
    mode = _mode(mode, cols[0].device)
    w1, b1, w2, b2 = _mlp_weights(params)
    d = deltas.reshape(-1, 6)
    if mode == "ref":
        q = _ref_delta_scores(cols, d, w1, b1, w2, b2)
    else:
        fn = _ss.sdqn_score_cols if mode == "cuda" else _ss.sdqn_score_cols_plain
        q = fn(tuple(cols), d, FEATURE_SCALE, w1, b1, w2, b2)
    return q[0] if deltas.dim() == 1 else q


def sdqn_topk_delta(cols, deltas: torch.Tensor, params, *, k: int = 4,
                    mode: Optional[str] = None, ceilings=DEFAULT_CEILINGS,
                    layout=None):
    """Feasible top-k of the column scorer, per shard of ``layout``: the
    ``PlacementEngine.feasible`` predicates (healthy + post-delta cpu /
    mem / job-util ``ceilings``, compared in float32) and the Q-net in ONE
    kernel launch for all deltas."""
    mode = _mode(mode, cols[0].device)
    w1, b1, w2, b2 = _mlp_weights(params)
    shards, size, k = _geometry(cols[0].shape[0], k, layout)
    d = deltas.reshape(-1, 6)
    if mode == "ref":
        q = _ref_delta_scores(cols, d, w1, b1, w2, b2)
        cl = torch.tensor(ceilings, dtype=torch.float32, device=d.device)
        ok = ((cols[3] > 0.5) & (cols[0] + d[:, 0:1] <= cl[0])
              & (cols[1] + d[:, 1:2] <= cl[1])
              & (cols[2] + d[:, 2:3] <= cl[2]))
        vals, idx = _ss.shard_topk(torch.where(ok, q, -torch.inf), shards,
                                   size, k)
    else:
        fn = (_ss.sdqn_score_cols_topk if mode == "cuda"
              else _ss.sdqn_score_cols_topk_plain)
        vals, idx = fn(tuple(cols), d, FEATURE_SCALE, w1, b1, w2, b2,
                       ceilings, k=k, shards=shards, shard_size=size)
    return _squeeze(vals, idx, layout, deltas.dim() == 1)


def flash_attention(q, k, v, *, causal: bool = True,
                    mode: Optional[str] = None) -> torch.Tensor:
    """q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D) -> (B, Sq, Hq, D):
    blocked online-softmax attention (kernel 7), one launch per call."""
    mode = _mode(mode, q.device)
    if mode == "ref":
        return ref.flash_attention_ref(q, k, v, causal=causal)
    fn = _fa.flash_attention if mode == "cuda" else _fa.flash_attention_plain
    return fn(q, k, v, causal=causal)


def decode_attention(q, k, v, kv_len, *,
                     mode: Optional[str] = None) -> torch.Tensor:
    """q (B, Hq, D), k and v (B, Hkv, S, D), ``kv_len`` () or (B,) ->
    (B, Hq, D): one query token per head against a KV cache (kernel 8),
    one call per decode step and attention layer."""
    mode = _mode(mode, q.device)
    if mode == "ref":
        return ref.decode_attention_ref(q, k, v, kv_len)
    fn = _da.decode_attention if mode == "cuda" else _da.decode_attention_plain
    return fn(q, k, v, kv_len)


def mamba_scan(x, dt, a, bmat, cmat, d_skip, h0, *,
               mode: Optional[str] = None):
    """The Mamba-1 selective scan (kernel 6), one launch per call:
    ``(y (B, S, di), hT (B, di, N))``.  Under grad, "cuda" carries kernel
    6's hand-written backward; "plain" and "ref" are autograd of their
    versions."""
    mode = _mode(mode, x.device)
    if mode == "ref":
        return ref.mamba_scan_ref(x, dt, a, bmat, cmat, d_skip, h0)
    fn = _ms.mamba_scan if mode == "cuda" else _ms.mamba_scan_plain
    return fn(x, dt, a, bmat, cmat, d_skip, h0)
