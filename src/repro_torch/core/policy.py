"""Policy-class registry (PyTorch port of ``repro.core.policy``), serving half.

A ``PolicySpec`` is the contract every scheduler policy class implements:

  * ``init(gen, device=None) -> params`` — a dict of tensors (nested dicts
    welcome), drawn from a ``torch.Generator``;
  * ``qvalues(params, feats) -> scores`` — pointwise Q over ``(..., F)``
    feature rows, F == ``feature_dim``;
  * ``score_set(params, feats, mode=None) -> scores`` — Q over whole
    candidate sets ``(..., N, F) -> (..., N)``: leading dimensions are a
    batch of sets (a daemon batch of B pods is one ``(B, N, F)`` call,
    where the reference vmaps over pods).  ``mode`` picks the kernels'
    version (``kernels.ops``: ``None`` = the kernel on the card, the plain
    version on the CPU);
  * for sequence policies (``embed_dim > 0``) an arrival-history encoder:
    ``carry_init(params)``, ``encode_step(params, carry, workload) ->
    (carry, embed)`` for one arrival, and ``encode_sequence(params,
    workloads, h0=None, mode=None, n_real=None) -> (embeds, carry)`` for a
    ``(T, ENCODER_IN)`` run of arrivals in one kernel launch, equal to
    folding ``encode_step`` (rows from ``n_real`` on leave the carry
    untouched).  The embed is appended to every afterstate row.

Three entries ship in-registry, with the reference's hyperparameters:

  * ``"mlp"`` — the paper's Table-4 SDQN net (``core.dqn``), served by the
    fused afterstate and column kernels;
  * ``"attention"`` — a set-attention scorer: embeds each candidate
    afterstate, mixes context with one multi-head attention pass over the
    node set (kernel 7, ``kernels.flash_attention``), projects to a
    scalar Q per node;
  * ``"mamba"`` — a selective-state-space arrival-history encoder
    (kernel 6, ``kernels.mamba_scan``) feeding an MLP Q-head over
    ``[afterstate | history embed]`` rows.

Training is generic over the spec: ``init_train_state`` / ``make_train_step``
are the Table-4 Adam/MSE learner for any registered class, and every
function here accepts params with a leading seed dimension (candidate
policies trained side by side, ``train.engine``): rows then lead with the
same dimension and go through their seed's weights (``dqn.linear``).
``save_checkpoint`` / ``restore_checkpoint`` write and read params with
the class's record in the manifest (``checkpoint.ckpt``, the reference's
format).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as nnf

from repro_torch.core import dqn
from repro_torch.core.dqn import linear
from repro_torch.core.types import FEATURE_DIM
from repro_torch.device import resolve_device
from repro_torch.optim import adam_init

__all__ = ["ENCODER_IN", "PolicySpec", "checked", "checkpoint_metadata",
           "get", "init_train_state", "make_opt_state", "make_train_step",
           "mse_loss", "names", "pod_workload_features", "register",
           "restore_checkpoint", "save_checkpoint"]

F32 = torch.float32

# Input width of the sequence encoders: the arriving workload's demand
# vector (cpu_request, cpu_demand, mem_request, mem_demand), known at
# decision time on every substrate.
ENCODER_IN = 4
_WORKLOAD_SCALE = (1000.0, 1000.0, 1024.0, 1024.0)  # millicores / MiB


def pod_workload_features(pod) -> torch.Tensor:
    """``(..., ENCODER_IN)`` normalized demand vector of arriving pods
    (fields scalars or (B,) tensors)."""
    device = next((x.device for x in pod if isinstance(x, torch.Tensor)),
                  torch.device("cpu"))
    cols = [torch.as_tensor(x, dtype=F32, device=device) for x in
            (pod.cpu_request, pod.cpu_demand, pod.mem_request, pod.mem_demand)]
    return torch.stack(cols, dim=-1) / _workload_scale(device)


@functools.lru_cache(maxsize=None)
def _workload_scale(device: torch.device) -> torch.Tensor:
    """``_WORKLOAD_SCALE`` on ``device``, copied there once."""
    return torch.tensor(_WORKLOAD_SCALE, dtype=F32, device=device)


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """One scheduler policy class (see the module docstring).

    ``feature_dim`` is the row width ``FEATURE_DIM + embed_dim``;
    ``fused_kernel`` marks specs whose ``qvalues`` is exactly the Table-4
    MLP, served by the fused afterstate / column kernels; ``hyperparams``
    is the architecture record (widths, head counts)."""

    name: str
    feature_dim: int
    embed_dim: int
    init: Callable[..., Any]
    qvalues: Callable[[Any, torch.Tensor], torch.Tensor]
    score_set: Callable[..., torch.Tensor]
    encode_step: Optional[Callable] = None
    encode_sequence: Optional[Callable] = None
    carry_init: Optional[Callable] = None
    fused_kernel: bool = False
    hyperparams: Tuple[Tuple[str, Any], ...] = ()


_REGISTRY: Dict[str, PolicySpec] = {}


def register(spec: PolicySpec) -> PolicySpec:
    if spec.embed_dim > 0 and None in (spec.encode_step, spec.encode_sequence,
                                       spec.carry_init):
        raise ValueError(f"policy {spec.name!r} declares embed_dim="
                         f"{spec.embed_dim} but no encoder")
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> PolicySpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown policy class {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def checked(policy) -> Optional[PolicySpec]:
    """``policy`` as an entry point takes it: ``None`` or a REGISTERED
    ``PolicySpec``; anything else raises."""
    if policy is None:
        return None
    if not isinstance(policy, PolicySpec):
        raise TypeError(f"policy must be a registered PolicySpec or None, got "
                        f"{type(policy).__name__}")
    if _REGISTRY.get(policy.name) is not policy:
        raise ValueError(f"policy {policy.name!r} is not registered; "
                         f"registered: {sorted(_REGISTRY)}")
    return policy


# ---------------------------------------------------------------------------
# generic Table-4 learner: Adam(1e-3) + MSE over any spec's qvalues
# ---------------------------------------------------------------------------

ADAM = dqn.ADAM  # every policy class trains with the paper's optimizer


def mse_loss(spec: PolicySpec, params, feats, targets, weights=None):
    """``dqn.mse_loss`` over ``spec.qvalues``: () loss, or (S,) with
    per-seed params."""
    return dqn.weighted_mse(spec.qvalues(params, feats), targets, weights,
                            per_seed=dqn.seeded(params))


def init_train_state(spec: PolicySpec, gen: torch.Generator, device=None):
    params = spec.init(gen, device=device)
    return params, adam_init(params, ADAM)


def make_opt_state(params) -> dict:
    """Fresh Adam moments for an EXISTING parameter tree (warm starts)."""
    return adam_init(params, ADAM)


def make_train_step(spec: PolicySpec) -> Callable:
    """``(params, opt_state, feats, targets, weights) -> (params, opt_state,
    loss, stats)`` — ``dqn.train_step`` generic over the spec (for "mlp"
    the same computation).  Per-seed params give an (S,) loss and each
    seed its own gradients."""

    def loss_fn(params, feats, targets, weights):
        return mse_loss(spec, params, feats, targets, weights)

    def step(params, opt_state, feats, targets, weights=None):
        return dqn.learner_step(loss_fn, params, opt_state, feats, targets,
                                weights, per_seed=dqn.seeded(params))

    return step


def _dense(gen, fan_in, shape, device, gain=1.0):
    x = torch.randn(shape, generator=gen, dtype=F32, device=gen.device)
    return (x * (gain / fan_in) ** 0.5).to(device)


# ---------------------------------------------------------------------------
# "mlp" — the paper's Table-4 SDQN net (core.dqn), first registry entry
# ---------------------------------------------------------------------------


def _mlp_score_set(params: dict, feats: torch.Tensor, mode=None):
    """The pointwise net: the set path IS the row path."""
    return dqn.qvalues(params, feats)


MLP = register(PolicySpec(
    name="mlp",
    feature_dim=FEATURE_DIM,
    embed_dim=0,
    init=dqn.init_qnet,
    qvalues=dqn.qvalues,
    score_set=_mlp_score_set,
    fused_kernel=True,
    hyperparams=(("hidden", dqn.HIDDEN),),
))


# ---------------------------------------------------------------------------
# "attention" — set-attention scorer over the candidate-node feature set
# ---------------------------------------------------------------------------

ATTN_DMODEL = 16
ATTN_HEADS = 2


def init_attention(gen: torch.Generator, d_model: int = ATTN_DMODEL,
                   device=None) -> dict:
    device = resolve_device(device)
    d = d_model
    return {
        "w_in": _dense(gen, FEATURE_DIM, (FEATURE_DIM, d), device),
        "b_in": torch.zeros((d,), dtype=F32, device=device),
        "wq": _dense(gen, d, (d, d), device),
        "wk": _dense(gen, d, (d, d), device),
        "wv": _dense(gen, d, (d, d), device),
        "wo": _dense(gen, d, (d, d), device),
        "w_out": _dense(gen, d, (d, 1), device),
        "b_out": torch.zeros((1,), dtype=F32, device=device),
    }


def _attn_embed(params, feats):
    return torch.tanh(linear(feats, params["w_in"], params["b_in"]))


def _attn_head(params, x, attn_out):
    # residual mix of set context
    h = torch.relu(x + linear(attn_out, params["wo"]))
    return linear(h, params["w_out"], params["b_out"])[..., 0]


def attention_qvalues(params: dict, feats: torch.Tensor) -> torch.Tensor:
    """Pointwise Q over ``(..., F)`` rows == the set scorer on singleton
    sets: softmax over one key is the identity, so ``attn_out == v``."""
    x = _attn_embed(params, feats)
    return _attn_head(params, x, linear(x, params["wv"]))


def attention_score_set(params: dict, feats: torch.Tensor,
                        mode: Optional[str] = None) -> torch.Tensor:
    """(..., N, F) candidate sets -> (..., N) scores, with one multi-head
    attention mix over each set's node axis: ONE launch of kernel 7 for all
    the sets, the leading dimensions (seeds first, with per-seed params)
    flattened into its batch axis."""
    from repro_torch.kernels import ops

    x = _attn_embed(params, feats)                          # (..., N, d)
    n, d = x.shape[-2:]

    def heads(t):
        return t.reshape(-1, n, ATTN_HEADS, d // ATTN_HEADS)  # (B, S=N, H, hd)

    out = ops.flash_attention(heads(linear(x, params["wq"])),
                              heads(linear(x, params["wk"])),
                              heads(linear(x, params["wv"])), causal=False,
                              mode=mode)
    return _attn_head(params, x, out.reshape(x.shape))


ATTENTION = register(PolicySpec(
    name="attention",
    feature_dim=FEATURE_DIM,
    embed_dim=0,
    init=init_attention,
    qvalues=attention_qvalues,
    score_set=attention_score_set,
    hyperparams=(("d_model", ATTN_DMODEL), ("heads", ATTN_HEADS)),
))


# ---------------------------------------------------------------------------
# "mamba" — selective-state-space arrival-history encoder + MLP Q-head
# ---------------------------------------------------------------------------

MAMBA_DI = 8        # encoder inner channels
MAMBA_STATE = 4     # SSM state size per channel
MAMBA_DT_RANK = 2
MAMBA_EMBED = 8     # history-embed width appended to afterstate rows
MAMBA_HIDDEN = 32   # Q-head hidden width (Table 4)


def init_mamba(gen: torch.Generator, device=None) -> dict:
    device = resolve_device(device)
    di, n, r, e = MAMBA_DI, MAMBA_STATE, MAMBA_DT_RANK, MAMBA_EMBED
    f = FEATURE_DIM + e
    enc = {
        "in_proj": _dense(gen, ENCODER_IN, (ENCODER_IN, di), device),
        "x_proj": _dense(gen, di, (di, r + 2 * n), device),
        "dt_proj": _dense(gen, r, (r, di), device),
        # softplus(dt_bias) ~ 0.05: a gentle default discretization step
        "dt_bias": torch.full((di,), math.log(math.expm1(0.05)), dtype=F32,
                              device=device),
        # S4D-real init: A = -(1..n) per channel
        "A_log": torch.log(torch.arange(1, n + 1, dtype=F32, device=device)
                           ).expand(di, n).contiguous(),
        "D": torch.ones((di,), dtype=F32, device=device),
        "out_proj": _dense(gen, di, (di, e), device),
    }
    head = {
        "w1": _dense(gen, f, (f, MAMBA_HIDDEN), device, gain=2.0),
        "b1": torch.zeros((MAMBA_HIDDEN,), dtype=F32, device=device),
        "w2": _dense(gen, MAMBA_HIDDEN, (MAMBA_HIDDEN, 1), device),
        "b2": torch.zeros((1,), dtype=F32, device=device),
    }
    return {"enc": enc, "head": head}


def mamba_qvalues(params: dict, feats: torch.Tensor) -> torch.Tensor:
    """Q-head over ``(..., FEATURE_DIM + MAMBA_EMBED)`` rows."""
    head = params["head"]
    h = torch.relu(linear(feats, head["w1"], head["b1"]))
    return linear(h, head["w2"], head["b2"])[..., 0]


def _mamba_score_set(params: dict, feats: torch.Tensor, mode=None):
    """Pointwise head: the set's context lives in the embed."""
    return mamba_qvalues(params, feats)


def mamba_carry_init(params: dict) -> torch.Tensor:
    return torch.zeros((MAMBA_DI, MAMBA_STATE), dtype=F32,
                       device=params["enc"]["D"].device)


def _mamba_ssm_params(enc: dict, x: torch.Tensor):
    """x: (..., di) -> (dt (..., di), b (..., n), c (..., n)), float32."""
    proj = linear(x, enc["x_proj"])
    r, n = MAMBA_DT_RANK, MAMBA_STATE
    dt_raw, b, c = proj[..., :r], proj[..., r:r + n], proj[..., r + n:]
    dt = nnf.softplus(linear(dt_raw, enc["dt_proj"], enc["dt_bias"]))
    return dt, b, c


def mamba_encode_step(params: dict, carry: torch.Tensor,
                      workload: torch.Tensor):
    """One arrival: ``(carry (..., di, n), workload (..., ENCODER_IN)) ->
    (new_carry, embed (..., MAMBA_EMBED))`` — ``h = exp(dt·a)·h +
    (dt·x)·B; y = h·C + x·D`` — for any leading batch dimensions (seeds
    first, with per-seed params)."""
    enc = params["enc"]
    lead = carry.shape[:-2]
    if dqn.seeded(params):
        # rows (S, M, ...) against each seed's (S, 1, ...) constants
        s = enc["D"].shape[0]
        carry = carry.reshape(s, -1, *carry.shape[-2:])
        workload = workload.reshape(s, -1, workload.shape[-1])
        a_log, d_skip = enc["A_log"][:, None], enc["D"][:, None]
    else:
        a_log, d_skip = enc["A_log"], enc["D"]
    x = nnf.silu(linear(workload, enc["in_proj"]))         # (..., di)
    dt, b, c = _mamba_ssm_params(enc, x)
    a = -torch.exp(a_log)                                  # (..., di, n)
    da = torch.exp(dt[..., None] * a)
    h = da * carry + (dt * x)[..., None] * b[..., None, :]
    y = torch.sum(h * c[..., None, :], dim=-1) + x * d_skip   # (..., di)
    emb = torch.tanh(linear(y, enc["out_proj"]))
    return h.reshape(lead + h.shape[-2:]), emb.reshape(lead + emb.shape[-1:])


def mamba_encode_sequence(params: dict, workloads: torch.Tensor,
                          h0: Optional[torch.Tensor] = None,
                          mode: Optional[str] = None,
                          n_real: Optional[int] = None):
    """Encode a ``(T, ENCODER_IN)`` arrival run in ONE launch of kernel 6
    (``kernels.ops.mamba_scan``), from carry ``h0``.  Returns ``(embeds
    (T, MAMBA_EMBED), h_final (di, n))``, step for step equal to folding
    ``mamba_encode_step``.  Rows from ``n_real`` on get ``dt = 0``, so
    ``exp(0·a)·h + 0 = h`` leaves the carry bit-exact (the daemon's pad
    rows); their embeds are not used."""
    from repro_torch.kernels import ops

    enc = params["enc"]
    x = nnf.silu(workloads @ enc["in_proj"])[None]         # (1, T, di)
    dt, b, c = _mamba_ssm_params(enc, x)
    if n_real is not None:
        real = torch.arange(x.shape[1], device=x.device) < n_real
        dt = torch.where(real[None, :, None], dt, torch.zeros_like(dt))
    a = -torch.exp(enc["A_log"])
    if h0 is None:
        h0 = mamba_carry_init(params)
    y, h_final = ops.mamba_scan(x.contiguous(), dt.contiguous(), a,
                                b.contiguous(), c.contiguous(), enc["D"],
                                h0[None].contiguous(), mode=mode)
    return torch.tanh(y[0] @ enc["out_proj"]), h_final[0]


MAMBA = register(PolicySpec(
    name="mamba",
    feature_dim=FEATURE_DIM + MAMBA_EMBED,
    embed_dim=MAMBA_EMBED,
    init=init_mamba,
    qvalues=mamba_qvalues,
    score_set=_mamba_score_set,
    encode_step=mamba_encode_step,
    encode_sequence=mamba_encode_sequence,
    carry_init=mamba_carry_init,
    hyperparams=(("d_inner", MAMBA_DI), ("ssm_state", MAMBA_STATE),
                 ("dt_rank", MAMBA_DT_RANK), ("embed", MAMBA_EMBED),
                 ("hidden", MAMBA_HIDDEN)),
))


# ---------------------------------------------------------------------------
# versioned policy checkpoints (legacy-MLP fallback for old manifests)
# ---------------------------------------------------------------------------

POLICY_CKPT_VERSION = 1


def checkpoint_metadata(spec: PolicySpec) -> dict:
    return {
        "policy_ckpt_version": POLICY_CKPT_VERSION,
        "policy": spec.name,
        "feature_dim": spec.feature_dim,
        "hyperparams": dict(spec.hyperparams),
    }


def save_checkpoint(ckpt_dir: str, step: int, params, spec: PolicySpec,
                    extra: Optional[dict] = None) -> str:
    """``checkpoint.save`` with the versioned policy record attached, so
    that any class restores without the caller naming it."""
    from repro_torch.checkpoint import ckpt

    meta = dict(extra or {})
    meta.update(checkpoint_metadata(spec))
    return ckpt.save(ckpt_dir, step, params, extra=meta)


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       default_policy: str = "mlp",
                       on_corrupt: str = "raise", device=None):
    """``(params, spec)`` from a checkpoint directory (the reference's
    format: either package's checkpoints load).  The manifest's policy
    record picks the spec; a manifest without one (the trainer's before
    the registry) takes ``default_policy``.

    ``on_corrupt="fallback"`` (the serving setting) turns an integrity
    failure — a checksum or digest mismatch, a missing leaf, a shape that
    differs, a truncated shard, a garbled manifest — into a warning and a
    FRESH init of the declared (or default) class, drawn from seed 0;
    ``"raise"`` propagates it.  A missing checkpoint always raises
    ``FileNotFoundError``.  Params land on ``device`` (the card unless
    ``"cpu"``)."""
    import warnings
    import zipfile

    from repro_torch.checkpoint import ckpt

    def fresh(spec, why: str):
        warnings.warn(
            f"checkpoint under {ckpt_dir!r} is unusable ({why}); "
            f"falling back to a fresh {spec.name!r} init",
            RuntimeWarning, stacklevel=2)
        return spec.init(torch.Generator().manual_seed(0),
                         device=device), spec

    # a garbled manifest's JSONDecodeError is a ValueError
    corrupt = (IOError, KeyError, ValueError, zipfile.BadZipFile)
    try:
        meta = ckpt.read_extra(ckpt_dir, step=step)
    except FileNotFoundError:
        raise
    except corrupt as e:
        if on_corrupt != "fallback":
            raise
        return fresh(get(default_policy), f"unreadable manifest: {e}")
    spec = get(meta.get("policy", default_policy))
    template = spec.init(torch.Generator().manual_seed(0), device="cpu")
    try:
        return ckpt.restore(ckpt_dir, template, step=step,
                            device=device), spec
    except FileNotFoundError:
        raise
    except corrupt as e:
        if on_corrupt != "fallback":
            raise
        return fresh(spec, str(e))
