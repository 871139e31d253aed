"""Comparison schedulers from the paper (PyTorch port of
``repro.core.baselines``).

1. The default kube-scheduler: the filter phase, then the two classic
   priorities the paper's §3.2 describes (LeastRequestedPriority +
   BalancedResourceAllocation) with a random tie-break among the top
   scorers ("selected at random").
2. The LSTM scorer (Table 6): one time step of a single LSTM layer with 32
   hidden units on the 6 afterstate features, FC to one score.
3. The Transformer scorer (Table 7): 6→32 projection, one post-LN encoder
   layer with 4 heads and a 128-wide FFN over a length-1 sequence (so the
   attention output is ``v``), FC to one score.

Both scorers are written out with the reference's weight layout (one
``(6, 4H)`` input matrix with gates i, f, g, o and one bias; plain
``x @ w`` products), not through ``nn.LSTM`` or ``nn.MultiheadAttention``,
whose layouts differ.  They train by regression (MSE, Adam 1e-3) onto
Table-3 rewards (``make_regression_trainer``, ``train_rl.
train_supervised_scorer``).  Init draws come from a ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from repro_torch.core import dqn, env as kenv
from repro_torch.core.schedulers import pod_rows
from repro_torch.core.types import NO_PLACEMENT, ClusterState, EnvConfig, PodSpec
from repro_torch.device import resolve_device
from repro_torch.optim import adam_init


def kube_scores(state: ClusterState, pod: PodSpec, cfg: EnvConfig) -> torch.Tensor:
    """Scoring phase on *requested* resources (what kube-scheduler sees):
    ``(..., N)`` for clusters ``(..., N)``, one pod each."""
    p = pod_rows(pod, state.base_cpu)
    cpu_free = ((state.cpu_capacity - state.cpu_requested - p.cpu_request)
                / state.cpu_capacity)
    mem_free = ((state.mem_capacity - state.mem_requested - p.mem_request)
                / state.mem_capacity)
    least_requested = 10.0 * (cpu_free + mem_free) / 2.0
    balanced = 10.0 * (1.0 - torch.abs(cpu_free - mem_free))
    return least_requested + balanced


def kube_select(step, state: ClusterState, pod: PodSpec,
                cfg: EnvConfig) -> torch.Tensor:
    """Filter, score, and a uniform tie-break (``step.tiebreak``) among the
    scores within 1e-6 of the best; ``NO_PLACEMENT`` where nothing fits
    (the tie-break would otherwise bind to a random infeasible node)."""
    ok = kenv.feasible(state, pod_rows(pod, state.base_cpu), cfg)
    neg = torch.full(ok.shape, -torch.inf, dtype=torch.float32,
                     device=ok.device)
    scores = torch.where(ok, kube_scores(state, pod, cfg), neg)
    top = ok & (scores >= torch.amax(scores, dim=-1, keepdim=True) - 1e-6)
    noise = step.tiebreak(state.n_nodes).to(ok.device)
    choice = torch.argmax(torch.where(top, noise, neg), dim=-1).to(torch.int32)
    return torch.where(torch.any(ok, dim=-1), choice, NO_PLACEMENT)


# ---------------------------------------------------------------------------
# LSTM scorer (Table 6)
# ---------------------------------------------------------------------------

LSTM_HIDDEN = 32
F32 = torch.float32


def _draw(gen: torch.Generator, shape, device, kind: str) -> torch.Tensor:
    """``kind`` "uniform" (U[-1, 1)) or "normal" draws from ``gen``."""
    if kind == "uniform":
        x = 2.0 * torch.rand(shape, generator=gen, dtype=F32,
                             device=gen.device) - 1.0
    else:
        x = torch.randn(shape, generator=gen, dtype=F32, device=gen.device)
    return x.to(device)


def init_lstm(gen: torch.Generator, hidden: int = LSTM_HIDDEN,
              device=None) -> dict:
    """Input and recurrent weights U(-1/sqrt(H), 1/sqrt(H)), a normal
    output layer scaled alike, zero biases."""
    device = resolve_device(device)
    scale = 1.0 / math.sqrt(hidden)
    return {
        "wx": _draw(gen, (6, 4 * hidden), device, "uniform") * scale,
        "wh": _draw(gen, (hidden, 4 * hidden), device, "uniform") * scale,
        "b": torch.zeros((4 * hidden,), dtype=F32, device=device),
        "w_out": _draw(gen, (hidden, 1), device, "normal") * scale,
        "b_out": torch.zeros((1,), dtype=F32, device=device),
    }


def lstm_score(params: dict, feats: torch.Tensor) -> torch.Tensor:
    """feats ``(..., 6)``, one time step from a zero state -> ``(...)``."""
    hidden = params["wh"].shape[0]
    h0 = torch.zeros(feats.shape[:-1] + (hidden,), dtype=feats.dtype,
                     device=feats.device)
    c0 = h0
    gates = feats @ params["wx"] + h0 @ params["wh"] + params["b"]
    i, f, g, o = torch.split(gates, hidden, dim=-1)
    c = torch.sigmoid(f) * c0 + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h @ params["w_out"] + params["b_out"])[..., 0]


# ---------------------------------------------------------------------------
# Transformer scorer (Table 7)
# ---------------------------------------------------------------------------

TR_DMODEL = 32
TR_HEADS = 4


def init_transformer(gen: torch.Generator, device=None) -> dict:
    """Normal weights over sqrt(fan-in), unit LayerNorm scales, zero
    biases; ``wq`` / ``wk`` are kept (the reference's layout) though a
    length-1 sequence never reaches them."""
    device = resolve_device(device)
    d = TR_DMODEL

    def zeros(shape):
        return torch.zeros(shape, dtype=F32, device=device)

    def ones(shape):
        return torch.ones(shape, dtype=F32, device=device)

    def lin(shape):
        return _draw(gen, shape, device, "normal") / math.sqrt(shape[0])

    return {
        "w_in": lin((6, d)), "b_in": zeros((d,)),
        "wq": lin((d, d)), "wk": lin((d, d)), "wv": lin((d, d)),
        "wo": lin((d, d)),
        "ln1_s": ones((d,)), "ln1_b": zeros((d,)),
        "ln2_s": ones((d,)), "ln2_b": zeros((d,)),
        "ff1": lin((d, 4 * d)), "ff1_b": zeros((4 * d,)),
        "ff2": lin((4 * d, d)), "ff2_b": zeros((d,)),
        "w_out": lin((d, 1)), "b_out": zeros((1,)),
    }


def _ln(x, s, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * s + b


def transformer_score(params: dict, feats: torch.Tensor) -> torch.Tensor:
    """Single-time-step encoder: with one key the softmax is 1, so the
    attention output is ``v`` exactly (the query and key products are
    not needed).  feats ``(..., 6)`` -> ``(...)``."""
    x = feats @ params["w_in"] + params["b_in"]
    v = x @ params["wv"]
    x = _ln(x + v @ params["wo"], params["ln1_s"], params["ln1_b"])
    ff = (torch.relu(x @ params["ff1"] + params["ff1_b"]) @ params["ff2"]
          + params["ff2_b"])
    x = _ln(x + ff, params["ln2_s"], params["ln2_b"])
    return (x @ params["w_out"] + params["b_out"])[..., 0]


# ---------------------------------------------------------------------------
# shared supervised training (Tables 6/7: MSE vs target rewards, Adam 1e-3)
# ---------------------------------------------------------------------------

ADAM = dqn.ADAM   # Adam(1e-3), the paper's optimizer for every scorer


def make_regression_trainer(score_fn: Callable) -> Callable:
    """``step(params, opt_state, feats, targets, weights=None) -> (params,
    opt_state, loss)``: one weighted-MSE gradient step with Adam.  A
    parameter the loss does not reach (the Transformer's ``wq`` / ``wk``)
    gets a zero gradient, as under ``jax.grad``."""

    def loss_fn(params, feats, targets, weights):
        return dqn.weighted_mse(score_fn(params, feats), targets, weights)

    def step(params, opt_state, feats, targets, weights=None):
        if weights is None:
            weights = torch.ones_like(targets)
        params, opt_state, loss, _ = dqn.learner_step(
            loss_fn, params, opt_state, feats, targets, weights)
        return params, opt_state, loss

    return step


def init_regression_state(init_fn: Callable, gen: torch.Generator,
                          device=None) -> Tuple[dict, dict]:
    params = init_fn(gen, device=device)
    return params, adam_init(params, ADAM)
