"""Mixture-of-Experts FFN, top-k routed with an optional shared expert
(port of ``repro.models.moe``).

Dispatch is sort-based, as the reference's: token->expert assignments are
sorted by expert (a stable sort), gathered into an (E, C, D) buffer under a
capacity bound C, pushed through every expert's SwiGLU in one batched
product, and combined back weighted by the router's probabilities.  A
dropped assignment contributes zero.  In ``"batched"`` dispatch every batch
row routes on its own with a capacity of its own (the reference ``vmap``s
over rows); here the rows are a batch dimension of the same tensors.  The
capacity, ``ceil(t·k / E · capacity_factor)`` rounded up to a multiple of
8 for t tokens, decides which assignments drop.  No Pallas kernel: the
reference computes all of this in XLA, and so does the port in PyTorch.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers

_F32 = torch.float32


def init_moe(gen: torch.Generator, cfg, dtype, device=None) -> dict:
    d, e = cfg.d_model, cfg.moe_num_experts
    ff = cfg.moe_d_ff or cfg.d_ff
    out_scale = 1.0 / math.sqrt(2 * cfg.num_layers * ff)
    p = {
        "router": layers.dense_init(gen, (d, e), _F32, device=device),
        "w_gate": layers.dense_init(gen, (e, d, ff), dtype, device=device),
        "w_up": layers.dense_init(gen, (e, d, ff), dtype, device=device),
        "w_down": layers.dense_init(gen, (e, ff, d), dtype, scale=out_scale,
                                    device=device),
    }
    if cfg.moe_shared_d_ff:
        p["shared"] = layers.init_mlp(gen, d, cfg.moe_shared_d_ff, cfg.act,
                                      dtype, cfg.num_layers, device)
        p["shared_gate"] = layers.dense_init(gen, (d, 1), _F32, device=device)
    return p


def _top_k(logits: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index first, as ``jax.lax.top_k`` (``torch.topk`` leaves the
    order of ties unspecified)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router_w: torch.Tensor, x: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D) -> (weights (T, k) float32, softmax over the chosen
    logits; idx (T, k) int64)."""
    logits = x.to(_F32) @ router_w
    vals, idx = _top_k(logits, top_k)
    return torch.softmax(vals, dim=-1), idx


def expert_capacity(tokens: int, cfg) -> int:
    """Slots an expert for ``tokens`` tokens of one dispatch: at least 1,
    rounded up to a multiple of 8 (the reference's, ``moe.py:96-98``)."""
    c = max(int(math.ceil(tokens * cfg.moe_top_k / cfg.moe_num_experts
                          * cfg.moe_capacity_factor)), 1)
    return ((c + 7) // 8) * 8


def dispatch_rows(idx: torch.Tensor, num_experts: int, cap: int):
    """Sort-based dispatch of R independent rows.  idx: (R, T, k) experts.

    Returns (token_of_slot (R, E·C): the row's token in each (expert,
    slot), -1 empty; slot_of_assignment (R, T, k): the slot holding each
    assignment, -1 dropped).  An expert keeps its first C assignments in
    (token, k) order; the rest drop."""
    r, t, k = idx.shape
    e, n = num_experts, num_experts * cap
    flat = idx.reshape(r, t * k)
    order = torch.argsort(flat, dim=-1, stable=True)          # by expert
    sorted_expert = torch.gather(flat, 1, order)
    sorted_token = order // k               # assignment i is token i // k
    counts = torch.zeros((r, e), dtype=torch.int64, device=idx.device)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, dim=1) - counts
    pos = (torch.arange(t * k, device=idx.device)
           - torch.gather(starts, 1, sorted_expert))
    keep = pos < cap
    slot = torch.where(keep, sorted_expert * cap + pos, -1)
    # kept assignments take distinct slots; the dropped ones go to a spare
    # column n, sliced off (no duplicate index among the kept)
    token_of_slot = torch.full((r, n + 1), -1, dtype=torch.int64,
                               device=idx.device)
    token_of_slot.scatter_(1, torch.where(keep, slot, n),
                           torch.where(keep, sorted_token, -1))
    token_of_slot = token_of_slot[:, :n]
    # The reference's last-slot rule (repro/models/moe.py:67-72): it
    # scatters every dropped assignment's -1 into slot E·C - 1, which is in
    # range, so mode="drop" drops none of them, and the writes land in
    # sorted order.  The last expert's kept assignment at slot E·C - 1
    # comes after every other expert's drops but before its own: the slot
    # ends empty unless the last expert holds exactly C assignments.  Its
    # slot_of_assignment still points there, so that token gets zero.
    last = token_of_slot[:, n - 1]
    token_of_slot[:, n - 1] = torch.where(counts[:, e - 1] == cap, last, -1)
    slot_of_assignment = torch.empty_like(flat)
    slot_of_assignment.scatter_(1, order, slot)
    return token_of_slot, slot_of_assignment.reshape(r, t, k)


def dispatch_indices(idx: torch.Tensor, num_experts: int, capacity: int):
    """One dispatch over all of idx (T, k): (token_of_slot (E·C,),
    slot_of_assignment (T, k)), the reference's values bit for bit."""
    tos, soa = dispatch_rows(idx[None], num_experts, capacity)
    return tos[0], soa[0]


def apply_moe(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  ``cfg.moe_dispatch == "batched"`` (and
    B > 1): each batch row is a dispatch of its own, capacity per row;
    otherwise one dispatch over all B·S tokens."""
    b, s, d = x.shape
    rows = x if cfg.moe_dispatch == "batched" and b > 1 else x.reshape(
        1, b * s, d)
    return _apply_rows(params, rows, cfg).reshape(b, s, d)


def _apply_rows(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """R dispatches of T tokens each, x (R, T, D) -> (R, T, D)."""
    r, t, d = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    cap = expert_capacity(t, cfg)
    weights, idx = route(params["router"], x.reshape(r * t, d), k)
    weights, idx = weights.reshape(r, t, k), idx.reshape(r, t, k)
    token_of_slot, slot_of_assignment = dispatch_rows(idx, e, cap)

    # gather each row's tokens into its expert buffers: (R, E, C, D)
    gathered = torch.gather(
        x, 1, token_of_slot.clamp(min=0)[..., None].expand(-1, -1, d))
    gathered = torch.where((token_of_slot >= 0)[..., None], gathered,
                           torch.zeros((), dtype=x.dtype, device=x.device))
    gathered = gathered.reshape(r, e, cap, d)

    # every expert's SwiGLU (silu whatever cfg.act, as the reference)
    h = F.silu(torch.einsum("recd,edf->recf", gathered, params["w_gate"]))
    h = h * torch.einsum("recd,edf->recf", gathered, params["w_up"])
    out_buf = torch.einsum("recf,efd->recd", h,
                           params["w_down"]).reshape(r, e * cap, d)

    # combine, weighted; dropped assignments (slot -1) contribute zero
    safe = slot_of_assignment.clamp(min=0).reshape(r, t * k)
    per_assign = torch.gather(out_buf, 1, safe[..., None].expand(-1, -1, d))
    w = weights * (slot_of_assignment >= 0)
    combined = torch.einsum("rtkd,rtk->rtd",
                            per_assign.reshape(r, t, k, d).to(_F32), w)
    out = combined.to(x.dtype)

    if "shared" in params:
        xf = x.reshape(r * t, d)
        shared = layers.apply_mlp(params["shared"], xf, cfg.act)
        gate = torch.sigmoid(xf.to(_F32) @ params["shared_gate"])
        out = out + (gate * shared.to(_F32)).to(x.dtype).reshape(r, t, d)
    return out


def load_balance_loss(router_w: torch.Tensor, x: torch.Tensor,
                      top_k: int) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss (mean over tokens)."""
    t = x.shape[0] * x.shape[1]
    logits = x.reshape(t, -1).to(_F32) @ router_w
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    _, idx = _top_k(logits, top_k)
    hard = torch.zeros_like(probs).scatter_(1, idx, 1.0)
    frac_tokens = hard.mean(dim=0) / top_k
    frac_probs = probs.mean(dim=0)
    return logits.shape[-1] * torch.sum(frac_tokens * frac_probs)
