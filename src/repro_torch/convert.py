"""Carry weights and state across from numpy into the port's tensors.

JAX's threefry draws cannot be reproduced in PyTorch, so states and weights
made by the reference are exported as numpy arrays and turned into port
tensors here — that is how the parity tests feed both packages the same
cluster (or job fleet), the same Q-net, and the same learner state (a
reference ``TrainCarry``: params, Adam state, replay ring; the LSTM and
Transformer baselines' params).  Every
converter takes arrays of any leading shape, so the reference's stacked
seeds (``train_seeds``) come across with their seed dimension.  The dtypes
are the port's contract (float32, int32 counts, bool flags), whatever the
numpy input carried.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.replay import Replay
from repro_torch.core.types import ClusterState, PodSpec
from repro_torch.device import resolve_device
from repro_torch.sched.placement import FleetState

_INT_FIELDS = {"max_pods", "num_pods", "exp_pods"}
_BOOL_FIELDS = {"healthy", "image_cached"}


def _dtype(field: str) -> torch.dtype:
    if field in _INT_FIELDS:
        return torch.int32
    if field in _BOOL_FIELDS:
        return torch.bool
    return torch.float32


def qnet_from_numpy(params: Mapping[str, np.ndarray], device=None) -> dict:
    """Table-4 Q-net params ``{w1 (6,32), b1 (32,), w2 (32,1), b2 (1,)}``
    (each may lead with a seed dimension)."""
    device = resolve_device(device)
    return {k: torch.tensor(np.asarray(params[k], np.float32), device=device)
            for k in ("w1", "b1", "w2", "b2")}


def policy_params_from_numpy(tree, device=None):
    """A policy class's params (``core.policy``: nested dicts of arrays, e.g.
    mamba's ``{"enc": {...}, "head": {...}}``) as float32 tensors, with the
    same nesting and keys."""
    device = resolve_device(device)
    if isinstance(tree, Mapping):
        return {k: policy_params_from_numpy(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32), device=device)


# the reference's key sets of the paper's baseline scorers (Tables 6/7)
BASELINE_KEYS = {
    "lstm": ("wx", "wh", "b", "w_out", "b_out"),
    "transformer": ("w_in", "b_in", "wq", "wk", "wv", "wo", "ln1_s", "ln1_b",
                    "ln2_s", "ln2_b", "ff1", "ff1_b", "ff2", "ff2_b", "w_out",
                    "b_out"),
}


def baseline_params_from_numpy(params: Mapping[str, np.ndarray], kind: str,
                               device=None) -> dict:
    """The LSTM (``kind="lstm"``) or Transformer scorer's params, keyed as
    ``core.baselines``' inits key them, as float32 tensors; a missing or
    extra key raises."""
    device = resolve_device(device)
    keys = BASELINE_KEYS[kind]
    if set(params) != set(keys):
        raise ValueError(f"{kind} params have keys {sorted(params)}, want "
                         f"{sorted(keys)}")
    return {k: torch.tensor(np.asarray(params[k], np.float32), device=device)
            for k in keys}


def opt_state_from_numpy(state: Mapping, device=None) -> dict:
    """An Adam state (``optim.adam_init``'s keys: ``step``, ``m``, ``v``
    and, with a master dtype, ``master``): int32 step (``()`` or ``(S,)``),
    the trees with their own float dtypes.  Takes a Q-net's state and an
    LM's alike (nested trees stacked over blocks, bfloat16 moments kept
    bfloat16)."""
    device = resolve_device(device)
    out = {"step": torch.tensor(np.asarray(state["step"], np.int32),
                                device=device)}
    for key in ("m", "v", "master"):
        if key in state:
            out[key] = lm_params_from_numpy(state[key], device=device)
    return out


def replay_from_numpy(data, ptr, size, device=None) -> Replay:
    """A replay ring: the fused ``(..., n_slots, lane, F + 2)`` float32
    data; ``ptr`` and ``size`` become host ints (with a seed dimension
    they must agree across seeds, as every seed adds alike)."""
    device = resolve_device(device)
    ptrs, sizes = np.unique(np.asarray(ptr)), np.unique(np.asarray(size))
    if len(ptrs) != 1 or len(sizes) != 1:
        raise ValueError(f"rings disagree: ptr {ptrs}, size {sizes}")
    return Replay(torch.tensor(np.asarray(data, np.float32), device=device),
                  int(ptrs[0]), int(sizes[0]))


def _array_to_tensor(a, dtype, device) -> torch.Tensor:
    """One numpy array (bfloat16 arrays, as JAX exports them, included) as a
    tensor of ``dtype``, or of the array's own dtype when ``dtype`` is None."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes: exact through float32
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))        # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


def lm_params_from_numpy(tree, dtype=None, device=None):
    """The reference LM's ``init_params`` tree (nested dicts of numpy
    arrays, leaves stacked over blocks) as the port's: the same keys and
    shapes, each leaf a tensor in ``dtype`` (None keeps each array's own:
    bfloat16 stays bfloat16).  Also carries a decode cache across."""
    device = resolve_device(device)
    if isinstance(tree, Mapping):
        return {k: lm_params_from_numpy(v, dtype, device)
                for k, v in tree.items()}
    return _array_to_tensor(tree, dtype, device)


def state_from_numpy(cols, device=None) -> ClusterState:
    """A ``ClusterState`` given as numpy: a mapping or a sequence in field
    order (a reference ``ClusterState`` mapped through ``np.asarray`` works
    as it is)."""
    device = resolve_device(device)
    if not isinstance(cols, Mapping):
        cols = dict(zip(ClusterState._fields, cols))
    return ClusterState(**{
        f: torch.tensor(np.asarray(cols[f]), device=device).to(_dtype(f))
        for f in ClusterState._fields})


def fleet_from_numpy(cols, device=None):
    """A ``sched.placement.FleetState`` given as numpy (a mapping, or a
    sequence in field order): float32 columns, int32 ``num_jobs``."""
    device = resolve_device(device)
    if not isinstance(cols, Mapping):
        cols = dict(zip(FleetState._fields, cols))
    return FleetState(**{
        f: torch.tensor(np.asarray(cols[f]), device=device).to(
            torch.int32 if f == "num_jobs" else torch.float32)
        for f in FleetState._fields})


def pods_from_numpy(cpu_request, cpu_demand, mem_request, mem_demand,
                    device=None) -> PodSpec:
    """A ``PodSpec`` of float32 tensors (scalars or (B,) arrays)."""
    device = resolve_device(device)
    return PodSpec(*(torch.tensor(np.asarray(x, np.float32), device=device)
                     for x in (cpu_request, cpu_demand, mem_request,
                               mem_demand)))
