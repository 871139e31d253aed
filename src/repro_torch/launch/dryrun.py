"""Dry run for one card (port of ``repro.launch.dryrun``): plan every
(architecture x shape) cell, print its memory and cost, and dump the
roofline terms to JSON, one file a cell plus ``summary.json``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
        --shape train_4k --micro 256 --check

Where the reference lowers and compiles a cell for a TPU mesh and reads
XLA's memory and cost analyses, the port traces the cell's step once on
fake tensors (``torch._subclasses.fake_tensor``), on the CPU and with no
device, through the card's own path (``CardStandIn``): every kernel
wrapper allocates its outputs and scratch as on the card, and each launch
is noted instead of run.  A cell is planned on one card by default
(``--mesh-shape 1,1``); ``--multi-pod`` and ``--mesh-shape`` plan a mesh,
whose per-card argument bytes follow ``launch.sharding``'s rules.

A cell's JSON has the reference's keys:

* ``memory``, per card: ``argument_size_in_bytes`` (params, the AdamW
  state of ``steps.default_adam`` and the batch; for decode the params,
  the cache and the tokens, the index being a host int), then from one
  traced step ``output_size_in_bytes`` and ``alias_size_in_bytes`` (train
  outputs take the place of params and state, the step writing nothing
  in place; decode writes the cache in place, so it is output and alias
  both) and ``temp_size_in_bytes``, an ESTIMATE of the step's scratch:
  the peak of live bytes of the storages the traced step creates
  (``LiveBytes``), less its outputs', so that argument + temp + output -
  alias is the traced peak (``hbm_bytes_per_chip``, the reference's
  formula).  A train step is traced at ``min(num_microbatches, 2)``
  microbatches: every later one repeats the second's live set, the
  float32 gradient sum included.  The caching allocator's rounding and
  cuBLAS's workspace are not in it.  The step is traced only on one card
  and only while it fits: not where its arguments alone pass the card's
  memory, and the trace stops where its live bytes do (``not_traced``
  says which; those three keys are then null and the cell does not fit).
  On a mesh of several cards they are unknown: the port runs a step on
  one card.
* ``cost.flops``: the step's matmul-class FLOPs (``FlopCounterMode``; a
  noted launch counts what its kernel's plain version counts there,
  ``kernel_flops``) over the global batch, counted on one microbatch of
  the config cut to one and to two blocks (and encoder layers) and scaled
  to its depth and microbatches.  XLA's ``bytes accessed`` and
  ``transcendentals`` have no counterpart.
* ``collectives``: PyTorch produces no HLO (``collective_bytes_from_hlo``
  has nothing to read): 0 on one card, unknown on a planned mesh.
* ``fits_hbm_80g``: ``hbm_bytes_per_chip`` against the visible card's
  total memory, or the H100 SXM's 80 GB where no card is visible
  (``hbm_limit``, under ``hbm_limit`` in the JSON); null on a mesh.
* ``model_params``, ``active_params``, ``tokens``, ``kind``,
  ``num_microbatches`` (``--micro`` over ``steps.num_microbatches``),
  ``analytic_hbm_bytes_per_chip`` and ``roofline`` (``roofline_terms``,
  H100 constants; ``collective_s`` null where the bytes are unknown).

A train cell is planned at its config's ``remat`` ("full" for every full
config), or at ``--remat``'s (the reference's flag, into the config's
overrides): the traced step is then the rematerialized one, its temp the
peak with each block's recompute inside the backward, its ``cost.flops``
the count with the re-forward (less each block's last product, which the
recompute does not reach), its launches the recomputed ones too.

``check_cell`` runs a planned step on the card (train cells cut to the
traced microbatches); ``--check`` does so for every cell the plan says
fits.  The reference's ``--causal-buckets``, ``--no-seq-shard`` and
``--decode-reshard`` would change nothing here (the port ignores
``causal_buckets`` and ``act_sharding``), so they are not taken.  The
exit status is 1 if a cell failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import warnings
import weakref
from typing import Any, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      get_config, list_archs,
                                      shape_applicable)
from repro_torch.device import resolve_device
from repro_torch import kernels
from repro_torch.kernels import (_build, decode_attention as da,
                                 flash_attention as fa, mamba_scan as ms)
from repro_torch.launch import shapes as shp, sharding, steps
from repro_torch.launch.sharding import ONE_CARD, MeshShape
from repro_torch.models import model as mdl
from repro_torch.optim import adam_init
from repro_torch.roofline import flops
from repro_torch.roofline.analysis import roofline_terms

HBM_80G = 80e9                 # the H100 SXM's memory, where no card is seen
TRACED_MICROBATCHES = 2
DEFAULT_OUT = "dryrun_out"
WRAPPERS = (fa.flash_attention, fa.flash_attention_bwd, da.decode_attention,
            ms.mamba_scan, ms.mamba_scan_bwd)


def hbm_limit():
    """(bytes, source): the visible card's total memory, else the H100
    SXM's 80 GB."""
    if torch.cuda.is_available():
        return (torch.cuda.get_device_properties(0).total_memory,
                torch.cuda.get_device_name(0))
    return HBM_80G, "H100 SXM 80 GB (no card visible)"


def kernel_flops(name: str, args) -> float:
    """The matmul-class FLOPs ``FlopCounterMode`` counts for the plain
    version of the kernel launched as ``name`` with ``args`` (the launch's
    arguments): attention's two products (four in the forward, ten in the
    backward, D a (query, key) pair, over every key, masked or not), none
    in the selective scan, whose plain version is elementwise."""
    if name == "flash_attention":
        b, sq, skv, hq, d = args[5], args[6], args[7], args[8], args[10]
        return 4.0 * b * hq * sq * skv * d
    if name == "flash_attention_bwd":
        b, sq, skv, hq, d = args[12], args[13], args[14], args[15], args[17]
        return 10.0 * b * hq * sq * skv * d
    if name == "decode_attention":
        b, hq, s, d = args[6], args[7], args[9], args[10]
        return 4.0 * b * hq * s * d
    if name in ("mamba_scan", "mamba_scan_states", "mamba_scan_bwd"):
        return 0.0
    raise KeyError(f"no FLOP count for kernel {name!r}")


class CardStandIn:
    """The card's path on fake CPU tensors, for as long as it is entered:
    ``kernels.on_card``, the one predicate every dispatch site asks, says
    yes, so each wrapper checks its inputs and allocates its outputs and
    scratch as on the card, and ``_build.launch`` only notes the launch
    (``launched``: (kernel, FLOPs)) instead of running it.  The wrappers' launch counts are put
    back on exit: a plan launches nothing.  ``decode_attention``'s plan
    gets a nominal ``Capacity`` (it sets the grid, not the memory)."""

    def __init__(self):
        self.launched = []

    def _launch(self, name, source, argtypes, device, *args):
        self.launched.append((name, kernel_flops(name, args)))

    def __enter__(self):
        self._saved = [(kernels, "on_card", kernels.on_card),
                       (_build, "launch", _build.launch),
                       (da, "capacity", da.capacity)]
        self._counts = [fn.launches for fn in WRAPPERS]
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()      # the wrappers' alignment checks
        warnings.filterwarnings("ignore", "Accessing the data pointer of "
                                "FakeTensor", UserWarning)
        kernels.on_card = lambda device: True
        _build.launch = self._launch
        # the split count it sets changes the grid, not what is allocated
        da.capacity = lambda *args: da.Capacity(128, (1,) * da.CLUSTER_MAX,
                                                132)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)
        for fn, count in zip(WRAPPERS, self._counts):
            fn.launches = count
        self._warnings.__exit__(*exc)

    @property
    def flops(self) -> float:
        return sum(f for _, f in self.launched)


class PastLimit(RuntimeError):
    """A traced step's live bytes passed ``LiveBytes``' limit."""


class LiveBytes(TorchDispatchMode):
    """Live bytes of the storages that operations create while it is
    entered, and their peak: each new storage is added when an operation
    returns it and taken off when it dies (a finalizer on the storage).
    Storages made before (``known``) are never counted.  Past ``limit``
    live bytes the operation raises ``PastLimit`` (``passed`` is set)."""

    def __init__(self, known=(), limit: float = math.inf):
        super().__init__()
        self.live = self.peak = self.ops = 0
        self.passed = False
        self.limit = limit
        self.created: Dict[int, int] = {}
        self._known = {t.untyped_storage()._cdata for t in known}

    def _dead(self, key):
        self.live -= self.created.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            storage = t.untyped_storage()
            key = storage._cdata
            if key in self._known or key in self.created:
                continue
            self.created[key] = storage.nbytes()
            self.live += self.created[key]
            self.peak = max(self.peak, self.live)
            weakref.finalize(storage, self._dead, key)
        if self.live > self.limit:
            self.passed = True
            raise PastLimit(f"{self.live} live bytes at operation {self.ops}")
        return out




def _leaves(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _storages(tree) -> Dict[int, int]:
    """{storage key: bytes} of the tensors in ``tree``."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in _leaves(tree)}


@dataclasses.dataclass
class BuiltCell:
    """A cell's step and its arguments, on fake or real tensors.
    ``parts`` names the arguments (train: ``params``, ``opt_state``,
    ``batch``; prefill: ``params``, ``batch``; decode: ``params``,
    ``cache``, ``tokens``); the step runs on a batch of ``rows``
    (train: ``microbatches`` of the cell's ``num_microbatches``)."""

    cfg: ModelConfig
    shape: ShapeConfig
    num_microbatches: int
    microbatches: int
    rows: int
    step: Any
    parts: Dict[str, Any]

    @property
    def args(self) -> tuple:
        return tuple(self.parts.values())


def cell_config(arch: str, overrides: Optional[dict] = None) -> ModelConfig:
    cfg = get_config(arch)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def num_microbatches(arch: str, shape: ShapeConfig, micro: int = 0) -> int:
    """``micro`` (``--micro``, a count) over ``steps.num_microbatches``;
    1 for prefill and decode."""
    if shape.kind != "train":
        return 1
    nm = micro or steps.num_microbatches(arch, shape.global_batch)
    if shape.global_batch % nm:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"into {nm} microbatches")
    return nm


def _real(specs: dict, cfg: ModelConfig, gen: torch.Generator, device):
    """Real tensors on ``device`` for a dict of input specs: token ids
    uniform below the vocabulary, a loss mask of ones, the modality stubs
    0.02 N(0, 1)."""
    def real(key, t):
        if t.dtype == torch.int32:
            return torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                                 device=device, dtype=torch.int32)
        if key == "loss_mask":
            return torch.ones(t.shape, device=device)
        return (0.02 * torch.randn(t.shape, generator=gen, device=device)
                ).to(t.dtype)

    return {k: real(k, t) for k, t in specs.items()}


def build_cell(arch: str, shape_name: str, *, micro: int = 0,
               microbatches: Optional[int] = None,
               overrides: Optional[dict] = None,
               cfg: Optional[ModelConfig] = None, params=None,
               mode: Optional[FakeTensorMode] = None,
               gen: Optional[torch.Generator] = None,
               device=None) -> BuiltCell:
    """One cell's step and its arguments.  Inside ``mode`` (and given it)
    every argument is a fake tensor (``launch.shapes``); with a generator
    ``gen`` they are real, drawn from it, on ``device``.  A train step runs
    ``microbatches`` of the cell's microbatches (``TRACED_MICROBATCHES``
    at most by default), its batch cut to them.  ``cfg`` plans another
    config in the arch's place (a cut depth); ``params`` reuses a tree."""
    cfg = cfg or cell_config(arch, overrides)
    shape = SHAPES[shape_name]
    nm = num_microbatches(arch, shape, micro)
    runs = microbatches or min(nm, TRACED_MICROBATCHES)
    rows = shape.global_batch // nm * runs
    cut = dataclasses.replace(shape, global_batch=rows)
    specs = shp.input_specs(cfg, cut, mode=mode or FakeTensorMode())
    batch = specs["batch"] if gen is None else _real(specs["batch"], cfg,
                                                     gen, device)
    if params is None:
        params = (mdl.init_params(gen, cfg, device=device) if gen is not None
                  else shp.params_specs(cfg, mode))
    if shape.kind == "train":
        adam_cfg = steps.default_adam(cfg)
        opt = adam_init(params, adam_cfg)
        step, _ = steps.make_train_step(cfg, adam_cfg, num_microbatches=runs)
        parts = {"params": params, "opt_state": opt, "batch": batch}
    elif shape.kind == "prefill":
        step = steps.make_prefill_step(cfg)
        parts = {"params": params, "batch": batch}
    else:
        cache = (specs["cache"] if gen is None else
                 mdl.init_cache(cfg, rows, shape.seq_len, device=device))
        decode = steps.make_decode_step(cfg)

        def step(params, cache, tokens):
            return decode(params, tokens, cache, shape.seq_len - 1)

        parts = {"params": params, "cache": cache, "tokens": batch}
    return BuiltCell(cfg, shape, nm, runs, rows, step, parts)


def _cut_depth(cfg: ModelConfig, blocks: int, enc_layers: int) -> ModelConfig:
    return dataclasses.replace(
        cfg, num_layers=len(mdl.block_spec(cfg)) * blocks,
        enc_layers=enc_layers)


def step_flops(arch: str, shape_name: str, mode: FakeTensorMode, *,
               micro: int = 0, cfg: Optional[ModelConfig] = None,
               scaled: bool = True) -> float:
    """The cell's step FLOPs over its global batch (the module's
    docstring), counted on one microbatch and multiplied by their count.
    ``scaled``: counted on the config cut to one and to two blocks (and,
    for an encoder, encoder layers), then ``f(1) + (blocks - 1) (f(2) -
    f(1))``; else on the whole depth."""
    cfg = cfg or cell_config(arch)

    def count(c):
        with mode:
            cell = build_cell(arch, shape_name, micro=micro, microbatches=1,
                              cfg=c, mode=mode)
            with CardStandIn() as card, FlopCounterMode(display=False) as fc:
                if cell.shape.kind == "train":   # AdamW has no product
                    steps.value_and_grad(c, cell.parts["params"],
                                         cell.parts["batch"])
                else:
                    cell.step(*cell.args)
        return fc.get_total_flops() + card.flops

    nm = num_microbatches(arch, SHAPES[shape_name], micro)
    if not scaled:
        return count(cfg) * nm
    enc = 1 if cfg.is_encoder_decoder else 0
    one = count(_cut_depth(cfg, 1, enc))
    total = one + (mdl.num_blocks(cfg) - 1) * (
        count(_cut_depth(cfg, 2, enc)) - one)
    if enc:
        total += (cfg.enc_layers - 1) * (count(_cut_depth(cfg, 1, 2)) - one)
    return total * nm


def _argument_specs(cfg: ModelConfig, shape: ShapeConfig, parts: dict,
                    mesh: MeshShape) -> dict:
    p_specs = sharding.param_specs(parts["params"], cfg, mesh)
    specs = {"params": p_specs}
    if "opt_state" in parts:
        specs["opt_state"] = sharding.opt_state_specs(parts["opt_state"],
                                                      p_specs, mesh)
    if "cache" in parts:
        specs["cache"] = sharding.cache_specs(parts["cache"], cfg, mesh,
                                              shape.global_batch)
        specs["tokens"] = sharding.input_sharding(mesh, parts["tokens"])
    else:
        specs["batch"] = sharding.input_sharding(mesh, parts["batch"])
    return specs


def _traced_memory(cell: BuiltCell, limit: float) -> dict:
    """Run ``cell``'s step once (inside its fake mode) under
    ``CardStandIn`` and ``LiveBytes``: its output, alias and temp bytes
    (the module's docstring) and the launches it made; or, where the
    arguments and the live bytes pass ``limit``, where the trace stopped."""
    args = _storages(cell.args)
    live = LiveBytes(_leaves(cell.args), limit - sum(args.values()))
    try:
        with CardStandIn() as card, live:
            out = cell.step(*cell.args)
    except Exception:
        if not live.passed:
            raise
        return {"output_size_in_bytes": None, "alias_size_in_bytes": None,
                "temp_size_in_bytes": None,
                "not_traced": (f"the trace stopped at operation {live.ops}, "
                               f"where the arguments and {live.live} live "
                               f"bytes passed the card's {limit:.0f}")}
    outs = _storages(out)
    created = sum(n for k, n in outs.items() if k not in args)
    launched: Dict[str, int] = {}
    for name, _ in card.launched:
        launched[name] = launched.get(name, 0) + 1
    return {"output_size_in_bytes": sum(outs.values()),
            "alias_size_in_bytes": sum(n for k, n in outs.items()
                                       if k in args),
            "temp_size_in_bytes": live.peak - created,
            "launches": launched}


def plan_cell(arch: str, shape_name: str, mesh: MeshShape = ONE_CARD, *,
              micro: int = 0, overrides: Optional[dict] = None,
              cfg: Optional[ModelConfig] = None,
              mode: Optional[FakeTensorMode] = None, params=None,
              limit: Optional[float] = None) -> dict:
    """The plan of one applicable cell: ``memory``, ``cost``,
    ``num_microbatches`` and ``plan_s`` (``run_cell`` adds the rest), on
    fake tensors under ``mode`` (a fresh one by default; ``params`` a tree
    made under it).  The step is traced only on one card, and only where
    its arguments fit in ``limit`` bytes (``hbm_limit()``'s by default):
    a step that cannot start there has no peak to find."""
    t0 = time.perf_counter()
    cfg = cfg or cell_config(arch, overrides)
    mode = mode or FakeTensorMode()
    shape = SHAPES[shape_name]
    limit = hbm_limit()[0] if limit is None else limit
    with mode:
        whole = build_cell(arch, shape_name, micro=micro, cfg=cfg, mode=mode,
                           params=params,
                           microbatches=num_microbatches(arch, shape, micro))
        cell = whole if whole.microbatches <= TRACED_MICROBATCHES else \
            build_cell(arch, shape_name, micro=micro, cfg=cfg, mode=mode,
                       params=whole.parts["params"])
        args = sharding.per_card_bytes(
            whole.parts, _argument_specs(cfg, shape, whole.parts, mesh), mesh)
        memory = {"argument_size_in_bytes": args,
                  "argument_parts": {k: _nbytes(v)
                                     for k, v in whole.parts.items()},
                  "traced_argument_bytes": _nbytes(cell.args),
                  "traced_rows": cell.rows,
                  "traced_microbatches": cell.microbatches}
        if mesh.n_cards > 1:
            why = (f"not traced: the port runs a step on one card, not on a "
                   f"{mesh.name} mesh")
        elif args > limit:
            why = (f"not traced: the arguments alone ({args} bytes) exceed "
                   f"the card's {limit:.0f}")
        else:
            why = None
            memory.update(_traced_memory(cell, limit))
    if why:
        memory.update(output_size_in_bytes=None, alias_size_in_bytes=None,
                      temp_size_in_bytes=None, not_traced=why)
    cost = {"flops": step_flops(arch, shape_name, mode, micro=micro,
                                cfg=cfg)}
    return dict(plan_s=time.perf_counter() - t0, memory=memory, cost=cost,
                num_microbatches=whole.num_microbatches)


def _collectives(mesh: MeshShape) -> dict:
    if mesh.n_cards == 1:
        return {"total_bytes": 0, "per_op_bytes": {},
                "reason": "one card: a step sends nothing"}
    return {"total_bytes": None, "per_op_bytes": None,
            "reason": (f"unknown: PyTorch produces no HLO to parse "
                       f"(collective_bytes_from_hlo), and the port runs no "
                       f"{mesh.name} mesh")}


def run_cell(arch: str, shape_name: str, mesh: MeshShape = ONE_CARD, *,
             micro: int = 0, overrides: Optional[dict] = None,
             cfg: Optional[ModelConfig] = None,
             mode: Optional[FakeTensorMode] = None, params=None,
             limit=None) -> Dict[str, Any]:
    """One cell's JSON (the module's docstring), printed as one line;
    ``skipped`` with the reference's reason where ``shape_applicable``
    says so.  ``limit``: ``hbm_limit()``'s pair, for a caller of many
    cells to ask once."""
    cfg = cfg or cell_config(arch, overrides)
    shape = SHAPES[shape_name]
    cell: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                            "mesh": mesh.name}
    tag = f"[{arch} × {shape_name} × {mesh.name}]"
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        cell.update(status="skipped", reason=why)
        print(f"{tag} SKIP: {why}")
        return cell
    limit_bytes, limit_src = limit or hbm_limit()
    plan = plan_cell(arch, shape_name, mesh, micro=micro, cfg=cfg, mode=mode,
                     params=params, limit=limit_bytes)
    mem, nm = plan["memory"], plan["num_microbatches"]
    coll = _collectives(mesh)
    analytic = flops.cell_flops(cfg, shape, remat_full=cfg.remat == "full")
    hbm = flops.cell_hbm_bytes(cfg, shape, mesh.n_cards, num_microbatches=nm,
                               tp=mesh.shape["model"])
    cell.update(status="ok", n_chips=mesh.n_cards, remat=cfg.remat, **plan,
                collectives=coll, model_params=cfg.param_count(),
                active_params=cfg.active_param_count(),
                tokens=shape.global_batch * (1 if shape.is_decode
                                             else shape.seq_len),
                kind=shape.kind, analytic_hbm_bytes_per_chip=hbm)
    if mem["temp_size_in_bytes"] is None:
        used = None
        fits = False if mesh.n_cards == 1 else None
    else:
        used = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                + mem["output_size_in_bytes"] - mem["alias_size_in_bytes"])
        fits = used <= limit_bytes
    cell["hbm_bytes_per_chip"] = used
    cell["fits_hbm_80g"] = fits
    cell["hbm_limit"] = {"bytes": limit_bytes, "source": limit_src}
    roof = roofline_terms(
        n_chips=mesh.n_cards, hlo_flops_global=analytic["hlo_flops"],
        model_flops=analytic["model_flops"], hbm_bytes_per_chip=hbm,
        collective_bytes_per_chip=float(coll["total_bytes"] or 0))
    if coll["total_bytes"] is None:
        roof["collective_s"] = None
    cell["roofline"] = roof
    temp = mem["temp_size_in_bytes"]
    print(f"{tag} OK plan={plan['plan_s']:.1f}s "
          f"arg={mem['argument_size_in_bytes'] / 1e9:.2f}GB "
          f"temp={'-' if temp is None else round(temp / 1e9, 2)}GB "
          f"fits80G={fits} dominant={roof['dominant']} "
          f"frac={roof['roofline_fraction']:.2f}")
    return cell


def check_cell(arch: str, shape_name: str, mesh: MeshShape = ONE_CARD,
               micro: int = 0, device=None, *, n_steps: int = 3,
               overrides: Optional[dict] = None,
               cfg: Optional[ModelConfig] = None, seed: int = 0) -> dict:
    """Run a planned cell's step on the card: a train cell at its traced
    microbatches (``build_cell``; its global batch cut to ``rows``),
    ``n_steps`` steps; prefill and decode ``n_steps`` times the one step
    (decode at the cache's last index).  Weights and inputs are random from
    ``seed``.  Returns the bytes of the arguments (``argument_bytes``: the
    tensors' own, to hold against the plan's ``traced_argument_bytes``;
    ``allocated_argument_bytes``: what the caching allocator took for them),
    the peak the allocator saw beyond what was allocated before
    (``peak_bytes``), each step's synchronized ms and, for train cells,
    the last loss.  The device is CUDA unless another is given; a one-card
    mesh only."""
    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"check_cell measures a card, got {device}")
    if mesh.n_cards != 1:
        raise ValueError(f"one card runs no {mesh.name} mesh")
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    cell = build_cell(arch, shape_name, micro=micro, overrides=overrides,
                      cfg=cfg, gen=gen, device=device)
    torch.cuda.synchronize(device)
    result = {"argument_bytes": _nbytes(cell.args),
              "allocated_argument_bytes":
              torch.cuda.memory_allocated(device) - before,
              "rows": cell.rows, "microbatches": cell.microbatches,
              "device": torch.cuda.get_device_name(device)}
    step, train, args = cell.step, cell.shape.kind == "train", cell.args
    del cell                    # a train step's outputs replace its state
    torch.cuda.reset_peak_memory_stats(device)
    times, loss = [], None
    for _ in range(n_steps):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize(device)
        times.append(1e3 * (time.perf_counter() - t0))
        if train:
            args = (out[0], out[1], args[2])
            loss = float(out[2]["loss"])
        del out
    result.update(peak_bytes=torch.cuda.max_memory_allocated(device) - before,
                  ms=times, loss=loss)
    del args
    torch.cuda.empty_cache()
    return result


def _mesh(args) -> MeshShape:
    if args.multi_pod:
        return sharding.production_mesh(multi_pod=True)
    dims = tuple(int(x) for x in args.mesh_shape.split(","))
    return MeshShape(("data", "model"), dims)


def _plan_arch(arch: str, shape_names, mesh: MeshShape, micro: int,
               overrides: Optional[dict], limit) -> list:
    """``run_cell`` over one arch's shapes on one fake tree; a cell that
    raises is ``failed`` with its error."""
    mode = FakeTensorMode()
    try:
        params = shp.params_specs(cell_config(arch, overrides), mode)
    except Exception:  # noqa: BLE001 (its cells fail below, each)
        params = None
    cells = []
    for shape_name in shape_names:
        try:
            cell = run_cell(arch, shape_name, mesh, micro=micro,
                            overrides=overrides, mode=mode, params=params,
                            limit=limit)
        except Exception as e:  # noqa: BLE001 (a cell's failure is data)
            cell = {"arch": arch, "shape": shape_name, "mesh": mesh.name,
                    "status": "failed", "error": str(e)}
            print(f"[{arch} × {shape_name}] FAILED: {e}")
            traceback.print_exc()
        cells.append(cell)
    return cells


def plan_cells(archs, shape_names, mesh: MeshShape = ONE_CARD, *,
               micro: int = 0, overrides: Optional[dict] = None,
               out_dir: Optional[str] = None, check: bool = False,
               device=None) -> list:
    """``run_cell`` over every (arch, shape), one fake tree an arch.  With
    ``out_dir`` each cell's JSON is written there as the reference names
    it, and ``summary.json``; with ``check`` each cell that fits is also
    run on the card (``check_cell``, in this process) and its result kept
    under ``check``."""
    limit = hbm_limit()
    print(f"dry run: fits_hbm_80g against {limit[0]} bytes ({limit[1]})")
    results = [cell for arch in archs
               for cell in _plan_arch(arch, shape_names, mesh, micro,
                                      overrides, limit)]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    for cell in results:
        if check and cell.get("fits_hbm_80g"):
            cell["check"] = check_cell(cell["arch"], cell["shape"], mesh,
                                       micro, device, overrides=overrides)
        if out_dir:
            tag = mesh.name.replace("x", "_")
            with open(f"{out_dir}/{cell['arch']}_{cell['shape']}_{tag}.json",
                      "w") as f:
                json.dump(cell, f, indent=2, default=str)
    n = {s: sum(r["status"] == s for r in results)
         for s in ("ok", "skipped", "failed")}
    print(f"\nDRY-RUN SUMMARY: {n['ok']} ok, {n['skipped']} skipped "
          f"(documented), {n['failed']} failed")
    if out_dir:
        with open(f"{out_dir}/summary.json", "w") as f:
            json.dump(results, f, indent=2, default=str)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="plan the 2 x 16 x 16 (pod, data, model) mesh")
    ap.add_argument("--mesh-shape", default="1,1",
                    help='a (data, model) mesh, e.g. "16,16"; default one card')
    ap.add_argument("--micro", type=int, default=0,
                    help="microbatch-count override")
    ap.add_argument("--remat", default="", choices=["", "none", "dots",
                                                    "full"])
    ap.add_argument("--moe-dispatch", default="",
                    choices=["", "global", "batched"])
    ap.add_argument("--cache-dtype", default="")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--check", action="store_true",
                    help="run every cell that fits on the card (check_cell)")
    args = ap.parse_args(argv)
    overrides = {}
    if args.remat:
        overrides["remat"] = args.remat
    if args.moe_dispatch:
        overrides["moe_dispatch"] = args.moe_dispatch
    if args.cache_dtype:
        overrides["cache_dtype"] = args.cache_dtype
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shape_names = (list(SHAPES) if (args.all or not args.shape)
                   else [args.shape])
    results = plan_cells(archs, shape_names, _mesh(args), micro=args.micro,
                         overrides=overrides or None, out_dir=args.out,
                         check=args.check)
    raise SystemExit(1 if any(r["status"] == "failed" for r in results)
                     else 0)


if __name__ == "__main__":
    main()
