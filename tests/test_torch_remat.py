"""Rematerialization in the port's LM training (``cfg.remat``) on the CPU.

The port runs each block under ``torch.utils.checkpoint`` as the
reference's ``_scan_blocks`` runs its scan body under ``jax.checkpoint``:
"full" keeps only the blocks' inputs, "dots" also the outputs of the
products with no batch dimensions (``aten.mm`` / ``aten.addmm``), "none"
everything.  Checked here, for one arch a family at smoke size in
float32:
* the loss, the metrics and every gradient leaf under "full" and "dots"
  against ``jax.jit(jax.value_and_grad(loss_and_metrics))`` of the
  reference with the same ``remat`` (its checkpoint active), within
  ``TOL`` of ``test_torch_lm_train.py``;
* the same under "full" and "dots" against the port's own "none", bit for
  bit (the recompute repeats the forward's operations on the same inputs);
* ``make_train_step`` over 3 steps of 2 microbatches, bit for bit;
* prefill and decode: no checkpoint, the same operations and results;
* the mapping of every value as the reference's ``_remat_policy``;
* what the forward keeps: the storages made inside the blocks that are
  still alive when the forward ends are only the blocks' outputs (each the
  next block's input) under "full", and those plus every ``mm`` /
  ``addmm`` output under "dots"; no block's operation saves a tensor
  through an outer ``saved_tensors_hooks`` under either.
"""
import dataclasses
import gc
import weakref

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro.models import model as jmdl
from repro_torch import convert
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmdl
from repro_torch.optim import adam_init, tree_leaves
from test_torch_lm_train import (FAMILY_ARCHS, TOL, _cfgs, _jax_batch,
                                 _leaves_close, _np_batch, _torch_batch)

REMATS = ("full", "dots")


def _remat_cfgs(arch, remat):
    jc, tc = _cfgs(arch)
    return (dataclasses.replace(jc, remat=remat),
            dataclasses.replace(tc, remat=remat))


def _params(jc):
    jp = jmdl.init_params(jax.random.PRNGKey(1), jc)
    return jp, convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                            device="cpu")


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_gradients_under_remat_match_the_reference(arch, remat):
    jc, tc = _remat_cfgs(arch, remat)
    jp, tp = _params(jc)
    batch = _np_batch(jc, 2, 16, seed=2)
    (_, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmdl.loss_and_metrics(p, jc, b), has_aux=True))(
            jp, _jax_batch(batch))
    tm, tg = tsteps.value_and_grad(tc, tp, _torch_batch(batch))
    assert set(tm) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=TOL,
                                   atol=TOL, err_msg=key)
    _leaves_close(tg, jg, TOL, (arch, remat))


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    return all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_gradients_under_remat_equal_nones_bit_for_bit(arch, remat):
    jc, tc = _remat_cfgs(arch, remat)
    _, tp = _params(jc)
    batch = _torch_batch(_np_batch(jc, 2, 16, seed=4))
    got = tsteps.value_and_grad(tc, tp, batch)
    want = tsteps.value_and_grad(dataclasses.replace(tc, remat="none"), tp,
                                 batch)
    assert _equal_trees(got[0], want[0]) and _equal_trees(got[1], want[1])


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", ["olmo-1b", "qwen2-moe-a2.7b",
                                  "whisper-medium"])
def test_train_step_under_remat_equals_nones_bit_for_bit(arch, remat):
    jc, tc = _remat_cfgs(arch, remat)
    _, tp = _params(jc)
    runs = []
    for cfg in (tc, dataclasses.replace(tc, remat="none")):
        step, adam_cfg = tsteps.make_train_step(cfg, num_microbatches=2,
                                                total_steps=50)
        params, opt = tp, adam_init(tp, adam_cfg)
        metrics = []
        for i in range(3):
            batch = _torch_batch(_np_batch(jc, 4, 12, seed=10 + i))
            params, opt, m = step(params, opt, batch)
            metrics.append(m)
        runs.append((params, opt, metrics))
    for got, want in zip(*runs):
        if isinstance(got, list):
            assert all(_equal_trees(g, w) for g, w in zip(got, want))
        else:
            assert _equal_trees(got, want)


class _Ops(TorchDispatchMode):
    """The aten operations run while it is entered, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_prefill_and_decode_are_unchanged_by_remat(arch, monkeypatch):
    """Under every ``remat`` prefill and a decode step run no checkpoint
    and the same aten operations, and give the same logits and cache, bit
    for bit; a "train" forward outside grad mode runs none either."""
    jc, _ = _cfgs(arch)
    _, tp = _params(jc)
    batch = _torch_batch(_np_batch(jc, 2, 8, seed=5))
    extra = {k: v for k, v in batch.items() if k in ("frames",
                                                     "patch_embeds")}
    calls = []
    real = tmdl._ckpt.checkpoint
    monkeypatch.setattr(tmdl._ckpt, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    runs = []
    for remat in ("none", "full", "dots", "anything"):
        cfg = dataclasses.replace(_cfgs(arch)[1], remat=remat)
        with _Ops() as ops:
            logits, cache = tmdl.prefill(tp, cfg, batch["tokens"], extra)
            full = tmdl.init_cache(cfg, 2, 12)
            for key, sub in cache.items():
                for leaf, x in sub.items():
                    if leaf in ("conv", "h", "xk", "xv"):
                        full[key][leaf].copy_(x)
                    else:
                        full[key][leaf][:, :, :8].copy_(x)
            step_logits, _ = tmdl.decode_step(tp, cfg, batch["tokens"][:, :1],
                                              full, 8)
        with torch.no_grad():
            loss, _ = tmdl.loss_and_metrics(tp, cfg, batch)
        runs.append((ops.ops, logits, step_logits, tree_leaves(full), loss))
    assert calls == []
    first = runs[0]
    for ops, logits, step_logits, cache, loss in runs[1:]:
        assert ops == first[0]
        assert torch.equal(logits, first[1])
        assert torch.equal(step_logits, first[2])
        assert all(torch.equal(a, b) for a, b in zip(cache, first[3]))
        assert torch.equal(loss, first[4])


class _Products(TorchDispatchMode):
    """How often each aten product operation runs while it is entered."""

    NAMES = ("mm", "addmm", "bmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
             "convolution", "_scaled_mm")

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] in self.NAMES:
            self.counts[str(func)] = self.counts.get(str(func), 0) + 1
        return func(*args, **(kwargs or {}))


def _projections(cfg):
    """The products with no batch dimensions of one forward: q, k, v and o
    of an attention (cross-attention's too), two (gelu) or three (SwiGLU)
    of an MLP, a MoE's router twice (dispatch and load-balance loss) and
    its shared expert with its gate, a mamba mixer's in, x, dt and out."""
    mlp = 3 if cfg.act == "silu" else 2
    per_sub = {"attn": 4, "mamba": 4}
    total = 0
    for sub in tmdl.block_spec(cfg):
        total += per_sub[sub.mixer] + 4 * sub.cross
        if sub.ffn == "mlp":
            total += mlp
        elif sub.ffn == "moe":
            total += 2 + (mlp + 1 if cfg.moe_shared_d_ff else 0)
    return total * tmdl.num_blocks(cfg) + (4 + mlp) * cfg.enc_layers


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_projections_reach_aten_mm(arch):
    """The aten products a training forward reaches on the CPU: every
    projection one ``aten.mm`` (a weight that needs a gradient folds the
    leading axes), no ``addmm`` (biases are added apart), and ``aten.bmm``
    only for the batched products, which "dots" recomputes: the plain
    attention and the MoE experts' einsums."""
    jc, tc = _remat_cfgs(arch, "none")
    _, tp = _params(jc)
    batch = _torch_batch(_np_batch(jc, 2, 16, seed=7))
    live = tsteps.tree_map(lambda p: p.detach().requires_grad_(True),
                           tsteps._split_blocks(tp))
    with _Products() as seen:
        tmdl.forward(live, tc, batch["tokens"], batch, mode="train")
    assert set(seen.counts) <= {"aten.mm.default", "aten.bmm.default"}
    assert seen.counts["aten.mm.default"] == _projections(tc), seen.counts


def test_remat_values_map_as_the_references():
    """``_remat_policy``: "none" no checkpoint, "dots" the no-batch-dims
    dots, every other value (the empty one, a misspelling) nothing
    saved, as the reference's maps them."""
    policies = jax.checkpoint_policies
    ref_name = {None: None,
                policies.checkpoint_dots_with_no_batch_dims: "dots",
                policies.nothing_saveable: "full"}
    for value in ("none", "dots", "full", "", "Full", "save_dots", "None"):
        jc, tc = _remat_cfgs("olmo-1b", value)
        assert tmdl._remat_policy(tc) == ref_name[jmdl._remat_policy(jc)], \
            value


class _Made(TorchDispatchMode):
    """{storage key: (block, creating op)} of the storages that operations
    make inside a block (``block`` set; a view makes none) and that are
    still alive (a storage leaves the map when it dies), and the ``mm`` /
    ``addmm`` calls made inside the blocks."""

    def __init__(self):
        super().__init__()
        self.block = None
        self.alive = {}
        self.dot_calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.block is None:
            return out
        self.dot_calls += func in tmdl.DOT_OPS
        inputs = {t.untyped_storage()._cdata for t in
                  tree_flatten((args, kwargs))[0]
                  if isinstance(t, torch.Tensor)}
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            storage = t.untyped_storage()
            key = storage._cdata
            if key not in self.alive and key not in inputs:   # not a view
                self.alive[key] = (self.block, func)
                weakref.finalize(storage, self.alive.pop, key, None)
        return out


def _kept_inside_blocks(tc, tp, batch, monkeypatch):
    """The forward under grad of ``loss_and_metrics``: (``_Made`` at its
    end, the blocks' outputs' storages, the number of tensors the blocks'
    own operations saved through an outer ``saved_tensors_hooks``).  The
    backward runs after, and must find what it needs."""
    made, outputs, packed = _Made(), set(), []
    real = tmdl._block_fn

    def block_fn(*args, **kwargs):
        made.block = len(outputs)
        try:
            x, nc, aux = real(*args, **kwargs)
        finally:
            made.block = None
        outputs.add(x.untyped_storage()._cdata)
        outputs.add(aux.untyped_storage()._cdata)
        return x, nc, aux

    def pack(t):
        if made.block is not None:
            packed.append(made.block)
        return t

    monkeypatch.setattr(tmdl, "_block_fn", block_fn)
    live = tsteps.tree_map(lambda p: p.detach().requires_grad_(True),
                           tsteps._split_blocks(tp))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), made:
        loss, _ = tmdl.loss_and_metrics(live, tc, batch)
    gc.collect()
    kept = dict(made.alive)
    monkeypatch.setattr(tmdl, "_block_fn", real)
    torch.autograd.grad(loss, tree_leaves(live), allow_unused=True)
    return kept, made.dot_calls, outputs, len(packed)


@pytest.mark.parametrize("remat", ("none",) + REMATS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_forward_keeps_only_what_the_policy_saves(arch, remat, monkeypatch):
    jc, tc = _remat_cfgs(arch, remat)
    _, tp = _params(jc)
    batch = _torch_batch(_np_batch(jc, 2, 16, seed=6))
    kept, dot_calls, outputs, packed = _kept_inside_blocks(tc, tp, batch,
                                                           monkeypatch)
    assert dot_calls > 0
    dots = {k for k, (_, op) in kept.items() if op in tmdl.DOT_OPS}
    rest = set(kept) - outputs - dots
    if remat == "none":                  # every activation, through the hook
        assert rest and packed > 0
        return
    assert packed == 0
    assert rest == set(), sorted({str(kept[k][1]) for k in rest})
    # "full": no product's output; "dots": every one made in a block
    assert len(dots) == (0 if remat == "full" else dot_calls)
