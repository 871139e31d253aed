"""Checkpointing (port of ``repro.checkpoint.ckpt``), in the reference's
on-disk format so that either package reads what the other wrote.

Format: one directory per step, ``step_XXXXXXXX/``, holding
  * ``manifest.json`` — per-leaf shapes and dtypes (numpy's dtype names),
    step metadata, the sha256 of each shard file and a ``content_digest``
    over the logical content;
  * ``shard_00000.npz`` — the leaves keyed by flattened tree path.

Keys are those of ``jax.tree_util.tree_flatten_with_path`` on the same
tree: dict keys sorted, list / tuple indices as numbers, NamedTuple
fields as ``.name``, joined by ``"/"``.  bfloat16 leaves, which numpy has
no dtype for, are stored as their ``uint8`` bytes with ``"bfloat16"`` in
the manifest, as the reference stores its ml_dtypes arrays.  A step is
written under ``.tmp`` and renamed into place.  One card holds every
leaf, so the reference's re-sharding on restore does not apply: a
``shardings`` argument is refused.  ``CheckpointManager`` saves on a
background thread with keep-N retention.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

_SEP = "/"
_BF16 = "bfloat16"


def _items(tree: Any):
    """``(key, child)`` pairs of one tree node in the reference's order, or
    None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [("." + f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` in the reference's flattening order (``None``
    holds no leaf, as in JAX)."""
    if tree is None:
        return {}
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    flat = {}
    for k, child in items:
        flat.update(_flatten(child, f"{prefix}{_SEP}{k}" if prefix else k))
    return flat


def _unflatten(tree: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    """``tree``'s structure with the leaves of ``leaves`` at its paths."""
    if tree is None:
        return None
    items = _items(tree)
    if items is None:
        return leaves[prefix]
    kids = [_unflatten(child, leaves, f"{prefix}{_SEP}{k}" if prefix else k)
            for k, child in items]
    if isinstance(tree, dict):
        # the template's own key order
        by_key = dict(zip(sorted(tree), kids))
        return {k: by_key[k] for k in tree}
    if hasattr(tree, "_fields"):
        return type(tree)(*kids)
    return type(tree)(kids)


def _to_numpy(x) -> np.ndarray:
    """A leaf as the array ``np.savez`` stores: bfloat16 as its bytes."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.contiguous()
            return (x.reshape(1) if x.dim() == 0 else x).view(
                torch.uint8).numpy()
        return x.numpy()
    return np.asarray(x)


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return _BF16
    return str(_to_numpy(x).dtype)


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[dict] = None) -> str:
    """Write one checkpoint synchronously; returns the step directory."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    flat = _flatten(tree)
    shard = "shard_00000.npz"
    shard_path = os.path.join(tmp_dir, shard)
    np.savez(shard_path, **{k: _to_numpy(v) for k, v in flat.items()})
    with open(shard_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    manifest = {
        "step": step,
        "format": 1,
        "extra": extra or {},
        "hosts": 1,
        "leaves": {k: {"shape": list(np.shape(v)), "dtype": _dtype_name(v)}
                   for k, v in flat.items()},
        "checksums": {shard: digest},
    }
    manifest["content_digest"] = content_digest(manifest)
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.replace(tmp_dir, step_dir)
    return step_dir


def content_digest(manifest: dict) -> str:
    """sha256 of the canonical (sorted-keys) JSON of the leaf layout, the
    shard checksums, the step and the format: a truncated shard, a dropped
    leaf or a hand-edited manifest all change it.  The free-form
    ``extra`` and the digest itself are left out."""
    body = {"leaves": manifest.get("leaves", {}),
            "checksums": manifest.get("checksums", {}),
            "step": manifest.get("step"),
            "format": manifest.get("format")}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True).encode()).hexdigest()


def _steps(ckpt_dir: str, need_manifest: bool):
    return [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
            if d.startswith("step_") and not d.endswith(".tmp")
            and (not need_manifest or os.path.exists(
                os.path.join(ckpt_dir, d, "manifest.json")))]


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir, need_manifest=True)
    return max(steps) if steps else None


def _step_dir(ckpt_dir: str, step: Optional[int]) -> str:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def read_extra(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """The ``extra`` metadata recorded at ``save`` time (e.g. the policy
    record of ``core.policy.checkpoint_metadata``), without reading the
    shards; {} when none was saved."""
    with open(os.path.join(_step_dir(ckpt_dir, step), "manifest.json")) as f:
        return json.load(f).get("extra") or {}


def restore(ckpt_dir: str, tree_like: Any, step: Optional[int] = None,
            shardings: Any = None, validate: bool = True,
            device=None) -> Any:
    """Rebuild a tree of tensors from a checkpoint (the latest step unless
    ``step``): ``tree_like`` gives the structure and each leaf's shape and
    dtype (tensors, on any device).  With ``validate`` the manifest's
    content digest and each shard's sha256 are checked first (``IOError``
    on a mismatch); a missing leaf raises ``KeyError``, a shape that
    differs ``ValueError``.  Leaves land on ``device`` (the card unless
    ``"cpu"``)."""
    if shardings is not None:
        raise ValueError("shardings: one card holds every leaf; the port "
                         "restores without re-sharding")
    device = resolve_device(device)
    step_dir = _step_dir(ckpt_dir, step)
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    if validate and "content_digest" in manifest:
        if manifest["content_digest"] != content_digest(manifest):
            raise IOError(f"manifest content digest mismatch in {step_dir} "
                          "(corrupted or hand-edited checkpoint)")
    data: Dict[str, np.ndarray] = {}
    for fname in sorted(os.listdir(step_dir)):
        if not fname.startswith("shard_"):
            continue
        path = os.path.join(step_dir, fname)
        if validate and fname in manifest.get("checksums", {}):
            with open(path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            if digest != manifest["checksums"][fname]:
                raise IOError(f"checksum mismatch in {path}")
        with np.load(path) as npz:
            for k in npz.files:
                data[k] = npz[k]
    out = {}
    for key, like in _flatten(tree_like).items():
        if key not in data:
            raise KeyError(f"leaf {key!r} missing from checkpoint step "
                           f"{manifest.get('step')}")
        raw = data[key]
        if raw.dtype == np.uint8 and like.dtype == torch.bfloat16:
            arr = torch.from_numpy(raw.copy()).view(torch.bfloat16).reshape(
                manifest["leaves"][key]["shape"])
        else:
            arr = torch.from_numpy(np.array(raw)).to(like.dtype)
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} != "
                             f"expected {tuple(like.shape)}")
        out[key] = arr.to(device)
    return _unflatten(tree_like, out)


class CheckpointManager:
    """Background writer with keep-N retention: ``save_async`` snapshots
    the tree to host memory on the caller's thread, then writes it on a
    thread of its own; ``wait`` joins it and re-raises its error."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        host_tree = _unflatten(tree, {
            k: (v.detach().cpu().clone() if isinstance(v, torch.Tensor)
                else np.array(v)) for k, v in _flatten(tree).items()})

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, extra)
                self._gc()
            except BaseException as e:  # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        for s in sorted(_steps(self.ckpt_dir, need_manifest=False))[
                : -self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
