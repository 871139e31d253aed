"""Sharding rules as data (port of ``repro.launch.sharding``): parameter,
input and cache specs for a planned mesh, and what they leave on a card.

One card has no mesh to split over, so the reference's rules become data:

* a spec is a tuple with one entry per dimension, each ``None``, an axis
  name, or a tuple of axis names, as ``tuple(PartitionSpec(...))`` gives
  it (a one-name tuple is the name, an empty one ``None``);
* a mesh is a ``MeshShape``: its axis names and their sizes, all the
  rules read.  It holds no device.

Scheme: TP ("model") x FSDP ("data") x optional DP ("pod", multi-pod).
  * up-projections  (L, In, Out): In over data, Out over model
  * down-projections (L, In, Out): In over model, Out over data
  * embeddings: vocab over model, d_model over data
  * MoE experts: expert dim over model when E % tp == 0 (EP), otherwise
    TP-within-expert on the FFN dim (qwen2-moe: 60 experts on a 16-way axis)
  * decode KV caches: sequence dim over model (split-KV decoding), batch
    over data; batch-1 long-context shards S over data x model
  * norms/scalars: replicated

The reference's ``to_named`` has no counterpart: there is nothing to
place on.  The one use in the port is ``per_card_bytes``, each leaf's
bytes over the product of the sizes of the axes its spec names, which the
dry run reports for the mesh it plans.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A planned mesh: axis names and their sizes.  Hashable."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def n_cards(self) -> int:
        return math.prod(self.sizes)

    @property
    def name(self) -> str:
        return "x".join(str(s) for s in self.sizes)


def production_mesh(multi_pod: bool = False) -> MeshShape:
    """The reference's production meshes: 16 x 16 ("data", "model"), or
    2 x 16 x 16 with "pod" in front."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


ONE_CARD = MeshShape(("data", "model"), (1, 1))


def spec(*entries) -> tuple:
    """A spec from per-dimension entries, one-name tuples as the name and
    empty ones as ``None`` (``PartitionSpec``'s own normal form)."""
    def norm(e):
        if isinstance(e, tuple):
            return None if not e else e[0] if len(e) == 1 else e
        return e
    return tuple(norm(e) for e in entries)


def batch_axes(mesh: MeshShape) -> Tuple[str, ...]:
    """The data-parallel axes ("pod" folds into batch as outer DP)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _axes_size(mesh: MeshShape, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        return mesh.shape[axes]
    return math.prod(mesh.shape[a] for a in axes)


def batch_axis(mesh: MeshShape, global_batch: int):
    """Axis (or axes tuple) for the batch dim; None => replicated."""
    axes = batch_axes(mesh)
    if global_batch % _axes_size(mesh, axes) == 0:
        return axes
    if "data" in mesh.axis_names and global_batch % mesh.shape["data"] == 0:
        return "data"
    return None


def param_spec(path: Tuple[str, ...], leaf, cfg: ModelConfig,
               mesh: MeshShape) -> tuple:
    """The spec of one parameter leaf, keyed by its tree path."""
    name = path[-1]
    stacked = path[0] in ("layers", "encoder")  # leading num_blocks dim
    tp, fsdp = "model", "data"
    nd = leaf.dim()

    def maybe(dim_size: int, axis: Optional[str]) -> Optional[str]:
        return axis if axis and dim_size % mesh.shape[axis] == 0 else None

    if name == "embed":
        return spec(maybe(leaf.shape[0], tp), maybe(leaf.shape[1], fsdp))
    if name == "lm_head":
        return spec(maybe(leaf.shape[0], fsdp), maybe(leaf.shape[1], tp))

    # norm scales / biases / tiny vectors: replicate
    if nd - (1 if stacked else 0) <= 1:
        if stacked and nd == 2 and name in ("dt_bias", "conv_b", "D", "bq",
                                            "bk", "bv"):
            return spec(None, maybe(leaf.shape[1], tp))
        return spec()

    if nd == 4:  # MoE expert weights: (L, E, In, Out)
        _, e, d_in, d_out = leaf.shape
        if e % mesh.shape[tp] == 0:  # expert parallelism
            return spec(None, tp, maybe(d_in, fsdp), None)
        # TP-within-expert (qwen2-moe): the FFN dim over model, In over data
        if name == "w_down":
            return spec(None, None, maybe(d_in, tp), maybe(d_out, fsdp))
        return spec(None, None, maybe(d_in, fsdp), maybe(d_out, tp))

    if nd == 3 and stacked:
        _, d_in, d_out = leaf.shape
        if name in ("w_down", "wo", "out_proj", "dt_proj"):
            return spec(None, maybe(d_in, tp), maybe(d_out, fsdp))
        if name in ("router", "x_proj", "A_log", "shared_gate"):
            fst = tp if name in ("x_proj", "A_log") else fsdp
            return spec(None, maybe(d_in, fst), None)
        if name == "conv_w":  # (L, cw, di)
            return spec(None, None, maybe(d_out, tp))
        return spec(None, maybe(d_in, fsdp), maybe(d_out, tp))

    if nd == 2:
        return spec(maybe(leaf.shape[0], fsdp), maybe(leaf.shape[1], tp))
    return spec()


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(params_shape: Any, cfg: ModelConfig, mesh: MeshShape):
    """Tree of specs matching a params (shape) tree."""
    return _map_with_path(
        lambda path, leaf: param_spec(path, leaf, cfg, mesh), params_shape)


def opt_state_specs(opt_shape: Any, p_specs: Any, mesh: MeshShape):
    """Adam state: step replicated; m/v/master mirror the param specs."""
    out = {"step": spec(), "m": p_specs, "v": p_specs}
    if "master" in opt_shape:
        out["master"] = p_specs
    return out


def input_sharding(mesh: MeshShape, batch: dict):
    """Specs for a train/prefill batch dict: batch dim sharded, rest
    replicated."""
    gb = next(iter(batch.values())).shape[0]
    b = batch_axis(mesh, gb)
    return {k: spec(b, *([None] * (v.dim() - 1))) if v.dim() >= 1 else spec()
            for k, v in batch.items()}


def cache_specs(cache_shape: Any, cfg: ModelConfig, mesh: MeshShape,
                global_batch: int):
    """Decode-cache specs: KV sequence over model (split-KV), batch over
    data.  For batch-1 long-context the sequence dim is sharded over
    data x model."""
    b_axis = batch_axis(mesh, global_batch)
    seq_ax: Any = ("data", "model") if b_axis is None else "model"
    if isinstance(seq_ax, tuple):
        seq_ax = tuple(a for a in seq_ax if a in mesh.axis_names) or "model"

    def visit(path, leaf):
        name = path[-1]
        tp_ok = lambda d: "model" if d % mesh.shape["model"] == 0 else None  # noqa: E731
        if name in ("k", "v"):  # (nb, B, S, Hkv, hd)
            s = leaf.shape[2]
            ax = seq_ax if s % _axes_size(mesh, seq_ax) == 0 else None
            return spec(None, b_axis, ax, None, None)
        if name in ("xk", "xv"):  # (nb, B, enc_seq, Hkv, hd)
            return spec(None, b_axis, None, None, None)
        if name == "conv":  # (nb, B, cw-1, di)
            return spec(None, b_axis, None, tp_ok(leaf.shape[3]))
        if name == "h":  # (nb, B, di, n)
            return spec(None, b_axis, tp_ok(leaf.shape[2]), None)
        return spec()

    return _map_with_path(visit, cache_shape)


def activation_spec(mesh: MeshShape, micro_batch: int, seq_len: int) -> tuple:
    """Residual-stream spec (B, S, D): batch over data(/pod), sequence over
    model."""
    b = batch_axis(mesh, micro_batch)
    s_ax = "model" if seq_len % mesh.shape["model"] == 0 else None
    return spec(b, s_ax, None)


def per_card_bytes(tree: Any, specs: Any, mesh: MeshShape) -> int:
    """The bytes one card holds of ``tree`` under ``specs``: each leaf's
    bytes over the product of the sizes of the axes its spec names."""
    if isinstance(tree, dict):
        return sum(per_card_bytes(tree[k], specs[k], mesh) for k in tree)
    share = math.prod(_axes_size(mesh, a) for a in specs)
    return tree.numel() * tree.element_size() // share
