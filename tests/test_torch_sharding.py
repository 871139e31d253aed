"""The port's sharding rules as data (``repro_torch.launch.sharding``)
against the reference's ``PartitionSpec``s: every spec equals ``tuple()``
of the reference's, leaf by leaf, for every arch on the meshes (16, 16),
(2, 16, 16) ("pod", "data", "model"), (4, 2) and (1, 1); the reference's
meshes are ``AbstractMesh``es, as ``tests/test_sharding_launch.py``
builds them."""
import functools

import jax
import pytest

from repro.configs import SHAPES, get_config, list_archs
from repro.launch import sharding as rsh, shapes as rshp, steps as rsteps
from repro.optim import adam_init as radam_init
from repro_torch.configs.base import get_config as tget_config
from repro_torch.launch import sharding as tsh, shapes as tshp, steps as tsteps
from repro_torch.optim import adam_init as tadam_init

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}


def ref_mesh(name):
    shape, axes = MESHES[name]
    try:
        return jax.sharding.AbstractMesh(tuple(zip(axes, shape)))
    except TypeError:
        return jax.sharding.AbstractMesh(shape, axes)


def port_mesh(name):
    shape, axes = MESHES[name]
    return tsh.MeshShape(axes, shape)


def ref_specs(tree) -> dict:
    """{key path: tuple(spec)} of a reference tree of PartitionSpecs."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in flat}


def port_specs(tree, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(port_specs(v, path + (str(k),)))
        return out
    return {path: tree}


@functools.lru_cache(maxsize=None)
def trees(arch):
    """(reference params and AdamW shapes, port fake params and state)."""
    cfg = get_config(arch)
    rp = rshp.params_specs(cfg)
    ro = jax.eval_shape(lambda p: radam_init(p, rsteps.default_adam(cfg)), rp)
    tcfg = tget_config(arch)
    tp = tshp.params_specs(tcfg)
    mode = next(t for t in jax.tree.leaves(tp)).fake_mode
    with mode:
        to = tadam_init(tp, tsteps.default_adam(tcfg))
    return rp, ro, tp, to


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(list_archs()))
def test_param_and_opt_state_specs_match_reference(arch, mesh):
    rp, ro, tp, to = trees(arch)
    want = rsh.param_specs(rp, get_config(arch), ref_mesh(mesh))
    got = tsh.param_specs(tp, tget_config(arch), port_mesh(mesh))
    assert port_specs(got) == ref_specs(want)
    want_o = rsh.opt_state_specs(ro, want, ref_mesh(mesh))
    got_o = tsh.opt_state_specs(to, got, port_mesh(mesh))
    assert port_specs(got_o) == ref_specs(want_o)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(list_archs()))
def test_input_and_cache_specs_match_reference(arch, mesh):
    cfg, tcfg = get_config(arch), tget_config(arch)
    for name in ("train_4k", "prefill_32k"):
        shape = SHAPES[name]
        want = rsh.input_sharding(ref_mesh(mesh),
                                  rshp.input_specs(cfg, shape)["batch"])
        got = tsh.input_sharding(port_mesh(mesh),
                                 tshp.input_specs(tcfg, shape)["batch"])
        assert port_specs(got) == ref_specs(want), name
    for name in ("decode_32k", "long_500k"):
        shape = SHAPES[name]
        rtok, rcache, _ = rshp.decode_specs(cfg, shape)
        ttok, tcache, _ = tshp.decode_specs(tcfg, shape)
        assert port_specs(tsh.cache_specs(
            tcache, tcfg, port_mesh(mesh), shape.global_batch)) == ref_specs(
            rsh.cache_specs(rcache, cfg, ref_mesh(mesh), shape.global_batch)
        ), name
        assert port_specs(tsh.input_sharding(port_mesh(mesh), ttok)) == \
            ref_specs(rsh.input_sharding(ref_mesh(mesh), rtok)), name


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_axis_and_activation_spec_match_reference(mesh):
    rm, tm = ref_mesh(mesh), port_mesh(mesh)
    assert tsh.batch_axes(tm) == rsh.batch_axes(rm)
    for batch in (1, 2, 3, 4, 8, 16, 32, 128, 256, 512, 48):
        want = rsh.batch_axis(rm, batch)
        got = tsh.batch_axis(tm, batch)
        assert tsh.spec(got) == tuple(jax.sharding.PartitionSpec(want)), batch
        for seq in (1, 8, 4096, 4097, 524288):
            assert tsh.activation_spec(tm, batch, seq) == tuple(
                rsh.activation_spec(rm, batch, seq)), (batch, seq)


def test_expert_parallel_vs_tp_within_expert():
    mesh = port_mesh("16x16")
    dbrx, qwen = tget_config("dbrx-132b"), tget_config("qwen2-moe-a2.7b")
    s_dbrx = tsh.param_specs(tshp.params_specs(dbrx), dbrx, mesh)
    s_qwen = tsh.param_specs(tshp.params_specs(qwen), qwen, mesh)
    assert s_dbrx["layers"]["sub0"]["moe"]["w_gate"][1] == "model"
    assert s_qwen["layers"]["sub0"]["moe"]["w_gate"][1] is None
    assert s_qwen["layers"]["sub0"]["moe"]["w_gate"][3] == "model"


def test_spec_normal_form_and_per_card_bytes():
    assert tsh.spec(("data",), None) == ("data", None)
    assert tsh.spec((), "model") == (None, "model")
    assert tsh.spec(("pod", "data")) == (("pod", "data"),)
    mesh = port_mesh("2x16x16")
    assert (mesh.n_cards, mesh.name, mesh.shape) == (
        512, "2x16x16", {"pod": 2, "data": 16, "model": 16})
    tree = tshp.params_specs(tget_config("olmo-1b"))
    specs = tsh.param_specs(tree, tget_config("olmo-1b"), mesh)
    whole = tsh.per_card_bytes(tree, specs, tsh.ONE_CARD)
    assert whole == sum(t.numel() * 2 for t in jax.tree.leaves(tree))
    embed = tree["embed"]
    assert tsh.per_card_bytes(embed, ("model", "data"), mesh) == (
        embed.numel() * 2 // 256)
    assert hash(mesh) == hash(port_mesh("2x16x16"))
