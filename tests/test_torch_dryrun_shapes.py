"""The port's input stand-ins (``repro_torch.launch.shapes``) against the
reference's ``ShapeDtypeStruct``s, leaf by leaf: key path, shape and
dtype, for every arch and every shape it applies to; and the fake params
tree against a real ``init_params`` tree at smoke size."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES, get_config, list_archs, shape_applicable
from repro.launch import shapes as rshp
from repro_torch.configs.base import get_config as tget_config
from repro_torch.launch import shapes as tshp
from repro_torch.models import model as tmdl

CELLS = [(a, s) for a in list_archs() for s in SHAPES
         if shape_applicable(get_config(a), SHAPES[s])[0]]


def ref_leaves(tree) -> dict:
    """{key path: (shape, dtype name)} of a reference spec tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(str(getattr(k, "key", k)) for k in path):
            (tuple(x.shape), np.dtype(x.dtype).name) for path, x in flat}


def port_leaves(tree, path=()) -> dict:
    """{key path: (shape, dtype name)} of a port tree of tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(port_leaves(v, path + (str(k),)))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype).split(".")[1])}


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    return ref_leaves(rshp.params_specs(get_config(arch)))


@pytest.mark.parametrize("arch", list(list_archs()))
def test_params_specs_match_reference(arch):
    got = port_leaves(tshp.params_specs(tget_config(arch)))
    want = ref_params(arch)
    assert got == want
    assert all(isinstance(t, torch._subclasses.fake_tensor.FakeTensor)
               for t in jax.tree.leaves(
                   tshp.params_specs(tget_config(arch))))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    want = rshp.input_specs(get_config(arch), SHAPES[shape])
    got = tshp.input_specs(tget_config(arch), SHAPES[shape])
    assert sorted(got) == sorted(want)
    for key in want:
        assert port_leaves(got[key]) == ref_leaves(want[key]), key


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_kind_override(kind):
    cfg = get_config("jamba-1.5-large-398b")
    want = rshp.input_specs(cfg, SHAPES["train_4k"], kind=kind)
    got = tshp.input_specs(tget_config(cfg.name), SHAPES["train_4k"],
                           kind=kind)
    assert {k: port_leaves(v) for k, v in got.items()} == {
        k: ref_leaves(v) for k, v in want.items()}


def test_modality_stubs():
    wsp = tshp.train_batch_specs(tget_config("whisper-medium"),
                                 SHAPES["train_4k"])
    assert wsp["frames"].shape == (256, 1500, 1024)
    assert wsp["frames"].dtype == torch.bfloat16
    ivl = tshp.train_batch_specs(tget_config("internvl2-76b"),
                                 SHAPES["train_4k"])
    assert ivl["patch_embeds"].shape == (256, 256, 8192)
    assert ivl["patch_embeds"].dtype == torch.bfloat16
    assert "targets" not in tshp.prefill_batch_specs(
        tget_config("olmo-1b"), SHAPES["prefill_32k"])


@pytest.mark.parametrize("arch", list(list_archs()))
def test_fake_tree_is_init_params_tree_at_smoke_size(arch):
    """The fake tree equals a real ``init_params`` tree leaf by leaf (keys,
    shapes, dtypes) and holds no storage of its own."""
    cfg = tget_config(arch, smoke=True)
    real = tmdl.init_params(torch.Generator().manual_seed(0), cfg)
    fake = tshp.params_specs(cfg)
    assert port_leaves(fake) == port_leaves(real)
    assert all(t.device.type == "cpu" for t in jax.tree.leaves(fake))


def test_llama_405b_tree_costs_no_storage():
    tree = tshp.params_specs(tget_config("llama3-405b"))
    n = sum(t.numel() for t in jax.tree.leaves(tree))
    assert n == 405_853_388_800
    assert n == sum(int(np.prod(s)) for s, _ in
                    ref_params("llama3-405b").values())
