"""The seed x env layout planner (``repro_torch.launch.mesh``) against the
reference's: ``_split_seed_env`` over the reference's exhaustive range
(``tests/test_train_engine.py``), and ``plan_seed_env_layout``, which
takes a device count where the reference takes a mesh."""
import dataclasses

import pytest

from repro.launch import mesh as rmesh
from repro_torch.launch import mesh as tmesh


@pytest.mark.parametrize("n_seeds", range(1, 13))
def test_split_matches_reference_over_the_exhaustive_range(n_seeds):
    for n_envs in range(1, 17):
        for n_dev in range(0, 17):
            got = tmesh._split_seed_env(n_seeds, n_envs, n_dev)
            assert got == rmesh._split_seed_env(n_seeds, n_envs, n_dev)
            if n_dev and (n_seeds * n_envs) % n_dev == 0:
                s, e = got
                assert s * e == n_dev and n_seeds % s == 0 and n_envs % e == 0
            else:
                assert got is None


def test_split_cases():
    assert tmesh._split_seed_env(2, 16, 4) == (2, 2)
    assert tmesh._split_seed_env(9, 8, 6) == (3, 2)
    assert tmesh._split_seed_env(3, 16, 4) == (1, 4)
    assert tmesh._split_seed_env(2, 2, 8) is None
    assert tmesh._split_seed_env(2, 16, -1) is None


def test_plan_none_cases():
    assert tmesh.plan_seed_env_layout(4, 16) is None          # no count
    assert tmesh.plan_seed_env_layout(4, 16, None) is None
    assert tmesh.plan_seed_env_layout(4, 16, 1) is None       # one device
    assert tmesh.plan_seed_env_layout(4, 16, 0) is None
    assert tmesh.plan_seed_env_layout(3, 5, 4) is None        # indivisible


@pytest.mark.parametrize("n_seeds,n_envs,n_dev", [
    (2, 16, 4), (10, 16, 8), (6, 10, 4), (1, 8, 2), (16, 1, 16)])
def test_plan_is_the_reference_split(n_seeds, n_envs, n_dev):
    lay = tmesh.plan_seed_env_layout(n_seeds, n_envs, n_dev)
    assert (lay.seed_shards, lay.env_shards) == rmesh._split_seed_env(
        n_seeds, n_envs, n_dev)


def test_layout_is_frozen_and_hashable():
    lay = tmesh.SeedEnvLayout(2, 4)
    assert hash(lay) == hash(tmesh.SeedEnvLayout(2, 4))
    assert {lay: 1}[tmesh.plan_seed_env_layout(2, 16, 8)] == 1
    assert [f.name for f in dataclasses.fields(lay)] == ["seed_shards",
                                                          "env_shards"]
    with pytest.raises(dataclasses.FrozenInstanceError):
        lay.seed_shards = 1
