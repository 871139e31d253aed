"""The port's checkpoints (``repro_torch.checkpoint.ckpt`` and
``core.policy.save_checkpoint`` / ``restore_checkpoint``) against the JAX
reference's (``repro.checkpoint``, ``repro.core.policy``).

The cases of the reference's ``tests/test_checkpoint.py`` and
``tests/test_chaos.py`` (round trip, latest of many, a given step,
corruption and shape mismatch, async retention, the content digest and
the fallback on damage) run on the port; then each package reads what the
other wrote, a bfloat16 leaf included: the leaves bit for bit, the
manifests' layouts and digests the same.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core import policy as jpol
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core import policy as tpol


def tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(8, 16, generator=g),
                       "b": torch.randn(16, generator=g).to(torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "m": {"w": torch.ones(8, 16)}},
            "hist": [torch.arange(3, dtype=torch.int32),
                     torch.tensor([True, False])]}


def jtree(seed=0):
    k = jax.random.PRNGKey(seed)
    return {"params": {"w": jax.random.normal(k, (8, 16), jnp.float32),
                       "b": jax.random.normal(k, (16,)).astype(jnp.bfloat16)},
            "opt": {"step": jnp.int32(7), "m": {"w": jnp.ones((8, 16))}},
            "hist": [jnp.arange(3, dtype=jnp.int32),
                     jnp.asarray([True, False])]}


def _bits(x) -> np.ndarray:
    """A leaf's bytes (bfloat16 included) as a uint8 array."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.reshape(-1).view(torch.uint8).numpy()
    return np.asarray(x).reshape(-1).view(np.uint8)


def _same_bits(a, b):
    fa, fb = tckpt._flatten(a), tckpt._flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        np.testing.assert_array_equal(_bits(fa[k]), _bits(fb[k]), err_msg=k)
        assert tuple(fa[k].shape) == tuple(fb[k].shape), k


def _step_dir(d, step):
    return os.path.join(str(d), f"step_{step:08d}")


def test_flatten_matches_jax_paths():
    """Keys as ``jax.tree_util.tree_flatten_with_path`` names them."""
    assert list(tckpt._flatten(tree())) == list(jckpt._flatten(jtree()))


def test_roundtrip(tmp_path):
    t = tree()
    tckpt.save(str(tmp_path), 10, t)
    assert tckpt.latest_step(str(tmp_path)) == 10
    out = tckpt.restore(str(tmp_path), tree(1), device="cpu")
    _same_bits(out, t)
    for a, b in zip(tckpt._flatten(t).values(),
                    tckpt._flatten(out).values()):
        assert a.dtype == b.dtype
    assert isinstance(out["hist"], list)


def test_latest_of_many_and_a_given_step(tmp_path):
    for s in (1, 5, 3):
        tckpt.save(str(tmp_path), s, tree(s))
    assert tckpt.latest_step(str(tmp_path)) == 5
    out = tckpt.restore(str(tmp_path), tree(), step=1, device="cpu")
    assert torch.equal(out["params"]["w"], tree(1)["params"]["w"])
    assert tckpt.latest_step(str(tmp_path / "nope")) is None


def test_corruption_detected(tmp_path):
    tckpt.save(str(tmp_path), 3, tree())
    shard = os.path.join(_step_dir(tmp_path, 3), "shard_00000.npz")
    with open(shard, "r+b") as f:
        f.seek(100)
        f.write(b"\x00" * 32)
    with pytest.raises(IOError, match="checksum"):
        tckpt.restore(str(tmp_path), tree(), device="cpu")


def test_shape_mismatch_and_shardings_rejected(tmp_path):
    tckpt.save(str(tmp_path), 4, tree())
    bad = tree()
    bad["params"]["w"] = torch.zeros(9, 16)
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(str(tmp_path), bad, device="cpu")
    missing = tree()
    missing["params"]["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="missing"):
        tckpt.restore(str(tmp_path), missing, device="cpu")
    with pytest.raises(ValueError, match="shardings"):
        tckpt.restore(str(tmp_path), tree(), shardings={"w": None},
                      device="cpu")


def test_async_saving_with_retention(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    live = tree(0)
    for s in range(5):
        mgr.save_async(s, live)
        live["opt"]["m"]["w"].add_(1.0)      # the snapshot was taken
    mgr.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(str(tmp_path)))
    assert steps == [3, 4]
    out = tckpt.restore(str(tmp_path), tree(), step=3, device="cpu")
    assert float(out["opt"]["m"]["w"][0, 0]) == 4.0


def _save_mlp(tmp_path):
    spec = tpol.get("mlp")
    params = spec.init(torch.Generator().manual_seed(0), device="cpu")
    d = str(tmp_path / "ckpt")
    tpol.save_checkpoint(d, 3, params, spec)
    return d, params


def test_policy_roundtrip_with_digest(tmp_path):
    d, params = _save_mlp(tmp_path)
    with open(os.path.join(_step_dir(d, 3), "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["content_digest"] == tckpt.content_digest(manifest)
    assert manifest["extra"] == jpol.checkpoint_metadata(jpol.get("mlp"))
    restored, spec = tpol.restore_checkpoint(d, device="cpu")
    assert spec.name == "mlp"
    _same_bits(restored, params)


def test_hand_edited_manifest_fails_digest(tmp_path):
    d, _ = _save_mlp(tmp_path)
    path = os.path.join(_step_dir(d, 3), "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    next(iter(manifest["leaves"].values()))["shape"] = [1]
    with open(path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(IOError, match="digest mismatch"):
        tpol.restore_checkpoint(d, device="cpu")


def test_truncated_shard_raises_by_default(tmp_path):
    d, _ = _save_mlp(tmp_path)
    shard = os.path.join(_step_dir(d, 3), "shard_00000.npz")
    with open(shard, "rb") as f:
        blob = f.read()
    with open(shard, "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises(IOError):
        tpol.restore_checkpoint(d, device="cpu")


@pytest.mark.parametrize("damage", ["manifest", "shard"])
def test_fallback_returns_fresh_init(tmp_path, damage):
    d, _ = _save_mlp(tmp_path)
    if damage == "manifest":
        path, blob = os.path.join(_step_dir(d, 3), "manifest.json"), b"{oops"
    else:
        path, blob = (os.path.join(_step_dir(d, 3), "shard_00000.npz"),
                      b"not an npz")
    with open(path, "wb") as f:
        f.write(blob)
    with pytest.warns(RuntimeWarning, match="falling back"):
        params, spec = tpol.restore_checkpoint(d, on_corrupt="fallback",
                                               device="cpu")
    assert spec.name == "mlp"
    template = spec.init(torch.Generator().manual_seed(5), device="cpu")
    assert {k: v.shape for k, v in params.items()} == {
        k: v.shape for k, v in template.items()}
    with pytest.raises((IOError, ValueError)):
        tpol.restore_checkpoint(d, device="cpu")


def test_missing_checkpoint_always_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tpol.restore_checkpoint(str(tmp_path / "nope"),
                                on_corrupt="fallback", device="cpu")


# ---------------------------------------------------------------------------
# each package reads the other's checkpoints
# ---------------------------------------------------------------------------


def _manifest(d, step):
    with open(os.path.join(_step_dir(d, step), "manifest.json")) as f:
        return json.load(f)


def test_reference_checkpoint_read_by_the_port(tmp_path):
    jt = jtree(3)
    jckpt.save(str(tmp_path), 2, jt, extra={"note": "reference"})
    out = tckpt.restore(str(tmp_path), tree(), device="cpu")
    _same_bits(out, jax.tree.map(np.asarray, jt))
    assert out["params"]["b"].dtype == torch.bfloat16
    assert tckpt.read_extra(str(tmp_path)) == {"note": "reference"}
    m = _manifest(tmp_path, 2)
    assert tckpt.content_digest(m) == jckpt.content_digest(m) == m[
        "content_digest"]


def test_port_checkpoint_read_by_the_reference(tmp_path):
    t = tree(4)
    tckpt.save(str(tmp_path / "port"), 6, t, extra={"note": "port"})
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        jtree())
    out = jckpt.restore(str(tmp_path / "port"), like)
    _same_bits(jax.tree.map(np.asarray, out), t)
    assert out["params"]["b"].dtype == jnp.bfloat16
    assert jckpt.read_extra(str(tmp_path / "port")) == {"note": "port"}
    # the same tree written by each package: the same manifest layout
    def to_jax(x):
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(x.numpy())

    jckpt.save(str(tmp_path / "ref"), 6, jax.tree.map(to_jax, t),
               extra={"note": "port"})
    mp, mr = _manifest(tmp_path / "port", 6), _manifest(tmp_path / "ref", 6)
    assert mp["leaves"] == mr["leaves"]
    assert {k: mp[k] for k in ("step", "format", "extra", "hosts")} == {
        k: mr[k] for k in ("step", "format", "extra", "hosts")}
    assert jckpt.content_digest(mp) == mp["content_digest"]


def test_policy_checkpoints_cross_read(tmp_path):
    """A reference "attention" checkpoint restores on the port as that
    class, and a port "mamba" checkpoint on the reference, bit for bit."""
    spec = jpol.get("attention")
    jp = spec.init(jax.random.PRNGKey(2))
    jpol.save_checkpoint(str(tmp_path / "a"), 1, jp, spec)
    got, tspec = tpol.restore_checkpoint(str(tmp_path / "a"), device="cpu")
    assert tspec.name == "attention"
    _same_bits(got, jax.tree.map(np.asarray, jp))
    mspec = tpol.get("mamba")
    tp = mspec.init(torch.Generator().manual_seed(3), device="cpu")
    tpol.save_checkpoint(str(tmp_path / "m"), 9, tp, mspec, extra={"k": 1})
    back, jspec = jpol.restore_checkpoint(str(tmp_path / "m"))
    assert jspec.name == "mamba"
    _same_bits(jax.tree.map(np.asarray, back), tp)
    assert jckpt.read_extra(str(tmp_path / "m"))["k"] == 1
