"""Kernel 7's gradient on the CPU: the plain twin of its hand-written
backward (``flash_attention_bwd_plain``, P recomputed from the saved
log-sum-exp) and autograd of the plain forward, against ``jax.vjp`` of the
reference's ``layers.attention`` (the XLA path the JAX model trains
through) and of ``kernels.ref.flash_attention_ref`` (its oracle).

Inputs are float32 from numpy; every gradient is held within 1e-5 of the
reference's, relative to the largest element of that gradient (both run
in float32, the port over key blocks with an online softmax, the
reference over all keys at once).  ``layers.attention`` places a causal
diagonal at key 0, kernel 7 at Skv - Sq: causal shapes with Sq != Skv are
held to the oracle only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as fa, ops
from repro_torch.models import layers as tlayers

TOL = 1e-5

# (B, Sq, Skv, Hq, Hkv, D, causal): GQA groups 1, 2 and 6, D 64 and 128,
# ragged Sq != Skv, more keys than one plain block (PLAIN_BLOCK_K = 256)
SHAPES = [
    (2, 64, 64, 4, 4, 64, True),
    (2, 48, 48, 4, 2, 128, True),
    (1, 40, 40, 6, 1, 64, True),
    (1, 260, 260, 2, 2, 64, True),
    (2, 37, 300, 4, 2, 64, False),
    (1, 300, 300, 6, 1, 128, False),
    (2, 33, 17, 4, 4, 128, False),
    (2, 20, 33, 2, 1, 64, True),
    (1, 5, 270, 6, 2, 128, True),
]


def _inputs(shape, seed):
    b, sq, skv, hq, hkv, d, _ = shape
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, sq, hq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _close(got, want, name):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL * float(np.max(np.abs(want))), (name, err)


def _references(shape, q, k, v, do):
    """The reference's gradients: the oracle always, ``layers.attention``
    where its diagonal is kernel 7's."""
    _, sq, skv, _, _, _, causal = shape
    fns = {"ref": lambda q, k, v: jref.flash_attention_ref(q, k, v,
                                                           causal=causal)}
    if not causal or sq == skv:
        fns["layers"] = lambda q, k, v: jlayers.attention(q, k, v,
                                                          causal=causal)
    out = {}
    for name, fn in fns.items():
        o, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        out[name] = (o, vjp(jnp.asarray(do)))
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_vjp(shape):
    q, k, v, do = _inputs(shape, sum(shape[:6]))
    causal = shape[6]
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                      return_lse=True)
    grads = fa.flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse,
                                         causal=causal)
    for name, (ro, rgrads) in _references(shape, q, k, v, do).items():
        _close(o, ro, f"{name} out")
        for g, rg, which in zip(grads, rgrads, "qkv"):
            _close(g, rg, f"{name} d{which}")


@pytest.mark.parametrize("shape", SHAPES)
def test_autograd_of_the_plain_forward_matches_jax_vjp(shape):
    """What the CPU trains through: ``layers.attention`` -> ``ops`` ->
    the plain forward, differentiated by autograd."""
    q, k, v, do = _inputs(shape, 7 + sum(shape[:6]))
    b, sq, skv, _, _, _, causal = shape
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    if causal and sq != skv:
        out = ops.flash_attention(*leaves, causal=True)
    else:
        out = tlayers.attention(*leaves, causal=causal)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    rgrads = _references(shape, q, k, v, do)["ref"][1]
    for g, rg, which in zip(grads, rgrads, "qkv"):
        _close(g, rg, f"d{which}")


@pytest.mark.parametrize("shape", SHAPES[::2])
def test_lse_is_the_rows_logsumexp(shape):
    q, k, v, _ = _inputs(shape, 3)
    b, sq, skv, hq, hkv, d, causal = shape
    _, lse = fa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal)
    kr = np.repeat(k, hq // hkv, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  kr.astype(np.float64)) / np.sqrt(d)
    if causal:
        s = np.where(np.arange(skv)[None, :]
                     <= np.arange(sq)[:, None] + skv - sq, s, -np.inf)
    mx = s.max(-1, keepdims=True)
    want = (mx + np.log(np.exp(s - mx).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    q, k, v, do = _inputs(SHAPES[1], 5)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = fa.flash_attention_plain(*t[:3], causal=True, return_lse=True)
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(*t[:3], o, t[3], lse, causal=True)
    want = fa.flash_attention_bwd_plain(*t[:3], o, t[3], lse, causal=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert fa.flash_attention_bwd.launches == before


def test_backward_refuses_what_it_has_no_instance_for():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 32)).astype(np.float32))
    o, lse = fa.flash_attention_plain(q, q, q, causal=True, return_lse=True)
    with pytest.raises(ValueError, match="head width 32"):
        fa.flash_attention_bwd(q, q, q, o, o, lse, causal=True)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd_plain(q, q, q, o, o, lse[:, :1], causal=True)
