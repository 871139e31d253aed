"""The port's mamba mixer, MoE FFN, cross-attention and whisper encoder,
and the moe / ssm / hybrid / audio families end to end, against the JAX
reference on the same numpy inputs.

Weights come from the reference's inits, carried across with
``convert.lm_params_from_numpy``; inputs are made with numpy from a seed.
On the CPU the kernels' plain versions run (kernel 6's for the scan).
Tolerances: the selective scan 4e-5 (what ``test_torch_scan_plan.py``
holds kernel 6's model to), the MoE dispatch bit for bit, the modules
1e-5 in float32 (1e-4 where a block of products feeds the output, the LM
tests' float32 tolerance).  The families' caches after prefill and decode
are held as ``test_torch_lm.py`` holds logits: 1e-4 in float32, and in
bfloat16 to the reference's float32 run on the same bfloat16 weights
within 2e-2 plus the reference's own bfloat16 deviation, leaf by leaf.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import layers as jlayers, mamba as jmamba, model as jmdl
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.launch import serve
from repro_torch.models import mamba as tmamba, model as tmdl, moe as tmoe

FAMILIES = ["qwen2-moe-a2.7b", "dbrx-132b", "falcon-mamba-7b",
            "jamba-1.5-large-398b", "whisper-medium"]
F32 = dict(dtype="float32", param_dtype="float32", cache_dtype="float32")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SCAN_TOL = 4e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree, dtype=None):
    return convert.lm_params_from_numpy(_np(tree), dtype=dtype, device="cpu")


def _cfgs(arch, dtype="float32", **over):
    jc = jbase.get_config(arch, smoke=True)
    tc = tbase.get_config(arch, smoke=True)
    over = dict(F32, **over) if dtype == "float32" else over
    return dataclasses.replace(jc, **over), dataclasses.replace(tc, **over)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()), np.asarray(
        want, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# mamba
# ---------------------------------------------------------------------------


def _scan_inputs(b, s, di, n, seed):
    """The reference's sweep distributions (tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    dt = np.log1p(np.exp(r(b, s, di) * 0.3 - 1.0)).astype(np.float32)
    return (r(b, s, di) * 0.5, dt, -np.exp(r(di, n) * 0.3), r(b, s, n) * 0.5,
            r(b, s, n) * 0.5, np.ones(di, np.float32), r(b, di, n) * 0.1)


@pytest.mark.parametrize("s", [8, 64, 128])
@pytest.mark.parametrize("n", [8, 16])
def test_selective_scan_matches_the_reference(s, n):
    args = _scan_inputs(2, s, 24, n, seed=s + n)
    want_y, want_h = jmamba.selective_scan(*map(jnp.asarray, args),
                                           chunk=min(64, s))
    y, h = tmamba.selective_scan(*map(torch.tensor, args))
    assert y.dtype == torch.float32 and h.shape == (2, 24, n)
    _close(y, want_y, SCAN_TOL)
    _close(h, want_h, SCAN_TOL)


def test_selective_scan_keeps_x_dtype():
    """x in bfloat16: the scan runs in float32 and y comes back in
    bfloat16, as the reference's (``mamba.py:92``, ``:113-114``)."""
    args = list(_scan_inputs(1, 16, 8, 8, seed=3))
    args[0] = args[0].astype(jnp.bfloat16)
    want_y, want_h = jmamba.selective_scan(*map(jnp.asarray, args), chunk=8)
    targs = [torch.tensor(np.asarray(a, np.float32)) for a in args]
    targs[0] = targs[0].to(torch.bfloat16)
    y, h = tmamba.selective_scan(*targs)
    assert y.dtype == torch.bfloat16
    _close(y, want_y, 1e-2)
    _close(h, want_h, SCAN_TOL)


def _mamba_case(seed=0):
    jc, tc = _cfgs("falcon-mamba-7b")
    jp = jmamba.init_mamba(jax.random.PRNGKey(seed), jc, jnp.float32)
    return jc, tc, jp, _t(jp)


def test_init_mamba_keeps_the_reference_tree():
    jc, tc = _cfgs("falcon-mamba-7b", "bfloat16")
    want = jax.eval_shape(lambda: jmamba.init_mamba(jax.random.PRNGKey(0),
                                                    jc, jnp.bfloat16))
    got = tmamba.init_mamba(torch.Generator().manual_seed(0), tc,
                            torch.bfloat16)
    assert set(got) == set(want)
    for k, w in want.items():
        assert (tuple(got[k].shape), str(got[k].dtype)[6:]) == (
            w.shape, str(w.dtype)), k
    # dt_bias is the inverse softplus of dt in [1e-3, 1e-1]
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert bool(((dt > 0.999e-3) & (dt < 0.1001)).all())
    np.testing.assert_allclose(
        got["A_log"].numpy(), np.log(np.arange(1, tc.ssm_state + 1))[None]
        .repeat(tc.d_inner, 0), rtol=1e-6)


@pytest.mark.parametrize("carry", ["none", "h0"])
def test_apply_mamba_matches_the_reference(carry):
    """The block from zero state and from an ``h0``: output, conv state
    (the pre-conv in_proj tail) and ssm state."""
    jc, tc, jp, tp = _mamba_case()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, jc.d_model)).astype(np.float32)
    kw = {}
    if carry == "h0":
        kw = dict(h0=0.1 * rng.standard_normal(
            (2, jc.d_inner, jc.ssm_state)).astype(np.float32))
    want, (wconv, wh) = jmamba.apply_mamba(
        jp, jnp.asarray(x), jc, chunk=8,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got, (conv, h) = tmamba.apply_mamba(
        tp, torch.tensor(x), tc, **{k: torch.tensor(v) for k, v in kw.items()})
    _close(got, want, 1e-5)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(wconv))
    _close(h, wh, SCAN_TOL)


def test_apply_mamba_continues_from_conv0_and_h0():
    """A prompt run in two halves, the second from the first's (conv, h),
    gives the whole prompt's output and states.  The reference's
    ``apply_mamba`` raises with ``conv0`` (it concatenates the (B, cw - 1,
    di) tail with the whole (B, S, 2·di) projection, ``mamba.py:137-142``);
    the port takes the projection's x half."""
    jc, tc, jp, tp = _mamba_case(2)
    x = torch.tensor(np.random.default_rng(20).standard_normal(
        (2, 16, jc.d_model)).astype(np.float32))
    whole, (conv, h) = tmamba.apply_mamba(tp, x, tc)
    first, (conv1, h1) = tmamba.apply_mamba(tp, x[:, :7], tc)
    second, (conv2, h2) = tmamba.apply_mamba(tp, x[:, 7:], tc, h0=h1,
                                             conv0=conv1)
    _close(torch.cat([first, second], 1), whole.numpy(), 1e-5)
    np.testing.assert_array_equal(conv2.numpy(), conv.numpy())
    _close(h2, h.numpy(), SCAN_TOL)
    with pytest.raises(TypeError):
        jmamba.apply_mamba(jp, jnp.asarray(x[:, 7:].numpy()), jc, chunk=9,
                           conv0=jnp.asarray(conv1.numpy()))


def test_decode_mamba_matches_the_reference():
    jc, tc, jp, tp = _mamba_case(1)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 1, jc.d_model)).astype(np.float32)
    conv = rng.standard_normal((3, jc.ssm_conv - 1, jc.d_inner)).astype(
        np.float32)
    h = 0.1 * rng.standard_normal((3, jc.d_inner, jc.ssm_state)).astype(
        np.float32)
    want, (wconv, wh) = jmamba.decode_mamba(
        jp, jnp.asarray(x), jc, (jnp.asarray(conv), jnp.asarray(h)))
    got, (gconv, gh) = tmamba.decode_mamba(
        tp, torch.tensor(x), tc, (torch.tensor(conv), torch.tensor(h)))
    _close(got, want, 1e-5)
    np.testing.assert_array_equal(gconv.numpy(), np.asarray(wconv))
    _close(gh, wh, 1e-6)
    zc, zh = tmamba.init_mamba_state(tc, 3)
    wc0, wh0 = jmamba.init_mamba_state(jc, 3)
    assert (tuple(zc.shape), zc.dtype, tuple(zh.shape), zh.dtype) == (
        wc0.shape, torch.bfloat16, wh0.shape, torch.float32)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def test_route_matches_the_reference_with_a_forced_tie():
    """Top-k order on ties is ``jax.lax.top_k``'s: the lower expert first.
    Experts 1 and 3 have one router column, so every token ties them."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal((16, 6)).astype(np.float32)
    w[:, 3] = w[:, 1]
    w[:, 5] = w[:, 1]
    x = rng.standard_normal((9, 16)).astype(np.float32)
    for k in (1, 2, 4):
        want_w, want_i = jmoe.route(jnp.asarray(w), jnp.asarray(x), k)
        got_w, got_i = tmoe.route(torch.tensor(w), torch.tensor(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        _close(got_w, want_w, 1e-6)
    assert {1, 3, 5} <= set(got_i.flatten().tolist())


# (E, C, idx (T, k)): no overflow; expert 0 overflowing with the last
# expert under C; the last expert holding exactly C after expert 0's drops;
# the last expert overflowing (its kept token at slot E·C - 1 is wiped:
# the reference's last-slot rule); a random case with both
DISPATCH = {
    "no_overflow": (3, 8, [[0, 1], [1, 2], [2, 0]]),
    "earlier_overflows": (3, 2, [[0], [0], [0], [2]]),
    "last_holds_exactly_c": (3, 2, [[0], [0], [0], [2], [2]]),
    "last_overflows": (3, 2, [[2], [2], [2], [0]]),
    "random": (6, 8, np.random.default_rng(8).integers(0, 6, (40, 3))
               .tolist()),
}


@pytest.mark.parametrize("case", list(DISPATCH))
def test_dispatch_indices_bit_for_bit(case):
    e, c, idx = DISPATCH[case]
    want_t, want_s = jmoe.dispatch_indices(jnp.asarray(idx, jnp.int32), e, c)
    got_t, got_s = tmoe.dispatch_indices(torch.tensor(idx), e, c)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    if case == "last_overflows":          # the values the rule gives
        assert got_t.tolist() == [3, -1, -1, -1, 0, -1]
        assert got_s.flatten().tolist() == [4, 5, -1, 0]
    if case == "last_holds_exactly_c":
        assert got_t.tolist() == [0, 1, -1, -1, 3, 4]


def test_dispatch_rows_are_independent_dispatches():
    """``"batched"``'s rows: each row's dispatch is that row's alone."""
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 4, (3, 12, 2))
    tos, soa = tmoe.dispatch_rows(torch.tensor(idx), 4, 8)
    for r in range(3):
        want_t, want_s = jmoe.dispatch_indices(jnp.asarray(idx[r], jnp.int32),
                                               4, 8)
        np.testing.assert_array_equal(tos[r].numpy(), np.asarray(want_t))
        np.testing.assert_array_equal(soa[r].numpy(), np.asarray(want_s))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "dbrx-132b"])
@pytest.mark.parametrize("dispatch", ["batched", "global"])
@pytest.mark.parametrize("cf", [1.25, 0.3])
def test_apply_moe_matches_the_reference(arch, dispatch, cf):
    """qwen2-moe's shared expert and sigmoid gate, dbrx's without; the
    configs' capacity factor and one that forces drops (every expert past
    its 8 slots a row)."""
    jc, tc = _cfgs(arch, moe_dispatch=dispatch, moe_capacity_factor=cf)
    jp = jmoe.init_moe(jax.random.PRNGKey(10), jc, jnp.float32)
    tp = _t(jp)
    assert ("shared" in tp) == (arch == "qwen2-moe-a2.7b")
    assert tp["router"].dtype == torch.float32
    x = np.random.default_rng(11).standard_normal(
        (3, 40, jc.d_model)).astype(np.float32)
    want = jmoe.apply_moe(jp, jnp.asarray(x), jc)
    got = tmoe.apply_moe(tp, torch.tensor(x), tc)
    _close(got, want, 1e-5)
    if cf < 1:                                # drops happened
        _, idx = tmoe.route(tp["router"], torch.tensor(x).reshape(120, -1),
                            tc.moe_top_k)
        counts = torch.bincount(idx.flatten(), minlength=tc.moe_num_experts)
        assert int(counts.max()) > tmoe.expert_capacity(120, tc)


def test_init_moe_keeps_the_reference_tree():
    for arch in ("qwen2-moe-a2.7b", "dbrx-132b"):
        jc, tc = _cfgs(arch, "bfloat16")
        want = jax.eval_shape(lambda: jmoe.init_moe(jax.random.PRNGKey(0), jc,
                                                    jnp.bfloat16))
        got = tmoe.init_moe(torch.Generator().manual_seed(0), tc,
                            torch.bfloat16)
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        assert len(flat_w) == len(jax.tree.leaves(got))
        for path, leaf in flat_w:
            g = got
            for p in path:
                g = g[p.key]
            assert (tuple(g.shape), str(g.dtype)[6:]) == (leaf.shape,
                                                         str(leaf.dtype))


def test_load_balance_loss_matches_the_reference():
    rng = np.random.default_rng(12)
    w = rng.standard_normal((16, 6)).astype(np.float32)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    want = jmoe.load_balance_loss(jnp.asarray(w), jnp.asarray(x), 2)
    got = tmoe.load_balance_loss(torch.tensor(w), torch.tensor(x), 2)
    _close(got, want, 1e-6)


# ---------------------------------------------------------------------------
# cross-attention and the whisper encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq", [5, 1])
def test_cross_attention_matches_the_reference(sq):
    """Whisper's cross-attention sub-layer: q with its bias, the encoder's
    K/V with NO bias (the reference's ``_cross_kv``), no RoPE; kernel 7's
    plain version at Sq > 1, kernel 8's at Sq = 1."""
    jc, tc = _cfgs("whisper-medium")
    jp = jlayers.init_attention(jax.random.PRNGKey(13), jc, jnp.float32)
    rng = np.random.default_rng(14)
    jp = {k: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
              if k.startswith("b") else v) for k, v in jp.items()}
    tp = _t(jp)
    x = rng.standard_normal((2, sq, jc.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, jc.enc_seq, jc.d_model)).astype(np.float32)
    jkv = jmdl._cross_kv(jp, jnp.asarray(enc), jc)
    want, _ = jmdl._run_attn(jp, jnp.asarray(x), jc, positions=None,
                             causal=False, q_chunk=64, kv_override=jkv)
    tkv = tmdl._cross_kv(tp, torch.tensor(enc), tc)
    for g, w in zip(tkv, jkv):
        _close(g, w, 1e-5)
    _close(tmdl._run_cross(tp, torch.tensor(x), tc, tkv), want, 1e-5)


def test_whisper_encoder_matches_the_reference():
    jc, tc = _cfgs("whisper-medium")
    jp = jmdl.init_params(jax.random.PRNGKey(15), jc)
    tp = _t(jp)
    frames = (0.02 * np.random.default_rng(16).standard_normal(
        (2, jc.enc_seq, jc.d_model))).astype(np.float32)
    want = jmdl._encode(jp, jc, jnp.asarray(frames), 64)
    got = tmdl._encode(tp, tc, torch.tensor(frames))
    _close(got, want, TOL["float32"])
    np.testing.assert_allclose(tmdl._sinusoidal(7, 16).numpy(),
                               np.asarray(jmdl._sinusoidal(7, 16)), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the families: prefill, decode and every cache leaf
# ---------------------------------------------------------------------------


def _extra(cfg, b, seed, dtype):
    if not cfg.is_encoder_decoder:
        return None, None
    frames = (0.02 * np.random.default_rng(seed).standard_normal(
        (b, cfg.enc_seq, cfg.d_model))).astype(np.float32)
    return ({"frames": jnp.asarray(frames, getattr(jnp, dtype))},
            {"frames": torch.tensor(frames).to(getattr(torch, dtype))})


def _reference_run(jp, jc, prompts, tokens, jextra):
    """Prefill, the cache padded as the reference's serve loop pads it,
    then one decode step per given token.  Returns (prefill logits,
    prefill cache, the final cache)."""
    plen, gen = prompts.shape[1], tokens.shape[1]
    logits, pcache = jax.jit(lambda p, t: jmdl.prefill(
        p, jc, t, jextra or {}, q_chunk=64, mamba_chunk=4))(
        jp, jnp.asarray(prompts))

    def pad(leaf):
        if leaf.ndim == 5 and leaf.shape[2] == plen:
            return jnp.pad(leaf, [(0, 0), (0, 0), (0, gen), (0, 0), (0, 0)])
        return leaf

    cache = jax.tree.map(pad, pcache)
    decode = jax.jit(lambda p, t, c, i: jmdl.decode_step(p, jc, t, c, i))
    for i in range(gen):
        _, cache = decode(jp, jnp.asarray(tokens[:, i:i + 1]), cache,
                          jnp.int32(plen + i))
    return np.asarray(logits), _np(pcache), _np(cache)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_family_prefill_decode_and_every_cache_leaf(arch, dtype):
    """Prefill and four decode steps on the reference's tokens (so both
    caches see the same inputs): the prefill logits and every leaf of the
    prefill cache and of the final decode cache (the K/V, the mamba conv
    and ssm states, the encoder's K/V)."""
    jc, tc = _cfgs(arch, dtype)
    jp = jmdl.init_params(jax.random.PRNGKey(17), jc)
    tp = _t(jp)
    b, plen, gen = 2, 12, 4
    rng = np.random.default_rng(18)
    prompts = rng.integers(0, jc.vocab_size, (b, plen)).astype(np.int32)
    tokens = rng.integers(0, jc.vocab_size, (b, gen)).astype(np.int32)
    jextra, textra = _extra(jc, b, 19, dtype)
    if dtype == "float32":
        want = _reference_run(jp, jc, prompts, tokens, jextra)
        slack = None
    else:                 # the reference's float32 run on the same weights
        jc32 = dataclasses.replace(jc, **F32)
        jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        jextra32 = jextra and {"frames": jextra["frames"].astype(jnp.float32)}
        want = _reference_run(jp32, jc32, prompts, tokens, jextra32)
        slack = _reference_run(jp, jc, prompts, tokens, jextra)

    logits, pcache = tmdl.prefill(tp, tc, torch.tensor(prompts).long(),
                                  textra)
    cache = serve.decode_cache(tc, pcache, b, plen, gen)
    assert {k: set(v) for k, v in cache.items()} == {
        k: set(v) for k, v in want[2].items()}
    for i in range(gen):
        _, same = tmdl.decode_step(tp, tc, torch.tensor(tokens[:, i:i + 1])
                                   .long(), cache, plen + i)
        assert same is cache
    assert pcache["sub0"].get("conv", torch.zeros((), dtype=torch.bfloat16)
                              ).dtype == torch.bfloat16
    got = (logits.numpy(), pcache, cache)
    for part, g, w in (("logits", got[0], want[0]),
                       *((f"prefill {s}.{leaf}", got[1][s][leaf],
                          want[1][s][leaf])
                         for s in want[1] for leaf in want[1][s]),
                       *((f"final {s}.{leaf}", got[2][s][leaf],
                          want[2][s][leaf])
                         for s in want[2] for leaf in want[2][s])):
        g = np.asarray(torch.as_tensor(g).float())
        w = np.asarray(w, np.float32)
        t = TOL[dtype]
        if slack is not None:
            own = {"logits": slack[0]}.get(part)
            if own is None:
                stage, path = part.split(" ")
                s, leaf = path.split(".")
                own = slack[1 if stage == "prefill" else 2][s][leaf]
            t += float(np.abs(np.asarray(own, np.float32) - w).max())
        np.testing.assert_allclose(g, w, rtol=t, atol=t, err_msg=part)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "qwen2-moe-a2.7b",
                                  "whisper-medium"])
def test_lm_params_from_numpy_keeps_float32_leaves_and_carries_caches(arch):
    """bf16 weights: the router, the shared gate, ``dt_bias``, ``A_log`` and
    ``D`` come across float32, the rest bf16, bit for bit; a reference
    decode cache (mamba ``conv`` bf16 and ``h`` float32, the encoder's
    ``xk`` / ``xv``) comes across with its dtypes and shapes."""
    jc, tc = _cfgs(arch, "bfloat16")
    jp = jmdl.init_params(jax.random.PRNGKey(21), jc)
    tp = _t(jp)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    f32 = set()
    for path, leaf in flat:
        got = tp
        for p in path:
            got = got[p.key]
        assert str(got.dtype)[6:] == str(leaf.dtype), path
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(leaf, np.float32))
        if leaf.dtype == jnp.float32:
            f32.add(path[-1].key)
    assert f32 == {"router", "shared_gate", "dt_bias", "A_log", "D"} & (
        {"router", "shared_gate"} if arch == "qwen2-moe-a2.7b" else
        {"router", "dt_bias", "A_log", "D"} if arch.startswith("jamba")
        else set())
    jcache = _np(jmdl.init_cache(jc, 2, 9))
    tcache = _t(jcache)
    want = tmdl.init_cache(tc, 2, 9)
    assert {k: {p: (tuple(t.shape), t.dtype) for p, t in v.items()}
            for k, v in tcache.items()} == {
        k: {p: (tuple(t.shape), t.dtype) for p, t in v.items()}
        for k, v in want.items()}
