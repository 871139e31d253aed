"""The port's LM (configs, layers, model, serve loop) against the JAX
reference.

Weights come from the reference's ``init_params`` (JAX's threefry draws
cannot be reproduced in PyTorch) and are carried across with
``convert.lm_params_from_numpy``; tokens and activations are made with
numpy from a seed.  On the CPU the attention kernels' plain versions run.
Tolerances: in float32 (the configs' dtypes replaced) 1e-4 on logits
against the reference's float32 run.  In bfloat16 the two packages round
at different points: the reference casts attention probabilities to
bfloat16 before the PV product (``_attend_block``), as kernel 7's bfloat16
CUDA kernel does, while the plain versions (which run here) and kernel 8
keep them in float32.  And the reference's own bfloat16 logits lie up to
~0.04 from its float32 logits at the smoke size; so the port's bfloat16 logits are held to the
reference's float32 run on the same bfloat16 weights, within the
reference's bfloat16 tolerance (2e-2) plus the reference's own bfloat16
deviation on the same prompts.  Greedy tokens must agree up to the first
step whose two best reference logits lie within twice the tolerance (where
logits each within the tolerance can swap).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import layers as jlayers, model as jmdl
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.launch import serve
from repro_torch.models import layers as tlayers, model as tmdl

ARCHS = list(jbase.list_archs())
PORTED = ARCHS                             # every family
FAMILIES = ["qwen2-moe-a2.7b", "dbrx-132b", "falcon-mamba-7b",
            "jamba-1.5-large-398b", "whisper-medium"]  # moe, ssm, hybrid, audio
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
F32 = dict(dtype="float32", param_dtype="float32", cache_dtype="float32")


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, dtype):
    jc, tc = jbase.get_config(arch, smoke=True), tbase.get_config(arch,
                                                                 smoke=True)
    if dtype == "float32":
        jc, tc = dataclasses.replace(jc, **F32), dataclasses.replace(tc, **F32)
    return jc, tc


def _params(jc, seed=0):
    jp = jmdl.init_params(jax.random.PRNGKey(seed), jc)
    return jp, convert.lm_params_from_numpy(_to_np(jp), device="cpu")


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_registry_and_shapes_match_the_reference():
    assert tbase.list_archs() == jbase.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    for arch in ARCHS:
        for name in jbase.SHAPES:
            assert tbase.shape_applicable(
                tbase.get_config(arch), tbase.SHAPES[name]) == \
                jbase.shape_applicable(jbase.get_config(arch),
                                       jbase.SHAPES[name])
    with pytest.raises(KeyError):
        tbase.get_config("gpt-2")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_the_reference_field_by_field(arch, smoke):
    jc, tc = jbase.get_config(arch, smoke), tbase.get_config(arch, smoke)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for prop in ("resolved_head_dim", "padded_vocab", "d_inner", "dt_rank",
                 "attention_free", "sub_quadratic"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert tmdl.block_spec(tc) == [tmdl.SubLayer(**dataclasses.asdict(s))
                                   for s in jmdl.block_spec(jc)]


def test_olmo_1b_full_size():
    """The configuration served on the card: ~1.18 B parameters."""
    cfg = tbase.get_config("olmo-1b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.padded_vocab) == (
        16, 2048, 16, 16, 128, 8192, 50304)
    assert 1.17e9 < cfg.param_count() < 1.19e9


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "layernorm_np"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_matches_the_reference(norm, dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 5, 64)) * 3 + 1).astype(np.float32)
    params = {} if norm == "layernorm_np" else {
        "scale": rng.uniform(0.5, 1.5, 64).astype(np.float32),
        "bias": rng.standard_normal(64).astype(np.float32)}
    if norm == "rmsnorm":
        params.pop("bias")
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jlayers.apply_norm(norm, {k: jnp.asarray(v, jd)
                                     for k, v in params.items()},
                              jnp.asarray(x, jd))
    got = tlayers.apply_norm(norm, {k: torch.tensor(v).to(td)
                                    for k, v in params.items()},
                             torch.tensor(x).to(td))
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])
    init = tlayers.init_norm(norm, 64, td)
    assert {k: tuple(v.shape) for k, v in init.items()} == {
        k: tuple(v.shape) for k, v in jlayers.init_norm(norm, 64, jd).items()}


@pytest.mark.parametrize("positions", ["prefill", "decode"])
def test_rope_matches_the_reference(positions):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7 if positions == "prefill" else 1, 4,
                             16)).astype(np.float32)
    pos = np.arange(7) if positions == "prefill" else np.array([300])
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = tlayers.apply_rope(torch.tensor(x), torch.tensor(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        tlayers.rope_frequencies(16, 500000.0).numpy(),
        np.asarray(jlayers.rope_frequencies(16, 500000.0)), rtol=1e-6)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_the_reference(act):
    jp = jlayers.init_mlp(jax.random.PRNGKey(3), 32, 64, act, jnp.float32, 2)
    tp = convert.lm_params_from_numpy(_to_np(jp), device="cpu")
    x = np.random.default_rng(3).standard_normal((2, 5, 32)).astype(np.float32)
    want = jlayers.apply_mlp(jp, jnp.asarray(x), act)
    got = tlayers.apply_mlp(tp, torch.tensor(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    assert {k: tuple(v.shape) for k, v in tlayers.init_mlp(
        gen, 32, 64, act, torch.float32, 2).items()} == {
        k: v.shape for k, v in jp.items()}


@pytest.mark.parametrize("case", ["causal", "full", "decode", "decode_gqa",
                                  "cross", "cross_decode", "decode_e4m3",
                                  "decode_gqa_e4m3", "cross_decode_e4m3"])
def test_attention_dispatch_matches_the_reference(case):
    """Self-attention (kernel 7's plain version), one token against a
    cache (kernel 8's), GQA included, and cross-attention of 5 queries
    (kernel 7) or one (kernel 8, ``kv_len = Skv``) against 24 keys with
    no ``kv_len``, against the reference's XLA path; the ``_e4m3`` cases
    with the cache in float8_e4m3fn (the reference casts it to q's
    dtype, the port hands it to kernel 8 as it is)."""
    rng = np.random.default_rng(4)
    b, s, hkv, d = 2, 24, 2, 16
    hq = 4 if case in ("decode_gqa", "cross", "decode_gqa_e4m3") else 2
    sq = {"cross": 5}.get(case, 1 if case.startswith(
        ("decode", "cross_decode")) else s)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=case == "causal")
    if case.startswith("decode"):
        kw = dict(causal=False, kv_len=13, q_offset=12)
    jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), torch.tensor(k), \
        torch.tensor(v)
    if case.endswith("_e4m3"):
        jk, jv = jk.astype(jnp.float8_e4m3fn), jv.astype(jnp.float8_e4m3fn)
        tk, tv = tk.to(torch.float8_e4m3fn), tv.to(torch.float8_e4m3fn)
    want = jlayers.attention(jnp.asarray(q), jk, jv, q_chunk=8, **kw)
    got = tlayers.attention(torch.tensor(q), tk, tv, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)


@pytest.mark.parametrize("case", ["cross", "kv_len_prefill", "e5m2"])
def test_attention_refuses_what_no_ported_path_runs(case):
    """Offset causal query blocks (the reference's diagonal starts at key
    0 there, kernel 7's at Skv - Sq; no path runs them), ``kv_len`` with
    several query tokens, and a float8_e5m2 cache (no config stores one;
    kernel 8 takes float8_e4m3fn) raise."""
    q = torch.zeros(1, 4 if case != "cross" else 3, 2, 16)
    k = v = torch.zeros(1, 4, 2, 16)
    if case == "cross":
        with pytest.raises(NotImplementedError):
            tlayers.attention(q, k, v, causal=True)
        with pytest.raises(NotImplementedError):
            tlayers.attention(q[:, :1], k, v, causal=False, q_offset=3)
    elif case == "kv_len_prefill":
        with pytest.raises(NotImplementedError):
            tlayers.attention(q, k, v, causal=False, kv_len=3)
    else:
        k8 = k.to(torch.float8_e5m2)
        with pytest.raises(ValueError, match="float8_e5m2"):
            tlayers.attention(q[:, :1], k8, k8, causal=False, kv_len=3)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-8b"] + FAMILIES)
def test_init_params_and_cache_keep_the_reference_tree(arch):
    jc, tc = _cfgs(arch, "bfloat16")
    want = jax.eval_shape(lambda: jmdl.init_params(jax.random.PRNGKey(0), jc))
    got = tmdl.init_params(torch.Generator().manual_seed(0), tc, "cpu")

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return {kk: vv for k, v in tree.items()
                    for kk, vv in leaves(v, f"{prefix}/{k}").items()}
        return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}

    assert leaves(got) == leaves(want)
    cache = tmdl.init_cache(tc, 3, 40)
    jcache = jax.eval_shape(lambda: jmdl.init_cache(jc, 3, 40))
    assert leaves(cache) == leaves(jcache)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_params_from_numpy(dtype):
    jc, _ = _cfgs("granite-8b", dtype)
    jp = jmdl.init_params(jax.random.PRNGKey(5), jc)
    tp = convert.lm_params_from_numpy(_to_np(jp), device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == len(jax.tree.leaves(tp))
    for path, leaf in flat_j:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == getattr(torch, dtype) and tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(leaf, np.float32))
    f32 = convert.lm_params_from_numpy(_to_np(jp), dtype=torch.float32,
                                       device="cpu")
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(f32))


def _patches(cfg, b, seed):
    if not cfg.num_vision_tokens:
        return None
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (b, cfg.num_vision_tokens, cfg.d_model))).astype(np.float32)


def _extra_np(cfg, b, seed):
    """The model's extra inputs as numpy: the vlm's patch embeddings, or
    the encoder-decoder's frames (``0.02 N(0, 1)``, as the reference's
    ``data/synthetic.py`` makes them), else None."""
    if cfg.num_vision_tokens:
        return {"patch_embeds": _patches(cfg, b, seed)}
    if cfg.is_encoder_decoder:
        return {"frames": (0.02 * np.random.default_rng(seed).standard_normal(
            (b, cfg.enc_seq, cfg.d_model))).astype(np.float32)}
    return None


def _jax_extra(extra):
    return {} if extra is None else {k: jnp.asarray(v)
                                     for k, v in extra.items()}


def _torch_extra(extra, dtype=torch.float32):
    return None if extra is None else {k: torch.tensor(v).to(dtype)
                                       for k, v in extra.items()}


def _reference_generate(jp, jc, prompts, gen_tokens, extra=None):
    """The reference serve loop (``launch/serve.py:148-166``): prefill, the
    cache padded to prompt + gen_tokens, greedy decode.  Returns the
    prefill logits, the per-step logits and the tokens."""
    plen = prompts.shape[1]
    jextra = _jax_extra(extra)
    logits, cache = jax.jit(lambda p, t: jmdl.prefill(p, jc, t, jextra,
                                                      q_chunk=64))(
        jp, jnp.asarray(prompts))

    def pad(leaf):
        if leaf.ndim == 5 and leaf.shape[2] == plen:
            width = [(0, 0)] * 5
            width[2] = (0, gen_tokens)
            return jnp.pad(leaf, width)
        return leaf

    cache = jax.tree.map(pad, cache)
    decode = jax.jit(lambda p, t, c, i: jmdl.decode_step(p, jc, t, c, i))
    steps, tokens = [np.asarray(logits)], []
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    tokens.append(np.asarray(tok))
    for i in range(gen_tokens - 1):
        logits, cache = decode(jp, tok, cache, jnp.int32(plen + i))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        steps.append(np.asarray(logits))
        tokens.append(np.asarray(tok))
    return np.stack(steps, 1), np.concatenate(tokens, 1)


def _want(jp, jc, dtype, prompts, gen_tokens, extra=None):
    """(reference logits, tokens, tolerance) to hold the port's run to: the
    reference in float32, and in bfloat16 the tolerance widened by the
    reference's own bfloat16 deviation (module docstring)."""
    if dtype == "float32":
        return (*_reference_generate(jp, jc, prompts, gen_tokens, extra),
                TOL[dtype])
    jc32 = dataclasses.replace(jc, **F32)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    logits, tokens = _reference_generate(jp32, jc32, prompts, gen_tokens,
                                         extra)
    own, _ = _reference_generate(jp, jc, prompts, 1, extra)
    return logits, tokens, TOL[dtype] + float(np.abs(own[:, 0]
                                                     - logits[:, 0]).max())


def _top2_gap(logits):
    top = np.sort(logits, axis=-1)
    return top[..., -1] - top[..., -2]


def _first_near_tie(want_logits, tol):
    """The first step at which some row's two best reference logits lie
    within 2·tol (logits each within tol can swap there), else the number
    of steps."""
    near = np.nonzero((_top2_gap(want_logits) <= 2 * tol).any(axis=0))[0]
    return int(near[0]) if len(near) else want_logits.shape[1]


def _agree(got_logits, got_tokens, want_logits, want_tokens, tol):
    """Logits within ``tol`` at every step up to and including the first
    near tie (its inputs are still the same), identical tokens before it;
    returns the number of steps whose tokens were compared."""
    upto = _first_near_tie(want_logits, tol)
    last = min(upto + 1, want_logits.shape[1])
    np.testing.assert_allclose(got_logits[:, :last], want_logits[:, :last],
                               rtol=tol, atol=tol)
    np.testing.assert_array_equal(got_tokens[:, :upto], want_tokens[:, :upto])
    return upto


def _decode_cache(cfg, pcache, plen, gen):
    b = next(iter(pcache["sub0"].values())).shape[1]
    return serve.decode_cache(cfg, pcache, b, plen, gen)


@pytest.mark.parametrize("arch,dtype", [
    ("olmo-1b", "float32"), ("granite-8b", "float32"),
    ("internvl2-76b", "float32"), ("olmo-1b", "bfloat16"),
    ("granite-8b", "bfloat16"), ("llama3-405b", "float32"),
    ("llama3-405b", "bfloat16"), ("command-r-plus-104b", "float32"),
    ("command-r-plus-104b", "bfloat16")]
    + [(arch, dtype) for arch in FAMILIES
       for dtype in ("float32", "bfloat16")])
def test_prefill_and_decode_match_the_reference(arch, dtype):
    """MHA (olmo-1b), GQA (granite-8b), the vlm prefix (internvl2), MoE
    (qwen2-moe with its shared expert, dbrx), the mamba mixer
    (falcon-mamba), the hybrid block (jamba) and the encoder with
    cross-attention (whisper): prefill logits (and in float32 the
    prefill's K/V), then greedy decode steps, step by step."""
    jc, tc = _cfgs(arch, dtype)
    jp, tp = _params(jc)
    b, plen, gen = 2, 12, 5
    prompts = _tokens(jc, b, plen, seed=6)
    extra = _extra_np(jc, b, 7)
    want_logits, want_tokens, tol = _want(jp, jc, dtype, prompts, gen, extra)
    logits, pcache = tmdl.prefill(tp, tc, torch.tensor(prompts).long(),
                                  _torch_extra(extra, getattr(torch, dtype)))
    assert logits.dtype == torch.float32
    _, jcache = jmdl.prefill(jp, jc, jnp.asarray(prompts), _jax_extra(extra))
    assert {k: set(v) for k, v in pcache.items()} == {
        k: set(v) for k, v in jcache.items()}
    if dtype == "float32":     # bfloat16 K/V differ by roundings inside
        for sub, leaves in jcache.items():
            for part, want in leaves.items():
                np.testing.assert_allclose(
                    pcache[sub][part].float().numpy(),
                    np.asarray(want, np.float32), rtol=TOL[dtype],
                    atol=TOL[dtype])
    cache = _decode_cache(tc, pcache, plen, gen)
    steps, tokens = [logits.numpy()], []
    tok = torch.argmax(logits, -1)[:, None]
    tokens.append(tok.numpy())
    for i in range(gen - 1):
        logits, same = tmdl.decode_step(tp, tc, tok, cache, plen + i)
        assert same is cache                       # written in place
        tok = torch.argmax(logits, -1)[:, None]
        steps.append(logits.numpy())
        tokens.append(tok.numpy())
    compared = _agree(np.stack(steps, 1), np.concatenate(tokens, 1),
                      want_logits, want_tokens, tol)
    if dtype == "float32":
        assert compared == gen


E4M3 = "float8_e4m3fn"


@pytest.mark.parametrize("src", ["bfloat16", "float32"])
def test_cache_cast_rounds_as_the_reference(src):
    """``model.cache_cast`` into float8_e4m3fn against ml_dtypes (the
    reference's ``astype``, JAX on the CPU) bit for bit: every one of the
    65,536 bfloat16 values, or float32 values across and past the range
    with its edges; NaN of the value's sign past +-464, where PyTorch's
    own cast saturates to +-448.  Other dtypes: the plain cast."""
    import ml_dtypes

    if src == "bfloat16":
        x = np.arange(65536, dtype=np.uint16).view(ml_dtypes.bfloat16)
        tx = torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    else:
        x = np.concatenate([
            np.random.default_rng(11).standard_normal(100_000) * 300,
            [448, 464, -464, 464.00003, -464.00003, 479.9, 480, 1e30,
             np.inf, -np.inf, np.nan, 2.0 ** -9, 2.0 ** -10, 1e-30, 0.0,
             -0.0]]).astype(np.float32)
        tx = torch.from_numpy(x.copy())
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    jwant = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).view(np.uint8)
    np.testing.assert_array_equal(jwant, want)
    got = tmdl.cache_cast(tx, torch.float8_e4m3fn)
    assert got.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(), want)
    past = np.abs(x.astype(np.float32)) > 464
    assert past.any() and (want[past] & 0x7F == 0x7F).all()
    assert (tx.to(torch.float8_e4m3fn).view(torch.uint8).numpy()[
        past & np.isfinite(x.astype(np.float32))] & 0x7F != 0x7F).any()
    for dt in (torch.bfloat16, torch.float32):
        torch.testing.assert_close(tmdl.cache_cast(tx, dt), tx.to(dt),
                                   rtol=0, atol=0, equal_nan=True)


def _reference_e4m3_run(jp, jc, prompts, gen_tokens):
    """The reference's prefill, its K/V written with ``astype`` into an
    ``init_cache`` of the e4m3 cache dtype, then greedy decode steps.
    Returns (logits per step, tokens, the final cache, the prefill's
    cache in the config's dtype)."""
    plen = prompts.shape[1]
    logits, pcache = jax.jit(lambda p, t: jmdl.prefill(p, jc, t, {},
                                                      q_chunk=64))(
        jp, jnp.asarray(prompts))
    cache = jmdl.init_cache(jc, prompts.shape[0], plen + gen_tokens)
    cache = jax.tree.map(
        lambda c, p: c.at[:, :, :plen].set(p.astype(c.dtype)), cache, pcache)
    decode = jax.jit(lambda p, t, c, i: jmdl.decode_step(p, jc, t, c, i))
    steps, tokens = [np.asarray(logits)], []
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    tokens.append(np.asarray(tok))
    for i in range(gen_tokens - 1):
        logits, cache = decode(jp, tok, cache, jnp.int32(plen + i))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        steps.append(np.asarray(logits))
        tokens.append(np.asarray(tok))
    return np.stack(steps, 1), np.concatenate(tokens, 1), cache, pcache


def _e4m3_step(x):
    """The spacing of float8_e4m3fn values at magnitude ``x``."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -6))) - 3)


@pytest.mark.parametrize("arch", ["granite-8b", "dbrx-132b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_with_an_e4m3_cache_match_the_reference(arch,
                                                                   dtype):
    """``cache_dtype="float8_e4m3fn"`` (the reference's option; a dense
    GQA arch and the MoE dbrx): the prompt's K/V written into the float8
    decode cache (``serve.decode_cache``), then decode steps that write
    each token's K/V with ``cache_cast`` and attend through kernel 8's
    plain version on the float8 cache.  The final cache's K/V within one
    float8 rounding step (adjacent codes) of the reference's in float32,
    where the two packages' K/V agree to float32 roundings and may only
    straddle a rounding midpoint, at every position written.  In
    bfloat16 the two packages' prefill K/V differ by their roundings
    inside (held here by the module's rule, against the reference's
    float32-weight K/V); the prompt's float8 codes equal the reference's
    bit for bit wherever the two packages' bfloat16 K/V are equal, and
    elsewhere lie within their difference plus one float8 step; and they
    are ``cache_cast`` of the port's own prefill K/V bit for bit.  Logits
    by the module's rules (in bfloat16 against the reference's run with
    float32 weights and the same float8 cache)."""
    jc, tc = _cfgs(arch, dtype)
    jc, tc = (dataclasses.replace(c, cache_dtype=E4M3) for c in (jc, tc))
    jp, tp = _params(jc)
    b, plen, gen = 2, 12, 5
    prompts = _tokens(jc, b, plen, seed=16)
    want_logits, want_tokens, jcache, jpre = _reference_e4m3_run(
        jp, jc, prompts, gen)
    tol = TOL[dtype]
    if dtype == "bfloat16":     # the module's rule: the float32-weight run
        jc32 = dataclasses.replace(jc, dtype="float32",
                                   param_dtype="float32")
        jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        own = want_logits[:, 0]
        want_logits, want_tokens, _, jpre32 = _reference_e4m3_run(
            jp32, jc32, prompts, gen)
        tol += float(np.abs(own - want_logits[:, 0]).max())
    logits, pcache = tmdl.prefill(tp, tc, torch.tensor(prompts).long())
    cache = _decode_cache(tc, pcache, plen, gen)
    assert all(t.dtype == torch.float8_e4m3fn for sub in cache.values()
               for t in sub.values())
    steps, tokens = [logits.numpy()], []
    tok = torch.argmax(logits, -1)[:, None]
    tokens.append(tok.numpy())
    for i in range(gen - 1):
        logits, _ = tmdl.decode_step(tp, tc, tok, cache, plen + i)
        tok = torch.argmax(logits, -1)[:, None]
        steps.append(logits.numpy())
        tokens.append(tok.numpy())
    upto = _agree(np.stack(steps, 1), np.concatenate(tokens, 1), want_logits,
                  want_tokens, tol)
    if dtype == "float32":
        assert upto == gen
    def codes(bits):            # float8 bit patterns in the values' order
        mag = bits.astype(np.int32) & 0x7F
        return np.where(bits & 0x80, -mag, mag)

    for sub, leaves in jcache.items():
        for part, want in leaves.items():
            got = cache[sub][part].view(torch.uint8).numpy()
            if dtype == "float32":
                w = np.asarray(want).view(np.uint8)
                assert np.isfinite(np.asarray(want, np.float32)).all()
                assert np.abs(codes(got) - codes(w)).max() <= 1
            else:
                np.testing.assert_array_equal(
                    got[:, :, :plen], tmdl.cache_cast(
                        pcache[sub][part], torch.float8_e4m3fn).view(
                            torch.uint8).numpy())
                x = pcache[sub][part].float().numpy()
                y = np.asarray(jpre[sub][part], np.float32)
                y32 = np.asarray(jpre32[sub][part], np.float32)
                assert np.abs(x - y32).max() <= TOL[dtype] + np.abs(
                    y - y32).max()
                mine = cache[sub][part][:, :, :plen].float().numpy()
                ref = np.asarray(want[:, :, :plen], np.float32)
                same = x == y
                assert same.mean() > 0.5
                np.testing.assert_array_equal(mine[same], ref[same])
                assert (np.abs(mine - ref) <= np.abs(x - y) + _e4m3_step(
                    np.maximum(np.abs(x), np.abs(y)))).all()


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_decode_consistency_on_the_port(arch):
    """``tests/test_models_smoke.py:48`` on the port: prefill's last logits
    equal the full forward pass's, and one decode step from the prefill
    cache gives finite logits and keeps the cache's structure."""
    cfg = tbase.get_config(arch, smoke=True)
    params = tmdl.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    b, s = 2, 16
    tokens = torch.tensor(_tokens(cfg, b, s, seed=8)).long()
    extra = _torch_extra(_extra_np(cfg, b, 9), torch.bfloat16)
    logits_pre, pcache = tmdl.prefill(params, cfg, tokens, extra)
    assert logits_pre.shape == (b, cfg.padded_vocab)
    assert bool(torch.isfinite(logits_pre).all())
    x, _, _ = tmdl.forward(params, cfg, tokens, extra, mode="train")
    logits_full = tmdl.logits_from_hidden(params, cfg, x[:, -1:])[:, 0]
    torch.testing.assert_close(logits_pre, logits_full, rtol=2e-2, atol=2e-2)
    cache = _decode_cache(cfg, pcache, s, 4)
    shapes = {k: {p: tuple(t.shape) for p, t in v.items()}
              for k, v in cache.items()}
    nxt = torch.argmax(logits_pre, -1)[:, None]
    logits_dec, cache2 = tmdl.decode_step(params, cfg, nxt, cache, s)
    assert logits_dec.shape == (b, cfg.padded_vocab)
    assert bool(torch.isfinite(logits_dec).all())
    assert {k: {p: tuple(t.shape) for p, t in v.items()}
            for k, v in cache2.items()} == shapes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_wave_matches_the_reference_loop(dtype):
    """One wave of the port's serve loop (``serve.serve_wave``) against the
    reference's prefill / decode_step loop on the same prompts."""
    jc, tc = _cfgs("olmo-1b", dtype)
    jp, tp = _params(jc)
    prompts = _tokens(jc, 4, 16, seed=10)     # no near tie in float32
    want_logits, want_tokens, tol = _want(jp, jc, dtype, prompts, 6)
    wave = serve.serve_wave(tp, tc, torch.tensor(prompts).long(), 6)
    assert wave.tokens.shape == wave.top2_gap.shape == (4, 6)
    assert wave.prefill_s > 0 and wave.decode_s > 0
    assert bool((wave.top2_gap >= 0).all())
    torch.testing.assert_close(
        wave.top2_gap[:, 0], torch.topk(wave.prefill_logits, 2).values
        .diff(dim=-1)[:, 0].neg())
    np.testing.assert_allclose(wave.prefill_logits.numpy(),
                               want_logits[:, 0], rtol=tol, atol=tol)
    upto = _first_near_tie(want_logits, tol)
    if dtype == "float32":
        assert upto == 6
    np.testing.assert_array_equal(wave.tokens.numpy()[:, :upto],
                                  want_tokens[:, :upto])


# ---------------------------------------------------------------------------
# entry points and what is not ported
# ---------------------------------------------------------------------------


def test_serve_main_on_the_cpu_routes_and_serves_every_wave(capsys):
    res = serve.main(["--arch", "olmo-1b", "--smoke", "--replicas", "3",
                      "--requests", "12", "--wave-size", "4",
                      "--prompt-len", "8", "--gen-tokens", "3",
                      "--device", "cpu"])
    assert len(res.waves) == len(res.assignments) == 3
    assert int(res.counts.sum()) == 3 and res.generated == 36
    assert all(w.tokens.shape == (4, 3) for w in res.waves)
    assert res.daemon.metrics.bound == 3
    out = capsys.readouterr().out
    assert "[serve] 12 requests, 36 tokens" in out and "SDQN routing" in out
    # the prompts are a function of the seed and the wave alone
    again = serve.sample_requests(serve.seed_generator(0, 101), 4,
                                  res.cfg.vocab_size, 8)
    torch.testing.assert_close(res.waves[1].prompts, again)


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_main_serves_every_family_but_the_encoder_decoder(arch, capsys):
    """``serve.main`` routes and serves the moe, ssm and hybrid families
    (one wave each) and, as the reference's ``main`` (which passes no
    frames and fails in its ``_encode``), refuses whisper, naming the
    missing frames; ``serve_wave(extra={"frames": ...})`` serves it."""
    argv = ["--arch", arch, "--smoke", "--replicas", "2", "--requests", "2",
            "--wave-size", "2", "--prompt-len", "6", "--gen-tokens", "3",
            "--device", "cpu"]
    cfg = tbase.get_config(arch, smoke=True)
    if not cfg.is_encoder_decoder:
        res = serve.main(argv)
        assert len(res.waves) == 1 and res.generated == 6
        assert res.waves[0].tokens.shape == (2, 3)
        assert "[serve] 2 requests, 6 tokens" in capsys.readouterr().out
        return
    with pytest.raises(ValueError, match="frames"):
        serve.main(argv)
    from repro.launch import serve as jserve

    with pytest.raises(KeyError, match="frames"):
        jserve.main(argv[:-2])
    params = tmdl.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    frames = torch.tensor(_extra_np(cfg, 2, 3)["frames"]).to(torch.bfloat16)
    wave = serve.serve_wave(params, cfg, torch.tensor(_tokens(cfg, 2, 6, 4)),
                            3, extra={"frames": frames})
    assert wave.tokens.shape == (2, 3)
    assert bool(torch.isfinite(wave.prefill_logits).all())


@pytest.mark.parametrize("case", ["checkpoint_dir", "online", "no_card"])
def test_serve_refuses_what_is_not_here(case, tmp_path):
    """A checkpoint directory and ``--online`` run now: a reference
    checkpoint of the "attention" class loads bit for bit with its class,
    an empty directory raises ``FileNotFoundError``, and ``--online``
    records every routing decision and publishes each refresh step's
    params to the daemon.  Without a card the entry point still raises."""
    if case == "checkpoint_dir":
        from repro.core import policy as jpol

        with pytest.raises(FileNotFoundError):
            serve.load_policy(str(tmp_path), torch.Generator(), device="cpu")
        spec = jpol.get("attention")
        want = spec.init(jax.random.PRNGKey(4))
        jpol.save_checkpoint(str(tmp_path), 2, want, spec)
        got, tspec = serve.load_policy(str(tmp_path), torch.Generator(),
                                       device="cpu")
        assert tspec.name == "attention"
        flat = jax.tree_util.tree_leaves_with_path(want)
        for path, w in flat:
            g = got
            for p in path:
                g = g[p.key]
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    elif case == "online":
        res = serve.main(["--smoke", "--online", "--online-steps", "2",
                          "--requests", "8", "--wave-size", "2",
                          "--prompt-len", "4", "--gen-tokens", "2",
                          "--device", "cpu"])
        ref = res.refresher
        assert ref.recorder.drained == len(res.assignments) == 4
        assert (ref.steps, ref.swaps) == (2, 2)
        assert res.daemon._params is ref.params
        assert np.isfinite(ref.last_loss)
    else:
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is visible")
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--smoke", "--requests", "4", "--wave-size", "4"])


def test_load_policy_reads_a_legacy_npz(tmp_path):
    rng = np.random.default_rng(11)
    arrays = {"w1": rng.standard_normal((6, 32)), "b1": np.zeros(32),
              "w2": rng.standard_normal((32, 1)), "b2": np.zeros(1)}
    path = tmp_path / "q.npz"
    np.savez(path, **arrays)
    params, spec = serve.load_policy(str(path), torch.Generator(),
                                     device="cpu")
    assert spec.name == "mlp"
    for k, v in arrays.items():
        np.testing.assert_array_equal(params[k].numpy(), v.astype(np.float32))
    fresh = serve.load_qnet("", torch.Generator().manual_seed(0), device="cpu")
    assert set(fresh) == set(arrays)
