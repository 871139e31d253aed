"""The port's LM training path against the JAX reference on the CPU:
``loss_and_metrics`` and its gradients for every family, ``make_train_step``
over a few steps, the schedule, the data, the analytic FLOPs and bytes,
``launch.train.main`` with a crash and a resume, and a checkpoint written
by the reference's ``launch/train.py`` trained on in the port.

Weights come from the reference's ``init_params`` (``convert``), tokens
and activations from numpy.  Tolerances, each with its reason:
* float32 configs (the smoke configs' dtypes replaced): the loss, every
  metric and every gradient leaf within 1e-5 of the reference's, a leaf's
  error relative to its largest element (the port runs the attention over
  key blocks with an online softmax and the selective scan step by step,
  the reference all keys at once and a chunked associative scan);
* ``make_train_step``: params (absolute) and metrics within 1e-5 after 3
  steps, at a learning rate that moves the params by 1e-4 to 3e-4 a step
  (so 1e-5 is a twentieth of an update or less).  Not closer: AdamW's
  update g / (|g| + eps) turns a 1e-10 difference of a gradient element
  near eps = 1e-8 into a hundredth of that element's step; the moments
  within 1e-4 of their leaf's largest element in float32, one bfloat16
  step in bfloat16;
* data, FLOPs, bytes, the warmup rate, a CPU crash and resume: exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import loader as jloader, synthetic as jsynth
from repro.launch import steps as jsteps, train as jtrain
from repro.models import model as jmdl
from repro.optim import adam as jadam, schedule as jschedule
from repro.roofline import flops as jflops
from repro.checkpoint import ckpt as jckpt
from repro_torch import convert
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import base as tbase
from repro_torch.data import loader as tloader, synthetic as tsynth
from repro_torch.launch import steps as tsteps, train as ttrain
from repro_torch.models import model as tmdl
from repro_torch.optim import AdamConfig, adam_init, schedule as tschedule
from repro_torch.roofline import flops as tflops

F32 = dict(dtype="float32", param_dtype="float32", cache_dtype="float32")
# one arch a family: dense, moe, ssm, hybrid, vlm, audio
FAMILY_ARCHS = ["olmo-1b", "qwen2-moe-a2.7b", "falcon-mamba-7b",
                "jamba-1.5-large-398b", "internvl2-76b", "whisper-medium"]
TOL = 1e-5


def _cfgs(arch, dtypes=F32):
    jc = jbase.get_config(arch, smoke=True)
    tc = tbase.get_config(arch, smoke=True)
    return (dataclasses.replace(jc, **dtypes), dataclasses.replace(tc, **dtypes))


def _np_batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "loss_mask": (rng.random((b, s)) > 0.2).astype(np.float32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = (0.02 * rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model))).astype(np.float32)
    if cfg.num_vision_tokens:
        batch["patch_embeds"] = (0.02 * rng.standard_normal(
            (b, cfg.num_vision_tokens, cfg.d_model))).astype(np.float32)
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: (torch.from_numpy(np.array(v)).long()
                if k in ("tokens", "targets")
                else torch.from_numpy(np.array(v)))
            for k, v in batch.items()}


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts, keys joined by '/'."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _leaves_close(got, want, tol, what, absolute=False):
    """Every leaf within ``tol`` of the reference's, relative to the leaf's
    largest element (or ``absolute``)."""
    got, want = _flat(got), _flat(jax.tree.map(np.asarray, want))
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for key, w in want.items():
        w = np.asarray(w, np.float32)
        err = float(np.max(np.abs(_np(got[key]) - w), initial=0.0))
        scale = 1.0 if absolute else max(float(np.max(np.abs(w),
                                                      initial=0.0)), 1e-30)
        assert err <= tol * scale, (what, key, err, scale)


# ---------------------------------------------------------------------------
# loss and gradients, every family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_metrics_and_gradients_match_the_reference(arch):
    jc, tc = _cfgs(arch)
    jp = jmdl.init_params(jax.random.PRNGKey(1), jc)
    batch = _np_batch(jc, 2, 16, seed=2)
    (loss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jmdl.loss_and_metrics(p, jc, b), has_aux=True))(
            jp, _jax_batch(batch))
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    tm, tg = tsteps.value_and_grad(tc, tp, _torch_batch(batch))
    assert set(tm) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=TOL,
                                   atol=TOL, err_msg=key)
    if jc.moe_num_experts:
        assert float(tm["aux"]) > 0
    _leaves_close(tg, jg, TOL, arch)


def test_loss_without_a_mask_is_the_plain_mean():
    jc, tc = _cfgs("olmo-1b")
    jp = jmdl.init_params(jax.random.PRNGKey(0), jc)
    batch = _np_batch(jc, 2, 8, seed=5)
    del batch["loss_mask"]
    _, jm = jmdl.loss_and_metrics(jp, jc, _jax_batch(batch))
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    with torch.no_grad():
        _, tm = tmdl.loss_and_metrics(tp, tc, _torch_batch(batch))
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=TOL,
                                   atol=TOL, err_msg=key)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _adam_cases(jc):
    big = dict(lr=0.02)                # 1e-4 to 3e-4 at warmup steps 1-3
    return {
        "default": (dataclasses.replace(jsteps.default_adam(jc), **big),
                    dataclasses.replace(tsteps.default_adam(jc), **big)),
        "bf16_moments": (jadam.AdamConfig(moment_dtype="bfloat16",
                                          master_dtype="", weight_decay=0.1,
                                          grad_clip_norm=1.0, **big),
                         AdamConfig(moment_dtype="bfloat16", master_dtype="",
                                    weight_decay=0.1, grad_clip_norm=1.0,
                                    **big)),
    }


@pytest.mark.parametrize("micro,adam", [(1, "default"), (2, "default"),
                                        (1, "bf16_moments")])
def test_train_step_matches_the_reference_over_three_steps(micro, adam):
    jc, tc = _cfgs("olmo-1b")
    jadam_cfg, tadam_cfg = _adam_cases(jc)[adam]
    assert jadam_cfg.grad_clip_norm > 0          # clipping on
    jstep, _ = jsteps.make_train_step(jc, jadam_cfg, num_microbatches=micro,
                                      total_steps=50)
    tstep, _ = tsteps.make_train_step(tc, tadam_cfg, num_microbatches=micro,
                                      total_steps=50)
    jp = jmdl.init_params(jax.random.PRNGKey(3), jc)
    jo = jadam.adam_init(jp, jadam_cfg)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    to = adam_init(tp, tadam_cfg)
    jstep = jax.jit(jstep)
    for i in range(3):
        batch = _np_batch(jc, 4, 12, seed=10 + i)
        jp, jo, jm = jstep(jp, jo, _jax_batch(batch))
        tp, to, tm = tstep(tp, to, _torch_batch(batch))
        for key in jm:
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=TOL, atol=TOL, err_msg=key)
    _leaves_close(tp, jp, TOL, "params", absolute=True)
    assert int(to["step"]) == int(jo["step"]) == 3
    moment_tol = 2.0 ** -7 if tadam_cfg.moment_dtype == "bfloat16" else 1e-4
    for key in ("m", "v"):
        _leaves_close(to[key], jo[key], moment_tol, key)
    if "master" in jo:
        _leaves_close(to["master"], jo["master"], TOL, "master",
                      absolute=True)


def test_train_step_keeps_the_tree_and_dtypes():
    jc, tc = _cfgs("whisper-medium", {})          # bf16 params, f32 master
    gen = torch.Generator().manual_seed(0)
    params, opt = tsteps.init_train_state(gen, tc, device="cpu")
    step, _ = tsteps.make_train_step(tc, num_microbatches=2, total_steps=10)
    batch = _torch_batch(_np_batch(jc, 2, 8, seed=0))
    batch["frames"] = batch["frames"].to(torch.bfloat16)
    new, opt, metrics = step(params, opt, batch)
    old, got = _flat(params), _flat(new)
    assert set(old) == set(got)
    for key, x in old.items():
        assert got[key].dtype == x.dtype and got[key].shape == x.shape, key
    assert {"loss", "ce", "zloss", "aux", "accuracy", "grad_norm",
            "lr"} <= set(metrics)
    assert all(torch.isfinite(m).all() for m in metrics.values())


def test_microbatch_split_must_divide_the_batch():
    _, tc = _cfgs("olmo-1b")
    params, opt = tsteps.init_train_state(torch.Generator().manual_seed(0),
                                          tc, device="cpu")
    step, _ = tsteps.make_train_step(tc, num_microbatches=3)
    with pytest.raises(ValueError, match="microbatches"):
        step(params, opt, _torch_batch(_np_batch(tc, 4, 8, seed=0)))


def test_step_helpers_match_the_reference():
    for arch in jbase.list_archs():
        jc, tc = jbase.get_config(arch), tbase.get_config(arch)
        assert dataclasses.asdict(tsteps.default_adam(tc)) == \
            dataclasses.asdict(jsteps.default_adam(jc))
        for gb in (1, 32, 256, 1024):
            assert tsteps.num_microbatches(arch, gb) == \
                jsteps.num_microbatches(arch, gb)
    assert tsteps.TRAIN_MICROBATCH == jsteps.TRAIN_MICROBATCH


def test_prefill_and_decode_steps_wrap_the_model():
    jc, tc = _cfgs("olmo-1b")
    jp = jmdl.init_params(jax.random.PRNGKey(0), jc)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    toks = _np_batch(jc, 2, 8, seed=1)["tokens"]
    jl, _ = jsteps.make_prefill_step(jc)(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, cache = tsteps.make_prefill_step(tc)(
            tp, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    full = tmdl.init_cache(tc, 2, 9, device="cpu")
    for name, sub in full.items():
        for leaf, t in sub.items():
            t[:, :, :8] = cache[name][leaf]
    with torch.no_grad():
        logits, _ = tsteps.make_decode_step(tc)(
            tp, {"tokens": torch.zeros((2, 1), dtype=torch.long)}, full, 8)
    assert logits.shape == (2, tc.padded_vocab)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


def test_constant_lr_is_exact():
    steps = torch.arange(0, 5, dtype=torch.int32)
    got = tschedule.constant_lr(3e-4)(steps)
    assert got.dtype == torch.float32
    assert float(got) == float(np.float32(jschedule.constant_lr(3e-4)(0)))


def test_cosine_warmup_matches_the_reference():
    """Exact on the warmup branch against the reference evaluated op by op
    (``jax.disable_jit``, the same float32 arithmetic); after it within 8
    float32 ulps of the jitted reference, whose XLA rewrites a division by
    a constant into a product by its reciprocal and computes its own
    float32 cosine."""
    tsched = tschedule.cosine_warmup(3e-4, 200, 1000)
    jsched = jschedule.cosine_warmup(3e-4, 200, 1000)
    steps = np.arange(0, 1200, dtype=np.int32)
    got = tsched(torch.from_numpy(steps)).numpy()
    with jax.disable_jit():
        eager = np.array([np.asarray(jsched(jnp.int32(s))) for s in range(200)])
    np.testing.assert_array_equal(got[:200], eager)
    jitted = np.asarray(jax.jit(jax.vmap(jsched))(jnp.asarray(steps)))
    ulps = np.abs(got.astype(np.float64) - jitted) / np.spacing(
        np.abs(jitted).astype(np.float32))
    assert ulps[200:].max() <= 8, ulps.max()


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_synthetic_tokens_on_the_references_draws():
    for seed, step, batch, seq in ((0, 0, 8, 513), (1, 7, 3, 65),
                                   (2, 123, 4, 200)):
        for vocab in (256, 50304):
            key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
            k1, _, k3 = jax.random.split(key, 3)
            u = np.asarray(jax.random.uniform(k1, (batch,)))
            noise = np.asarray(jax.random.uniform(k3, (batch, seq)))
            want = np.asarray(jsynth.synthetic_lm_tokens(key, batch, seq,
                                                         vocab))
            got = tsynth.synthetic_lm_tokens(u, noise, vocab)
            assert got.dtype == torch.int64
            np.testing.assert_array_equal(got.numpy(), want)


def test_synthetic_batches_are_seekable_and_shaped():
    jc, tc = _cfgs("whisper-medium", {})
    stream = tsynth.synthetic_batches(0, 2, 12, tc.vocab_size, cfg=tc)
    first = [next(stream) for _ in range(4)]
    again = next(tsynth.synthetic_batches(0, 2, 12, tc.vocab_size, cfg=tc,
                                          start_step=3))
    for key in first[3]:
        torch.testing.assert_close(again[key], first[3][key], rtol=0, atol=0)
    b = first[0]
    assert b["tokens"].shape == b["targets"].shape == (2, 12)
    torch.testing.assert_close(b["tokens"][:, 1:], b["targets"][:, :-1])
    assert b["frames"].dtype == torch.bfloat16
    assert b["frames"].shape == (2, tc.enc_seq, tc.d_model)
    assert 0.01 < float(b["frames"].float().std()) < 0.03
    assert not torch.equal(first[0]["tokens"], first[1]["tokens"])
    _, vc = _cfgs("internvl2-76b", {})
    pe = next(tsynth.synthetic_batches(0, 2, 12, vc.vocab_size, cfg=vc))
    assert pe["patch_embeds"].shape == (2, vc.num_vision_tokens, vc.d_model)


@pytest.mark.parametrize("dtype", ["uint16", "uint32"])
def test_memmap_batches_and_host_slice_are_the_references(tmp_path, dtype):
    path = tmp_path / "tokens.bin"
    rng = np.random.default_rng(0)
    rng.integers(0, 60000, 4 * 9 * 7 + 5).astype(dtype).tofile(path)
    kw = dict(batch=4, seq_len=8, seed=3, token_file=str(path),
              token_dtype=dtype)
    for host in (dict(), dict(host_index=1, host_count=2)):
        jcfg, tcfg = (jloader.DataConfig(**kw, **host),
                      tloader.DataConfig(**kw, **host))
        jit = jloader._memmap_batches(jcfg, start_step=5)
        tit = tloader._memmap_batches(tcfg, start_step=5)
        for _ in range(9):                     # past one pass of 7 batches
            jb = jloader._host_slice(next(jit), jcfg)
            tb = tloader._host_slice(next(tit), tcfg)
            assert set(jb) == set(tb)
            for key in jb:
                np.testing.assert_array_equal(tb[key].numpy(),
                                              np.asarray(jb[key]))
        it = tloader.make_loader(tcfg, start_step=5)
        first = next(it)
        it.close()
        ref = jloader._host_slice(next(jloader._memmap_batches(jcfg, 5)),
                                  jcfg)
        np.testing.assert_array_equal(first["tokens"].numpy(),
                                      np.asarray(ref["tokens"]))


def test_loader_surfaces_a_source_error(tmp_path):
    cfg = tloader.DataConfig(token_file=str(tmp_path / "missing.bin"))
    it = tloader.make_loader(cfg)
    with pytest.raises(FileNotFoundError):
        next(it)


# ---------------------------------------------------------------------------
# analytic FLOPs and bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jbase.list_archs())
def test_flops_and_bytes_equal_the_references(arch):
    jc, tc = jbase.get_config(arch), tbase.get_config(arch)
    for name, shape in jbase.SHAPES.items():
        tshape = tbase.SHAPES[name]
        assert tflops.cell_flops(tc, tshape) == jflops.cell_flops(jc, shape)
        assert tflops.cell_flops(tc, tshape, remat_full=False) == \
            jflops.cell_flops(jc, shape, remat_full=False)
        for chips, nm in ((1, 1), (256, 4)):
            assert tflops.cell_hbm_bytes(tc, tshape, chips, nm) == \
                jflops.cell_hbm_bytes(jc, shape, chips, nm)
        assert tflops.forward_flops_per_token(tc, shape.seq_len) == \
            jflops.forward_flops_per_token(jc, shape.seq_len)


def test_roofline_is_the_h100s():
    from repro_torch.roofline import HW, roofline_terms

    assert (HW.peak_flops, HW.hbm_bw, HW.link_bw) == (989e12, 3.35e12, 900e9)
    terms = roofline_terms(n_chips=1, hlo_flops_global=989e12,
                           model_flops=494.5e12, hbm_bytes_per_chip=1.0,
                           collective_bytes_per_chip=0.0)
    assert terms["dominant"] == "compute" and terms["compute_s"] == 1.0
    assert terms["roofline_fraction"] == 0.5


# ---------------------------------------------------------------------------
# launch.train on the CPU; a reference checkpoint trained on in the port
# ---------------------------------------------------------------------------


def test_train_main_crashes_and_resumes_bit_for_bit(tmp_path, capsys):
    base = ["--arch", "olmo-1b", "--smoke", "--steps", "24", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--ckpt-every", "4",
            "--log-every", "100"]
    full = ttrain.main(base + ["--ckpt-dir", str(tmp_path / "a")])
    with pytest.raises(SystemExit) as exc:
        ttrain.main(base + ["--ckpt-dir", str(tmp_path / "b"),
                            "--fail-at", "10"])
    assert exc.value.code == 17
    rest = ttrain.main(base + ["--ckpt-dir", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "[train] resumed from step 8" in out and "improved" in out
    assert len(full) == 24 and rest == full[9:]
    assert all(np.isfinite(full))
    assert tckpt.latest_step(str(tmp_path / "b")) == 23


def test_reference_checkpoint_trains_on_in_the_port(tmp_path):
    """The reference's ``launch/train.py`` (smoke OLMo, bf16 params with a
    float32 master) writes a checkpoint; the port restores it and takes the
    step the reference takes next, on the same batch: the float32 master
    within 1e-5, the bf16 params within one bf16 step of their value plus
    1e-5 (the master's rounding to bf16 may fall either side)."""
    ckpt = str(tmp_path / "ref")
    jtrain.main(["--arch", "olmo-1b", "--smoke", "--steps", "3", "--batch",
                 "2", "--seq", "16", "--ckpt-dir", ckpt, "--log-every",
                 "100"])
    jc, tc = jbase.get_config("olmo-1b", True), tbase.get_config("olmo-1b",
                                                                 True)
    adam_j = dataclasses.replace(jsteps.default_adam(jc), lr=3e-4)
    adam_t = dataclasses.replace(tsteps.default_adam(tc), lr=3e-4)
    jp = jmdl.init_params(jax.random.PRNGKey(0), jc)
    jstate = jckpt.restore(ckpt, {"params": jp,
                                  "opt": jadam.adam_init(jp, adam_j)})
    tp = tmdl.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    tstate = tckpt.restore(ckpt, {"params": tp, "opt": adam_init(tp, adam_t)},
                           device="cpu")
    # the same state through numpy (``convert``): what the manifest holds
    via = convert.opt_state_from_numpy(jax.tree.map(np.asarray,
                                                    jstate["opt"]),
                                       device="cpu")
    _leaves_close(tstate["opt"], via, 0.0, "restored opt")
    assert int(tstate["opt"]["step"]) == 3
    batch = next(jsynth.synthetic_batches(0, 2, 16, jc.vocab_size, cfg=jc,
                                          start_step=3))
    jstep, _ = jsteps.make_train_step(jc, adam_j, total_steps=3)
    tstep, _ = tsteps.make_train_step(tc, adam_t, total_steps=3)
    jp2, jo2, _ = jax.jit(jstep)(jstate["params"], jstate["opt"], batch)
    tp2, to2, _ = tstep(tstate["params"], tstate["opt"],
                        _torch_batch(jax.tree.map(np.asarray, batch)))
    _leaves_close(to2["master"], jo2["master"], TOL, "master", absolute=True)
    for key, want in _flat(jax.tree.map(np.asarray, jp2)).items():
        got = _np(_flat(tp2)[key])
        want = np.asarray(want, np.float32)
        assert np.all(np.abs(got - want) <= np.abs(want) * 2.0 ** -7 + TOL), key
