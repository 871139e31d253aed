"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: cells of
OLMo-1B, qwen2-moe, whisper-medium and falcon-mamba-7b planned on fake
tensors through the card's path, held to the reference's analytic figures
(``cell_flops``, ``cell_hbm_bytes``, ``param_count``) and to the bytes its
sharding specs leave on a card of a 16 x 16 mesh; the counted FLOPs
between 0.95 x 6ND-style model FLOPs and the reference's implementation
FLOPs for the dense cells; the count scaled from one and two blocks equal
to the whole-depth count at smoke depth; each noted launch's FLOPs equal
to what ``FlopCounterMode`` counts for the kernel's plain version."""
import dataclasses
import json
import math
import pathlib
import re

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES, get_config
from repro.launch import sharding as rsh, shapes as rshp, steps as rsteps
from repro.optim import adam_init as radam_init
from repro.roofline import flops as rflops
from repro_torch.configs.base import get_config as tget_config
from repro_torch import kernels
from repro_torch.kernels import (_build, decode_attention as da,
                                 flash_attention as fa, mamba_scan as ms, ops)
from repro_torch.launch import dryrun, sharding as tsh
from repro_torch.models import model as mdl

CELLS = [("olmo-1b", "train_4k", 256), ("qwen2-moe-a2.7b", "decode_32k", 0),
         ("whisper-medium", "prefill_32k", 0),
         ("falcon-mamba-7b", "long_500k", 0)]
HBM = 80e9


@pytest.fixture(scope="module")
def planned():
    """{(arch, shape): the cell on one card and on a 16 x 16 mesh}."""
    out = {}
    for arch, shape, micro in CELLS:
        mode = FakeTensorMode()
        out[arch, shape] = tuple(
            dryrun.run_cell(arch, shape, mesh, micro=micro, mode=mode,
                            limit=(HBM, "test"))
            for mesh in (tsh.ONE_CARD, tsh.MeshShape(("data", "model"),
                                                     (16, 16))))
    return out


def ref_bytes_on_a_card(arch, shape_name):
    """The bytes the reference's specs leave on a card of its 16 x 16 mesh:
    params, AdamW state and batch (decode: params, cache, tokens)."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    mesh = jax.sharding.AbstractMesh((16, 16), ("data", "model"))
    params = rshp.params_specs(cfg)
    p_specs = rsh.param_specs(params, cfg, mesh)
    trees = [(params, p_specs)]
    specs = rshp.input_specs(cfg, shape)
    if shape.kind == "train":
        opt = jax.eval_shape(lambda p: radam_init(p, rsteps.default_adam(cfg)),
                             params)
        trees.append((opt, rsh.opt_state_specs(opt, p_specs, mesh)))
    if shape.kind == "decode":
        trees.append((specs["cache"], rsh.cache_specs(
            specs["cache"], cfg, mesh, shape.global_batch)))
    trees.append((specs["batch"], rsh.input_sharding(mesh, specs["batch"])))
    total = 0
    for tree, spec_tree in trees:
        leaves = jax.tree.leaves(tree)
        spec_leaves = jax.tree.leaves(
            spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        for leaf, spec in zip(leaves, spec_leaves, strict=True):
            share = math.prod(
                1 if a is None else mesh.shape[a] if isinstance(a, str)
                else math.prod(mesh.shape[x] for x in a) for a in spec)
            total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize // share
    return total


@pytest.mark.parametrize("arch,shape,micro", CELLS)
def test_analytic_fields_equal_the_reference(planned, arch, shape, micro):
    cell, _ = planned[arch, shape]
    cfg = get_config(arch)
    ref = rflops.cell_flops(cfg, SHAPES[shape], remat_full=cfg.remat == "full")
    nm = micro if SHAPES[shape].kind == "train" else 1
    assert cell["num_microbatches"] == nm
    assert cell["model_params"] == cfg.param_count()
    assert cell["active_params"] == cfg.active_param_count()
    assert cell["roofline"]["hlo_flops_global"] == ref["hlo_flops"]
    assert cell["roofline"]["model_flops"] == ref["model_flops"]
    assert cell["analytic_hbm_bytes_per_chip"] == rflops.cell_hbm_bytes(
        cfg, SHAPES[shape], 1, num_microbatches=nm, tp=1)
    assert cell["tokens"] == SHAPES[shape].global_batch * (
        1 if SHAPES[shape].is_decode else SHAPES[shape].seq_len)


@pytest.mark.parametrize("arch,shape,micro", CELLS)
def test_bytes_on_a_card_of_16x16_equal_the_reference_specs(planned, arch,
                                                            shape, micro):
    one, mesh = planned[arch, shape]
    assert mesh["memory"]["argument_size_in_bytes"] == ref_bytes_on_a_card(
        arch, shape)
    assert mesh["n_chips"] == 256 and mesh["fits_hbm_80g"] is None
    assert mesh["memory"]["temp_size_in_bytes"] is None
    assert mesh["collectives"]["total_bytes"] is None
    assert mesh["roofline"]["collective_s"] is None
    assert one["collectives"]["total_bytes"] == 0
    assert one["memory"]["argument_size_in_bytes"] == sum(
        one["memory"]["argument_parts"].values())


@pytest.mark.parametrize("arch,shape,micro", [CELLS[0], CELLS[2], CELLS[1]])
def test_counted_flops_between_model_and_implementation_flops(planned, arch,
                                                              shape, micro):
    cell, _ = planned[arch, shape]
    counted = cell["cost"]["flops"]
    roof = cell["roofline"]
    if get_config(arch).moe_num_experts:        # every expert, its capacity
        assert counted >= 0.95 * roof["model_flops"]
        return
    assert 0.95 * roof["model_flops"] <= counted <= roof["hlo_flops_global"]


@pytest.fixture(scope="module")
def olmo_train_4k(planned):
    """{remat: OLMo-1B's train_4k at --micro 256 on one card}: the
    config's "full" from ``planned``, "none" planned here."""
    none = dryrun.run_cell("olmo-1b", "train_4k", micro=256,
                           overrides={"remat": "none"}, limit=(HBM, "test"))
    return {"full": planned["olmo-1b", "train_4k"][0], "none": none}


# kernel 7's launches in the traced step (16 layers x 2 microbatches): the
# forward's once a layer, and again in the backward under "full"
OLMO_LAUNCHES = {"none": {"flash_attention": 32, "flash_attention_bwd": 32},
                 "full": {"flash_attention": 64, "flash_attention_bwd": 32}}


@pytest.mark.parametrize("remat", ["none", "full"])
def test_plans_of_the_two_checked_cells(planned, olmo_train_4k, remat):
    olmo = olmo_train_4k[remat]
    assert olmo["remat"] == remat
    mem = olmo["memory"]
    assert olmo["fits_hbm_80g"] is True
    assert olmo["hbm_bytes_per_chip"] == (
        mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        + mem["output_size_in_bytes"] - mem["alias_size_in_bytes"])
    assert mem["alias_size_in_bytes"] == 0          # nothing in place
    parts = mem["argument_parts"]
    assert mem["traced_rows"] == 2 and mem["traced_microbatches"] == 2
    assert mem["traced_argument_bytes"] == (
        parts["params"] + parts["opt_state"] + parts["batch"] * 2 // 256)
    # 16 layers x 2 microbatches, each through kernel 7 and its backward
    assert mem["launches"] == OLMO_LAUNCHES[remat]
    falcon, _ = planned["falcon-mamba-7b", "long_500k"]
    fm = falcon["memory"]
    assert falcon["fits_hbm_80g"] is True
    assert fm["alias_size_in_bytes"] == fm["argument_parts"]["cache"] > 0
    assert fm["launches"] == {}                    # the decode mixer is plain
    assert fm["traced_argument_bytes"] == fm["argument_size_in_bytes"]
    whisper, _ = planned["whisper-medium", "prefill_32k"]
    assert whisper["fits_hbm_80g"] is False
    assert "stopped" in whisper["memory"]["not_traced"]
    qwen, _ = planned["qwen2-moe-a2.7b", "decode_32k"]
    assert qwen["fits_hbm_80g"] is False
    assert "arguments alone" in qwen["memory"]["not_traced"]


@pytest.mark.parametrize("arch,shape,over", [
    ("olmo-1b", "train_4k", {"num_layers": 5}),
    ("jamba-1.5-large-398b", "train_4k", {"num_layers": 6}),
    ("whisper-medium", "prefill_32k", {"num_layers": 3, "enc_layers": 4}),
    ("qwen2-moe-a2.7b", "decode_32k", {"num_layers": 4}),
    ("falcon-mamba-7b", "prefill_32k", {"num_layers": 3}),
])
def test_scaled_flops_equal_the_whole_depth_count(arch, shape, over):
    # head width 64: the card's backward of kernel 7 has no other at 16
    cfg = dataclasses.replace(tget_config(arch, smoke=True), head_dim=64,
                              **over)
    mode = FakeTensorMode()
    scaled = dryrun.step_flops(arch, shape, mode, cfg=cfg)
    whole = dryrun.step_flops(arch, shape, mode, cfg=cfg, scaled=False)
    assert scaled == whole > 0


def _noted(call, *tensors):
    """(kernel, FLOPs) of the launches ``call`` makes on fake copies of
    ``tensors`` under ``CardStandIn``."""
    mode = FakeTensorMode()
    fake = [mode.from_tensor(t) for t in tensors]
    with mode, dryrun.CardStandIn() as card:
        call(*fake)
    return card.launched


def _counted(call, *tensors):
    with FlopCounterMode(display=False) as fc:
        call(*tensors)
    return fc.get_total_flops()


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", [
    (2, 33, 33, 4, 2, 64, True), (1, 40, 300, 6, 6, 128, False)])
def test_noted_attention_flops_are_the_plain_versions_count(b, sq, skv, hq,
                                                            hkv, d, causal):
    gen = torch.Generator().manual_seed(0)
    q, do = (torch.randn(b, sq, hq, d, generator=gen) for _ in range(2))
    k, v = (torch.randn(b, skv, hkv, d, generator=gen) for _ in range(2))
    out, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                        return_lse=True)
    out = out.contiguous()
    assert _noted(lambda *t: fa.flash_attention(*t, causal=causal),
                  q, k, v) == [("flash_attention", _counted(
                      lambda *t: fa.flash_attention_plain(*t, causal=causal),
                      q, k, v))]
    assert _noted(lambda *t: fa.flash_attention_bwd(*t, causal=causal),
                  q, k, v, out, do, lse) == [("flash_attention_bwd", _counted(
                      lambda *t: fa.flash_attention_bwd_plain(
                          *t, causal=causal), q, k, v, out, do, lse))]
    qd = torch.randn(b, hq, d, generator=gen)
    kc, vc = (torch.randn(b, hkv, skv, d, generator=gen) for _ in range(2))
    assert _noted(lambda *t: da.decode_attention(*t, 7), qd, kc, vc) == [
        ("decode_attention", _counted(
            lambda *t: da.decode_attention_plain(*t, 7), qd, kc, vc))]


def test_noted_scan_flops_are_the_plain_versions_count():
    gen = torch.Generator().manual_seed(1)
    b, s, di, n = 2, 20, 16, 8
    args = [torch.randn(b, s, di, generator=gen), torch.rand(b, s, di,
                                                              generator=gen),
            -torch.rand(di, n, generator=gen), torch.randn(b, s, n, generator=gen),
            torch.randn(b, s, n, generator=gen), torch.randn(di, generator=gen),
            torch.zeros(b, di, n)]
    y, h_t, states = ms.mamba_scan_plain(*args, return_states=True)
    fwd = _noted(ms.mamba_scan, *args) + _noted(ms.mamba_scan_fwd, *args)
    bwd = _noted(lambda *t: ms.mamba_scan_bwd(*t), *args[:6], states, y)
    assert fwd == [("mamba_scan", 0.0), ("mamba_scan_states", 0.0)]
    assert bwd == [("mamba_scan_bwd", 0.0)]
    assert _counted(ms.mamba_scan_plain, *args) == 0
    assert _counted(lambda *t: ms.mamba_scan_bwd_plain(*t), *args[:6],
                    states, y) == 0


def test_card_stand_in_puts_everything_back():
    saved = (kernels.on_card, _build.launch, da.capacity)
    counts = [fn.launches for fn in dryrun.WRAPPERS]
    gen = torch.Generator().manual_seed(2)
    q = torch.randn(1, 16, 2, 64, generator=gen)
    assert len(_noted(lambda t: fa.flash_attention(t, t, t, causal=True),
                      q)) == 1
    with dryrun.CardStandIn():
        assert ops._mode(None, torch.device("cpu")) == "cuda"
        assert _build.on_card("flash_attention", torch.device("cpu"))
    assert (kernels.on_card, _build.launch, da.capacity) == saved
    assert [fn.launches for fn in dryrun.WRAPPERS] == counts
    assert ops._mode(None, torch.device("cpu")) == "plain"
    assert not _build.on_card("flash_attention", torch.device("cpu"))


def test_live_bytes_follow_storages():
    mode = FakeTensorMode()
    with mode:
        known = torch.empty(1000)
        with dryrun.LiveBytes([known]) as live:
            a = torch.empty(250)                    # 1000 bytes
            view = a[10:]                           # no new storage
            b = a + 1                               # 1000
            known.add_(1)                           # in place: not counted
            del a, b
            assert live.live == 1000                # the view keeps a's
            del view
            c = torch.empty(10, dtype=torch.float64)
    assert (live.live, live.peak) == (80, 2000)
    del c
    with mode, pytest.raises(dryrun.PastLimit):
        with dryrun.LiveBytes(limit=100):
            torch.empty(100)


def _cut_olmo(remat):
    """OLMo-1B at smoke widths, head width 64 (the card's backward's)."""
    return dataclasses.replace(tget_config("olmo-1b", smoke=True),
                               head_dim=64, remat=remat)


@pytest.fixture(scope="module")
def cut_train_4k():
    """{remat: the cut OLMo-1B's train_4k cell at --micro 256}."""
    return {remat: dryrun.run_cell("olmo-1b", "train_4k", micro=256,
                                   cfg=_cut_olmo(remat), limit=(HBM, "test"))
            for remat in ("none", "dots", "full")}


def test_remat_orders_the_traced_temp(cut_train_4k):
    temp = {r: c["memory"]["temp_size_in_bytes"]
            for r, c in cut_train_4k.items()}
    assert 0 < temp["full"] < temp["dots"] < temp["none"], temp
    assert all(c["remat"] == r for r, c in cut_train_4k.items())


def _forward_flops(cfg, rows):
    """``FlopCounterMode``'s count of one forward of the blocks on ``rows``
    of 4,096 tokens through the card's path (kernel 7's launches counted
    as its plain version's), outside grad mode: no checkpoint."""
    mode = FakeTensorMode()
    with mode:
        cell = dryrun.build_cell("olmo-1b", "train_4k", micro=256,
                                 microbatches=rows, cfg=cfg, mode=mode)
        with torch.no_grad(), dryrun.CardStandIn() as card, \
                FlopCounterMode(display=False) as fc:
            mdl.forward(cell.parts["params"], cfg,
                        cell.parts["batch"]["tokens"], mode="train")
    return fc.get_total_flops() + card.flops, card.flops


def test_remat_adds_one_forward_of_the_blocks_to_the_flops(cut_train_4k):
    """"full" counts the blocks' forward once more over the global batch,
    but for each block's last product, the MLP's down projection: the
    recompute stops once the backward has every tensor it saved, and that
    product's output is not one.  "dots" counts only what it recomputes
    that is a product: kernel 7's forward (the projections' outputs are
    kept)."""
    cfg = _cut_olmo("none")
    flops = {r: c["cost"]["flops"] for r, c in cut_train_4k.items()}
    forward, attention = _forward_flops(cfg, 1)
    down = 2 * 4096 * cfg.d_ff * cfg.d_model * cfg.num_layers
    assert flops["full"] - flops["none"] == 256 * (forward - down)
    assert flops["dots"] - flops["none"] == 256 * attention > 0


def test_remat_launches_each_forward_twice_a_backward(cut_train_4k):
    layers = _cut_olmo("none").num_layers
    for remat, cell in cut_train_4k.items():
        launches = cell["memory"]["launches"]
        runs = 1 if remat == "none" else 2
        assert launches == {"flash_attention": runs * 2 * layers,
                            "flash_attention_bwd": 2 * layers}, remat


def test_main_takes_remat_into_the_overrides(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(dryrun, "plan_cells", lambda *a, **k: seen.append(
        k["overrides"]) or [])
    for flag, want in (([], None), (["--remat", "dots"], {"remat": "dots"}),
                       (["--remat", "none", "--cache-dtype", "float32"],
                        {"remat": "none", "cache_dtype": "float32"})):
        with pytest.raises(SystemExit) as e:
            dryrun.main(["--arch", "olmo-1b", "--out", str(tmp_path)] + flag)
        assert e.value.code == 0 and seen.pop() == want
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--remat", "some"])
    assert e.value.code == 2                     # argparse refuses it


def test_main_writes_a_file_a_cell_and_the_summary(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "olmo-1b", "--shape", "long_500k",
                     "--out", str(tmp_path)])
    assert e.value.code == 0
    skipped = json.loads((tmp_path / "olmo-1b_long_500k_1_1.json").read_text())
    assert skipped["status"] == "skipped" and "long_500k" in skipped["reason"]
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "granite-8b", "--shape", "decode_32k",
                     "--mesh-shape", "4,2", "--cache-dtype", "float8_e4m3fn",
                     "--out", str(tmp_path)])
    assert e.value.code == 0
    cell = json.loads((tmp_path / "granite-8b_decode_32k_4_2.json").read_text())
    assert cell["status"] == "ok" and cell["n_chips"] == 8
    cache = cell["memory"]["argument_parts"]["cache"]   # float8: a byte each
    assert cache == 36 * 128 * 32768 * 8 * 128 * 2
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert [c["arch"] for c in summary] == ["granite-8b"]
    out = capsys.readouterr().out
    assert "DRY-RUN SUMMARY: 1 ok, 0 skipped (documented), 0 failed" in out
    assert "no card visible" in out


# The sites that read a device's type for the host's sake, not to pick a
# kernel: serving's synchronisation, training's pinned batches, and
# ``check_cell``'s refusal of anything but a card.
HOST_SIDE = {"launch/serve.py": 1, "launch/train.py": 1, "launch/dryrun.py": 1}


def test_every_dispatch_site_asks_on_card():
    """The port picks kernel or plain version only through
    ``kernels.on_card`` (which ``CardStandIn`` replaces): no other module
    tests a device's type for CUDA, so no dispatch escapes a plan."""
    root = pathlib.Path(kernels.__file__).resolve().parents[1]
    pattern = re.compile(r"""\.type\s*[!=]=\s*["']cuda["']|\.is_cuda\b""")
    found = {}
    for path in sorted(root.rglob("*.py")):
        hits = len(pattern.findall(path.read_text()))
        if hits:
            found[path.relative_to(root).as_posix()] = hits
    assert found == dict(HOST_SIDE, **{"kernels/__init__.py": 1}), found


def test_a_failed_cell_exits_1(tmp_path, monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("planned to fail")

    monkeypatch.setattr(dryrun, "plan_cell", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "olmo-1b", "--shape", "train_4k",
                     "--out", str(tmp_path)])
    assert e.value.code == 1
    cell = json.loads((tmp_path / "olmo-1b_train_4k_1_1.json").read_text())
    assert cell["status"] == "failed" and "planned to fail" in cell["error"]


def test_check_cell_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.check_cell("olmo-1b", "train_4k", micro=256)
    with pytest.raises(ValueError, match="measures a card"):
        dryrun.check_cell("olmo-1b", "train_4k", micro=256, device="cpu")


def _chip_smoke():
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


def test_row_tolerance_catches_a_shifted_tile_at_4096_keys():
    """``chip_smoke.py`` phase 23 holds kernel 7 and its backward at
    OLMo-1B's ``train_4k`` attention (1, 4096, 16, 128) to the plain
    twins per row (``FA_ROW_TOL`` of each row's scale).  At two of its
    heads on the CPU: bfloat16's own rounding of the plain output and
    gradients stays within it, a V tile of the last 32 keys read from the
    tile before (and a dO tile of the last 32 queries) does not, while the
    output's error against the whole tensor's stays under ``LM_TOL`` and
    dV's under ``FA_BWD_TOL``, which is why the per-row check is there."""
    cs = _chip_smoke()
    bf16, cpu = torch.bfloat16, torch.device("cpu")
    shape = cs.FA_TRAIN_4K[:3] + (2, 2) + cs.FA_TRAIN_4K[5:]
    q, k, v, do = cs._bwd_case(shape, bf16, cpu, 0)
    out, lse = fa.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    rss = cs.attention_rss(q, k, v, out, do, lse, True)
    exact = fa.flash_attention_plain(*(t.float() for t in (q, k, v)),
                                     causal=True)
    grads = fa.flash_attention_bwd_plain(q, k, v, out, do, lse, causal=True)
    exact_grads = fa.flash_attention_bwd_plain(
        *(t.float() for t in (q, k, v, out, do)), lse, causal=True)
    tol = cs.FA_ROW_TOL[bf16]
    assert cs.row_rel_err(out, exact, rss[0]) < tol / 4
    assert max(cs.row_rel_err(g, e, r) for g, e, r in
               zip(grads, exact_grads, rss[1:])) < tol / 4
    bad = fa.flash_attention_plain(q, k, cs.shifted_tile(v), causal=True)
    assert cs.row_rel_err(bad, out, rss[0]) > 10 * tol
    assert float((bad.float() - out.float()).abs().max()) < cs.LM_TOL[bf16]
    bad_grads = fa.flash_attention_bwd_plain(q, k, v, out,
                                             cs.shifted_tile(do), lse,
                                             causal=True)
    assert min(cs.row_rel_err(b, g, r) for b, g, r in
               zip(bad_grads, grads, rss[1:])) > 10 * tol
    assert cs._rel_err(bad_grads[2], grads[2]) < cs.FA_BWD_TOL[bf16]


def test_row_scale_holds_a_cancelling_dq_row_at_its_terms():
    """The first query of a causal head sees one key, so its dq is 0 up to
    rounding: against its own largest element the float32 plain backward
    reads far past ``FA_ROW_TOL`` of a float64 reference; against the
    root-sum-square of its terms (``attention_rss``) every row, that one
    included, is within it by a wide margin."""
    cs = _chip_smoke()
    f32 = torch.float32
    q, k, v, do = cs._bwd_case((2, 512, 512, 8, 8, 128, True), f32,
                               torch.device("cpu"), 1)
    out, lse = fa.flash_attention_plain(q, k, v, causal=True, return_lse=True)
    grads = fa.flash_attention_bwd_plain(q, k, v, out, do, lse, causal=True)
    live = [t.double().requires_grad_() for t in (q, k, v)]
    scores = torch.einsum("bqhd,bkhd->bhqk", live[0], live[1]) / 128 ** 0.5
    mask = torch.ones(512, 512, dtype=torch.bool).triu(1)
    exact = torch.einsum("bhqk,bkhd->bqhd",
                         scores.masked_fill(mask, -torch.inf).softmax(-1),
                         live[2])
    want = torch.autograd.grad(exact, live, do.double())
    rss = cs.attention_rss(q, k, v, out, do, lse, True)
    assert cs.row_rel_err(grads[0], want[0]) > cs.FA_ROW_TOL[f32]
    assert max(cs.row_rel_err(g, w, r) for g, w, r in
               zip(grads, want, rss[1:])) < cs.FA_ROW_TOL[f32] / 10
    assert cs.row_rel_err(out, exact.detach(), rss[0]) < cs.FA_ROW_TOL[f32] / 10
