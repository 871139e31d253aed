"""Time the steps of kernel 7's bfloat16 wgmma forward on one CUDA card:
the design as built and the schedules it was measured against, each built
from this checkout's ``csrc/flash_attention.cu`` with a patch applied.

    python3 scripts/fwd_steps.py [--rows prefill,train_4k,...]

Steps (patches of the source, applied in a copy under the ignored
``build/fwd_steps/``; a patch whose text the source no longer holds fails
the run):

* ``one block an item``: the producer/consumer kernel with one block a
  work item (batch, query head, 128 query rows), as the hardware deals
  them: ``FwdTiles::PERSISTENT`` off at D = 128.
* ``one block an item + ping-pong``: FlashAttention-3's ping-pong, the
  two consumer warpgroups taking turns at the tensor cores by named
  barriers around each product.
* ``one block an item + next S first``: FlashAttention-3's overlap within
  a warpgroup at D = 128, the next tile's S = Q K^T issued with this
  tile's P V and its softmax run while P V does (the loop peeled so that
  ptxas can keep the products asynchronous).
* ``design``: the source as it is (persistent at D = 128: one block an SM
  over the work items, the next item's loads under this one's tail).
* ``design + ping-pong`` and ``design + next S first``: the two overlaps on
  the design.

Each step at every row of ``chip_smoke.FA_FWD_TIMED`` (inputs
``chip_smoke._qkv(shape, device, SEED + 29)``, as ``scripts/bwd_timings.py``):
held to ``flash_attention_plain`` within ``chip_smoke.LM_TOL``, then device
time per call from a CUDA graph of 20 calls (median of 5 replays), beside
``scaled_dot_product_attention`` on the same tensors.  ptxas's registers
and spills of each step's wgmma instances are printed.  One JSON object a
line, the card's name and power limit in each.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
from chip_smoke import (FA_FWD_TIMED, LM_TOL, SEED, _qkv,  # noqa: E402
                        graph_time_ms)

PLAIN_LOOP_S = """        mbar_wait(bar_k + 8 * st, phase);
        wgmma_fence();
        qk(s, st);
"""
PLAIN_LOOP_PV = """        mbar_wait(bar_v + 8 * st, phase);
        wgmma_fence();
        pv(pa, st);
"""
CONSUMER_START = """    int st = 0;
    uint32_t phase = 0;
    for (int n = 0, item; (item = deal(n)) < n_items; ++n) {
      const FwdItem<BM, BN> it("""
LOOP_START = """      for (int kt = 0; kt < it.n_tiles; ++kt) {
        float s[BN / 2];
"""
LOOP_END = """        mbar_arrive(bar_empty + 8 * st);   // this thread is done with it
        if (++st == ST) st = 0, phase ^= 1;
      }
"""
OVERLAP = """      if constexpr (D == 128) {
        float s[BN / 2], corr[2];
        uint32_t pa[BN / 4];
        auto& s4 = *reinterpret_cast<float(*)[BN / 8][4]>(&s);
        mbar_wait(bar_k + 8 * st, phase);
        wgmma_fence();
        qk(s, st);
        wgmma_wait<0>();
        fence_regs(s);
        if (it.n_tiles == 1) mbar_arrive(bar_qfree);
        if (BN > it.kmin) mask_tile(s4, 0, kend);
        softmax_scores(s4, m, l, corr, scale);
        acc_to_afrag<BN / 16>(pa, s);
        for (int kt = 0; kt + 1 < it.n_tiles; ++kt) {
          const int st1 = st + 1 == ST ? 0 : st + 1;
          const uint32_t ph1 = st + 1 == ST ? phase ^ 1 : phase;
          mbar_wait(bar_k + 8 * st1, ph1);
          mbar_wait(bar_v + 8 * st, phase);
          wgmma_fence();
          qk(s, st1);
          pv(pa, st);
          wgmma_wait<1>();
          fence_regs(s);
          if (kt + 2 == it.n_tiles) mbar_arrive(bar_qfree);
          if ((kt + 2) * BN > it.kmin) mask_tile(s4, (kt + 1) * BN, kend);
          softmax_scores(s4, m, l, corr, scale);
          wgmma_wait<0>();
          fence_regs(oacc);
          fence_regs(pa);
          mbar_arrive(bar_empty + 8 * st);
          rescale(o4, corr);
          acc_to_afrag<BN / 16>(pa, s);
          st = st1, phase = ph1;
        }
        mbar_wait(bar_v + 8 * st, phase);
        wgmma_fence();
        pv(pa, st);
        wgmma_wait<0>();
        fence_regs(oacc);
        fence_regs(pa);
        mbar_arrive(bar_empty + 8 * st);
        if (++st == ST) st = 0, phase ^= 1;
      } else
"""
PATCHES = {
    "one_block_an_item": [("static constexpr bool PERSISTENT = D == 128;",
                           "static constexpr bool PERSISTENT = false;")],
    # warpgroup w waits on barrier 3 + w and hands the turn on with 4 - w;
    # warpgroup 1 gives warpgroup 0 the first turn and keeps its very last
    "ping_pong": [
        (CONSUMER_START, CONSUMER_START.replace(
            "    uint32_t phase = 0;\n",
            "    uint32_t phase = 0;\n    if (wg == 1) named_bar_arrive(3, 256);\n")),
        (PLAIN_LOOP_S, PLAIN_LOOP_S.replace(
            "        wgmma_fence();\n",
            "        named_bar_sync(3 + wg, 256);\n        wgmma_fence();\n")
         + "        named_bar_arrive(4 - wg, 256);\n"),
        (PLAIN_LOOP_PV, PLAIN_LOOP_PV.replace(
            "        wgmma_fence();\n",
            "        named_bar_sync(3 + wg, 256);\n        wgmma_fence();\n")
         + "        if (!(wg == 1 && kt + 1 == it.n_tiles &&\n"
           "              deal(n + 1) >= n_items))\n"
           "          named_bar_arrive(4 - wg, 256);\n")],
    "next_s_first": [(LOOP_START, OVERLAP + LOOP_START)],
}
STEPS = {"one block an item": ["one_block_an_item"],
         "one block an item + ping-pong": ["one_block_an_item", "ping_pong"],
         "one block an item + next S first": ["one_block_an_item",
                                              "next_s_first"],
         "design": [],
         "design + ping-pong": ["ping_pong"],
         "design + next S first": ["next_s_first"]}


def build_steps(out_dir):
    """{step: (library path, ptxas log)}: every step's patched source,
    compiled by one nvcc each, all at once."""
    from repro_torch.kernels import _build

    procs = {}
    for i, (step, names) in enumerate(STEPS.items()):
        d = out_dir / f"step{i}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        src = (d / "flash_attention.cu").read_text()
        for name in names:
            for old, new in PATCHES[name]:
                if src.count(old) != 1:
                    raise SystemExit(f"fwd_steps: patch {name} no longer "
                                     f"applies to flash_attention.cu")
                src = src.replace(old, new)
        (d / "flash_attention.cu").write_text(src)
        lib = d / "libflash_attention.so"
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
               str(lib), str(d / "flash_attention.cu")]
        procs[step] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    out = {}
    for step, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"fwd_steps: nvcc failed for {step}:\n{log}")
        out[step] = (lib, log)
    return out


def wgmma_ptxas(log):
    """{wgmma instance: (registers, spill store bytes, spill load bytes)}."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1) if "wgmma" in m.group(1) else None
            if fn:
                out[fn] = [0, 0, 0]
        elif fn:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                out[fn][1:] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[fn][0] = int(m.group(1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", default=",".join(FA_FWD_TIMED))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fwd_steps: no CUDA device is visible")
    from repro_torch.kernels import flash_attention as fa

    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    libs = build_steps(ROOT / "build" / "fwd_steps")
    fns = {}
    for step, (lib, log) in libs.items():
        print(json.dumps(dict(kind="ptxas", step=step, card=smi,
                              wgmma=wgmma_ptxas(log))), flush=True)
        fn = ctypes.CDLL(str(lib)).flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[step] = fn
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for row in args.rows.split(","):
        *shape, causal, with_lse = FA_FWD_TIMED[row]
        b, sq, skv, hq, hkv, d = shape
        q, k, v = (t.to(torch.bfloat16)
                   for t in _qkv(tuple(shape), device, SEED + 29))
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        o = torch.empty_like(q)
        lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=device)
               if with_lse else None)
        p = fa.plan(d, torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = graph_time_ms(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                            enable_gqa=hq != hkv), 20)
        for step, fn in fns.items():
            def call(fn=fn):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         o.data_ptr(), None if lse is None else lse.data_ptr(),
                         b, sq, skv, hq, hkv, d, int(causal), 1, p.rows,
                         p.smem_bytes, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{step}: launch failed ({err})")

            call()
            torch.cuda.synchronize()
            err = float((o.float() - want.float()).abs().max())
            assert err <= LM_TOL[torch.bfloat16], (step, row, err)
            ms = graph_time_ms(call, 20)
            print(json.dumps(dict(kind="time", step=step, row=row,
                                  shape=shape + [causal, with_lse], card=smi,
                                  ms=ms, sdpa_ms=lib_ms,
                                  ratio=ms / lib_ms, max_abs_err=err)),
                  flush=True)
        del q, k, v, want, o, lse
    return 0


if __name__ == "__main__":
    sys.exit(main())
