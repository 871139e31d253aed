"""Time the port's kernel 7 forward in bfloat16 and its hand-written
backwards (kernel 7's and kernel 6's) on one CUDA card at the paths'
shapes, for this checkout's package or another's, from one build.

    python3 scripts/bwd_timings.py [--src DIR] [--label NAME]
        [--only flash_attention|flash_attention_bwd|mamba_scan_bwd]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so that one run on a card can time another checkout's
kernels beside this one's, in turns (``chip_smoke.py --parent-src DIR``
runs it so, before and after its own timings).

* Kernel 7's forward (``flash_attention``; ``flash_attention_fwd`` where
  the row stores the lse) at every row of ``chip_smoke.FA_FWD_TIMED`` (the
  LM prefill, training's forward, ``train_4k``, whisper's encoder and
  cross-attention, dbrx's 6:1 GQA) in bfloat16, inputs from
  ``chip_smoke._qkv`` (seed ``chip_smoke.SEED + 29``).
* Kernel 7 (``flash_attention_bwd``) at every row of
  ``chip_smoke.FA_BWD_TIMED`` (``chip_smoke.FA_BWD_SHAPES``: OLMo-1B's
  causal (8, 512, 16, 128), whisper's encoder and cross-attention at D =
  64) in bfloat16, inputs from ``chip_smoke._bwd_case`` (seed
  ``chip_smoke.SEED + 24``, as phase 22's timings), the lse from the
  package's own ``flash_attention_fwd``; and at OLMo-1B's ``train_4k``
  (``chip_smoke.FA_TRAIN_4K``, (1, 4096, 16, 128) causal, row
  ``train_4k``, seed ``chip_smoke.SEED + 28``, as phase 23's).
* Kernel 6 (``mamba_scan_bwd``) at every shape of
  ``chip_smoke.SCAN_BWD_TIMED`` (falcon-mamba-7b's training shape (8, 512,
  8192, 16), the mamba class's (1, 32, 8, 4), (2, 256, 1024, 16)), inputs
  from ``chip_smoke._scan_args`` (seed ``chip_smoke.SEED + 26``, as phase
  22's), the chunk states from the package's own ``mamba_scan_fwd``, dhT
  absent and no dh0, as in training.

Each: device time per call from a CUDA graph (20 calls for a forward, 10
for a backward; median of 5 replays, ``chip_smoke.graph_time_ms``), and
each device kernel's microseconds a call under torch.profiler
(``chip_smoke.device_split_us``).
Prints one JSON object a line, the card's name and power limit in each.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import (FA_BWD_SHAPES, FA_BWD_TIMED,  # noqa: E402
                        FA_FWD_TIMED, FA_TRAIN_4K, SCAN_BWD_TIMED, SEED,
                        _bwd_case, _qkv, _scan_args, device_split_us,
                        graph_time_ms)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this")
    ap.add_argument("--only", default="",
                    choices=("", "flash_attention", "flash_attention_bwd",
                             "mamba_scan_bwd"),
                    help="time this kernel's rows alone")
    args = ap.parse_args()
    wanted = {args.only} if args.only else {
        "flash_attention", "flash_attention_bwd", "mamba_scan_bwd"}
    if not torch.cuda.is_available():
        raise SystemExit("bwd_timings: no CUDA device is visible")
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as scan

    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    _build.build(["flash_attention", "flash_attention_bwd", "mamba_scan",
                  "mamba_scan_bwd"])
    for row, (*shape, causal, with_lse) in (
            FA_FWD_TIMED.items() if "flash_attention" in wanted else ()):
        q, k, v = (t.to(torch.bfloat16)
                   for t in _qkv(tuple(shape), device, SEED + 29))
        fwd = fa.flash_attention_fwd if with_lse else fa.flash_attention

        def fwd_call():
            fwd(q, k, v, causal=causal)

        ms = graph_time_ms(fwd_call, 20)
        split = {key[:32]: us for key, us in device_split_us(
            fwd_call).items()}
        print(json.dumps(dict(kind="time", kernel="flash_attention",
                              label=args.label, card=smi, row=row,
                              shape=shape + [causal, with_lse], ms=ms,
                              kernels_us=split)), flush=True)
        del q, k, v
    bwd_rows = [(row, FA_BWD_SHAPES[row], SEED + 24) for row in FA_BWD_TIMED]
    bwd_rows.append(("train_4k", FA_TRAIN_4K, SEED + 28))
    for row, shape, seed in (bwd_rows if "flash_attention_bwd" in wanted
                             else ()):
        causal = shape[6]
        q, k, v, do = _bwd_case(shape, torch.bfloat16, device, seed)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)

        def call():
            fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal)

        ms = graph_time_ms(call, 10)
        split = {key[:24]: us for key, us in device_split_us(call).items()}
        print(json.dumps(dict(kind="time", kernel="flash_attention_bwd",
                              label=args.label, card=smi, row=row,
                              shape=list(shape), ms=ms, kernels_us=split)),
              flush=True)
        del q, k, v, do, out, lse
    for shape in SCAN_BWD_TIMED if "mamba_scan_bwd" in wanted else ():
        b, s, di, _ = shape
        inputs = _scan_args(shape, device, SEED + 26)
        _, _, states = scan.mamba_scan_fwd(*inputs)
        dy = torch.randn((b, s, di), device=device)

        def scan_call():
            scan.mamba_scan_bwd(*inputs[:6], states, dy, None,
                                need_dh0=False)

        t_ms = graph_time_ms(scan_call, 10)
        split = {key[:32]: us for key, us in device_split_us(
            scan_call).items()}
        print(json.dumps(dict(kind="time", kernel="mamba_scan_bwd",
                              label=args.label, card=smi, row=str(shape),
                              shape=list(shape), ms=t_ms, kernels_us=split)),
              flush=True)
        del inputs, states, dy
    return 0


if __name__ == "__main__":
    sys.exit(main())
