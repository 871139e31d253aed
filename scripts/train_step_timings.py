"""Time phase 22's OLMo-1B training steps on one CUDA card, for this
checkout's package or another's.

    python3 scripts/train_step_timings.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is trained
(default: this checkout's), so that one run on a card can time two
checkouts in turns, each in a process of its own (parent, this, this,
parent).  The run is ``chip_smoke.py`` phase 22's: ``launch.train.main``
with ``chip_smoke.TRAIN_ARGS`` (OLMo-1B at full width and depth, 40 steps
of 8 x 512 synthetic tokens, ``default_adam``), every step synchronized
and timed, steps ``chip_smoke.TRAIN_PROFILED`` under torch.profiler
(``chip_smoke._train_main``), no checkpoint.  Prints one JSON object: the
median ms of steps ``chip_smoke.TRAIN_MEDIAN_FROM``-39 as phase 22 reports
it, every step's ms, the peak memory and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import (TRAIN_ARGS, TRAIN_MEDIAN_FROM,  # noqa: E402
                        _train_main)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_step_timings: no CUDA device is visible")
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch

    assert pathlib.Path(repro_torch.__file__).resolve().parent.parent == src
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    losses, counts, times, _, wall, peak = _train_main(TRAIN_ARGS)
    ms = [1e3 * t for t in times]
    print(json.dumps({
        "label": args.label, "src": str(src), "device": smi,
        "ms_per_step": statistics.median(ms[TRAIN_MEDIAN_FROM:]),
        "spread_ms": [min(ms[TRAIN_MEDIAN_FROM:]),
                      max(ms[TRAIN_MEDIAN_FROM:])],
        "step_ms": ms, "peak_gb": peak / 1e9, "wall_s": wall,
        "launches": counts, "last_loss": losses[-1]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
