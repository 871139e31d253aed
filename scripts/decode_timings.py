"""Time kernel 8 (decode attention) on one CUDA card at the LM paths'
shapes, for this checkout's package or another's.

    python3 scripts/decode_timings.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so that one run on a card can time another checkout's
kernel beside this one's, in turns (``chip_smoke.py --parent-src DIR``
runs it so).  Every row of ``chip_smoke.DECODE_TIMED`` (B, Hq, Hkv, S, D,
kv_len, cache dtype) on the model's (B, S, Hkv, D) cache seen through
``permute``, bfloat16 q, inputs from ``chip_smoke._decode_case``: device
time per call from a CUDA graph of many calls (median of 5 replays;
``chip_smoke.graph_time_ms``), warm (the graph replays one cache, which
the L2 holds below ~50 MB) and cold (``chip_smoke.cold_time_ms``: 128 MB
written before every call, as a model step's weights pass through the
L2 between two attention layers).  A row whose cache dtype the package
refuses (a float8 cache before it was ported) prints ``ms: null`` and the
error.  Prints one JSON object a line, the card's name and power limit in
each.
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
from chip_smoke import (DECODE_TIMED, SEED, _decode_case,  # noqa: E402
                        cold_time_ms, graph_time_ms)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_timings: no CUDA device is visible")
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da

    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    _build.build(["decode_attention"])
    for row, (shape, n, cache, iters) in DECODE_TIMED.items():
        q, k, v = _decode_case(shape, torch.bfloat16, device, SEED + 21,
                               cache_layout=True)
        k, v = k.to(getattr(torch, cache)), v.to(getattr(torch, cache))
        out = dict(kind="time", label=args.label, card=smi, row=row,
                   shape=list(shape), kv_len=n, cache=cache, ms=None,
                   cold_ms=None)
        try:
            da.decode_attention(q, k, v, n)
        except ValueError as e:
            out["error"] = str(e)
        else:
            def call():
                da.decode_attention(q, k, v, n)

            out["ms"] = graph_time_ms(call, iters)
            out["cold_ms"] = cold_time_ms(call, iters)
        print(json.dumps(out), flush=True)
        del q, k, v
    return 0


if __name__ == "__main__":
    sys.exit(main())
