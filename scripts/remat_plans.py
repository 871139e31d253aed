"""Plan the memory of ``chip_smoke.py`` phase 22's training steps under
each ``remat``, on fake tensors on the CPU (``launch.dryrun``): no card.

    PYTHONPATH=src python3 scripts/remat_plans.py [--backward]

For OLMo-1B (16 layers) and falcon-mamba-7b (8 layers) at 8 x 512 tokens,
one microbatch, under "none", "dots" and "full": the whole step's planned
peak (``hbm_bytes_per_chip``: arguments + temp + output - alias) and the
backward's own peak, ``value_and_grad``'s live bytes above its arguments
(``LiveBytes``), each printed as one JSON line; with ``--backward`` the
backward's alone (``chip_smoke.py`` phase 22 runs it so, beside the
card's work, and holds the card's reading to it).  The card's
counterparts are phase 22's ``peak_memory_gb`` and ``value_and_grad``'s
own peak.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "src"))

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs.base import SHAPES, ShapeConfig, get_config  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402

SHAPE = "phase22_train"                 # 8 x 512 tokens, one microbatch
MODELS = (("olmo-1b", 0), ("falcon-mamba-7b", 8))


def backward_peak(arch: str, cfg) -> int:
    """``value_and_grad``'s live bytes above its arguments, traced."""
    mode = FakeTensorMode()
    with mode:
        cell = dryrun.build_cell(arch, SHAPE, micro=1, cfg=cfg, mode=mode)
        live = dryrun.LiveBytes(dryrun._leaves(cell.args))
        with dryrun.CardStandIn(), live:
            steps.value_and_grad(cfg, cell.parts["params"],
                                 cell.parts["batch"])
    return live.peak


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backward", action="store_true",
                    help="plan the backward's own peak only")
    args = ap.parse_args()
    SHAPES[SHAPE] = ShapeConfig(SHAPE, 512, 8, "train")
    for arch, layers in MODELS:
        base = get_config(arch)
        if layers:
            base = dataclasses.replace(base, num_layers=layers)
        for remat in ("none", "dots", "full"):
            cfg = dataclasses.replace(base, remat=remat)
            row = {"arch": arch, "layers": cfg.num_layers, "remat": remat,
                   "backward_peak_bytes": backward_peak(arch, cfg)}
            if not args.backward:
                mem = dryrun.plan_cell(arch, SHAPE, micro=1, cfg=cfg,
                                       limit=dryrun.HBM_80G)["memory"]
                row.update(step_peak_bytes=(
                    mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                    + mem["output_size_in_bytes"]
                    - mem["alias_size_in_bytes"]), launches=mem["launches"])
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
