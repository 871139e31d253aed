#!/usr/bin/env python3
"""Do the port's trained policies land in the reference's spread?

    python3 scripts/trained_spread.py --side reference [--draws 4] [--json P]
    python3 scripts/trained_spread.py --side port [--draws 4] [--json P]

Tables 8-10 (kube, SDQN, SDQN-n on the paper cluster, 5 trials of 50
pods) at a cut budget — the SDQN and SDQN-n presets cut to 20 episodes, 2
candidate seeds each, the best on 12 validation bursts, as
``chip_smoke.py`` phase 16 runs them — repeated over ``--draws``
independent draws of the training randomness:

* ``--side reference`` trains with the JAX package
  (``repro.train.engine.train_and_select``) from ``PRNGKey(d)`` (SDQN)
  and ``PRNGKey(1000 + d)`` (SDQN-n) for draw ``d``, and evaluates on its
  own trial keys (``fixed_trial_keys(100, 5)``);
* ``--side port`` trains with ``repro_torch`` through
  ``scripts/paper_tables.py``'s ``train_policy`` from ``TorchDraws``
  generators seeded ``d`` and ``1000 + d``, and evaluates on its own
  trials (``paper_tables.evaluate``), on the CPU.

Each side imports only its own package, and runs on the CPU.  Prints,
per scheduler, each draw's mean metric, the mean over draws and their
spread (min, max, standard deviation), and writes them to ``--json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

EPISODES, SEEDS, TRIALS, VAL_TRIALS = 20, 2, 5, 12
NAMES = ("default", "sdqn", "sdqn_n")
SEED_BASE = {"sdqn": 0, "sdqn_n": 1000}


def reference_draw(d: int) -> dict:
    """One draw of the reference: {scheduler: mean metric over trials}."""
    import jax

    from repro.core import presets, schedulers
    from repro.core.types import paper_cluster, training_cluster
    from repro.eval import engine as eval_engine
    from repro.train import engine as train_engine

    cfg, tcfg = paper_cluster(), training_cluster()
    keys = eval_engine.fixed_trial_keys(100, TRIALS)
    selectors = {"default": schedulers.make_kube_selector(cfg)}
    for name, preset in (("sdqn", presets.SDQN_PRESET),
                         ("sdqn_n", presets.SDQN_N_PRESET)):
        rl = dataclasses.replace(preset, episodes=EPISODES)
        params, _ = train_engine.train_and_select(
            jax.random.PRNGKey(SEED_BASE[name] + d), tcfg, cfg, rl,
            n_seeds=SEEDS, val_trials=VAL_TRIALS)
        selectors[name] = schedulers.make_sdqn_selector(params, cfg)
    return {name: float(np.mean(np.asarray(
        eval_engine.make_batch_episode(cfg, select, 50)(keys).metric)))
        for name, select in selectors.items()}


def port_draw(d: int) -> dict:
    """One draw of the port on the CPU: {scheduler: mean metric}."""
    spec = importlib.util.spec_from_file_location(
        "paper_tables", ROOT / "scripts" / "paper_tables.py")
    pt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pt)
    from repro_torch.core import schedulers

    selectors = {"default": schedulers.make_kube_selector(pt.CFG)}
    for name in ("sdqn", "sdqn_n"):
        tr = pt.train_policy(name, EPISODES, SEEDS, "cpu",
                             seed=SEED_BASE[name] + d)
        selectors[name] = schedulers.make_sdqn_selector(tr["params"], pt.CFG)
    return {name: float(pt.evaluate(select, TRIALS, "cpu").metric.mean())
            for name, select in selectors.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--side", choices=("reference", "port"), required=True)
    ap.add_argument("--draws", type=int, default=4)
    ap.add_argument("--json", default=None, help="write the numbers here")
    args = ap.parse_args(argv)
    run = reference_draw if args.side == "reference" else port_draw
    per_draw = []
    t0 = time.perf_counter()
    for d in range(args.draws):
        per_draw.append(run(d))
        print(f"{args.side} draw {d}: "
              + " ".join(f"{k}={v}" for k, v in per_draw[-1].items()),
              flush=True)
    out = {"side": args.side, "draws": args.draws, "episodes": EPISODES,
           "seeds": SEEDS, "trials": TRIALS,
           "seconds": time.perf_counter() - t0, "per_draw": per_draw,
           "summary": {}}
    for name in NAMES:
        vals = np.asarray([p[name] for p in per_draw])
        rel = None
        if name != "default":
            rel = [100.0 * (p[name] / p["default"] - 1.0) for p in per_draw]
        out["summary"][name] = {
            "mean": float(vals.mean()), "min": float(vals.min()),
            "max": float(vals.max()), "std": float(vals.std()),
            "rel_to_default_pct": rel}
        print(f"{args.side} {name}: mean={vals.mean()} min={vals.min()} "
              f"max={vals.max()} std={vals.std()}"
              + ("" if rel is None else f" rel_to_default_pct={rel}"))
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
