#!/usr/bin/env python3
"""Tables 8–10 of the paper on the PyTorch/CUDA port.

    python3 scripts/paper_tables.py [--episodes N] [--seeds S] [--trials T]
                                    [--device cpu] [--json PATH]

The protocol of the reference's ``benchmarks/paper_tables.py`` (paper §5):
50 compute-intensive no-op pods a trial on the 4-slave paper cluster, 5
trials, the metric the cluster-wide average CPU utilization per node.
SDQN and SDQN-n train from scratch with the canonical presets
(``core.presets``) through ``train.engine.train_and_select`` on the
domain-randomized training cluster, ``N_SELECTION_SEEDS`` candidates each,
the best kept on validation bursts; then the default kube-scheduler, SDQN
and SDQN-n are evaluated on the same trials.  Per-trial experiment-pod
distributions and metrics are printed beside the paper's numbers and the
reference's calibration.

Every draw comes from ``torch.Generator``s on the device
(``core.draws.TorchDraws``): training from seeds 0 (SDQN) and 1 (SDQN-n),
validation from 5000, the trials from 100.  torch cannot reproduce the
reference's threefry streams, so the trials are the protocol's, not the
reference's very episodes.  ``--episodes``, ``--seeds`` and ``--trials``
cut the budget; every cut is printed.  Runs on the card unless ``--device
cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import presets, schedulers  # noqa: E402
from repro_torch.core.draws import TorchDraws  # noqa: E402
from repro_torch.core.types import paper_cluster, training_cluster  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.eval import engine as eval_engine  # noqa: E402
from repro_torch.train import engine as train_engine  # noqa: E402

CFG = paper_cluster()
TCFG = training_cluster()
N_PODS = 50
TRIALS = 5
TRIAL_SEED = 100
TRAIN_SEEDS = {"sdqn": 0, "sdqn_n": 1}

# the paper's Tables 8-10 means (benchmarks/paper_tables.py:32)
PAPER = {"default": 30.87, "sdqn": 27.21, "sdqn_n": 22.35}
# the reference's calibration (repro/core/presets.py:4-8): default's mean,
# the learned schedulers' change relative to it
REFERENCE = {"default": 30.42, "sdqn_rel_pct": -9.2, "sdqn_n_rel_pct": -23.0}
LABELS = {"default": "Table 8: default kube-scheduler",
          "sdqn": "Table 9: SDQN scheduler",
          "sdqn_n": "Table 10: SDQN-n (n=2) scheduler"}
PRESETS = {"sdqn": presets.SDQN_PRESET, "sdqn_n": presets.SDQN_N_PRESET}


def preset(name: str, episodes=None):
    """The variant's preset, its episodes cut to ``episodes`` if given."""
    rl = PRESETS[name]
    return rl if episodes is None else dataclasses.replace(rl,
                                                           episodes=episodes)


def train_policy(name: str, episodes=None, seeds=None, device=None) -> dict:
    """Train and select one learned scheduler; returns its params, the
    validation metric and the wall time (seconds, synchronized)."""
    device = resolve_device(device)
    rl = preset(name, episodes)
    n_seeds = presets.N_SELECTION_SEEDS if seeds is None else seeds
    gen = torch.Generator(device=device).manual_seed(TRAIN_SEEDS[name])
    t0 = time.perf_counter()
    params, val = train_engine.train_and_select(
        TorchDraws(gen, (n_seeds, rl.n_envs)), TCFG, CFG, rl,
        n_seeds=n_seeds, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"params": params, "val_metric": val, "seconds": seconds,
            "episodes": rl.episodes, "seeds": n_seeds,
            "pod_steps": rl.episodes * rl.pods_per_episode}


def evaluate(select, trials: int = TRIALS, device=None):
    """Every trial of one scheduler as one batch: ``TrialResults``."""
    device = resolve_device(device)
    draws = TorchDraws(torch.Generator(device=device).manual_seed(TRIAL_SEED),
                       (trials,))
    return eval_engine.make_batch_episode(CFG, select, N_PODS,
                                          device=device)(draws)


def table(name: str, res) -> dict:
    """Print one table: each trial's experiment pods per slave and its
    metric, the mean and CV beside the paper's; returns the numbers."""
    rows = res.exp_pods.cpu().tolist()
    mets = [float(m) for m in res.metric.cpu()]
    mean = float(np.mean(mets))
    cv = float(np.std(mets) / mean * 100.0)
    print(f"\n--- {LABELS[name]}, {len(mets)} trials ---")
    print("trial | slave1 slave2 slave3 slave4 | avg CPU util")
    for i, (dist, m) in enumerate(zip(rows, mets)):
        print(f"  {i + 1}   | " + " ".join(f"{x:6d}" for x in dist)
              + f" | {m:6.2f}%")
    print(f"  mean={mean:.2f}%  CV={cv:.2f}%   (paper: {PAPER[name]:.2f}%)")
    return {"exp_pods": rows, "metric": mets, "mean": mean, "cv_pct": cv,
            "dropped": res.dropped.cpu().tolist()}


def run(episodes=None, seeds=None, trials: int = TRIALS, device=None) -> dict:
    """Train SDQN and SDQN-n, evaluate the three schedulers, print Tables
    8-10 and the comparison; returns every number, and the selected
    params under ``"params"``."""
    device = resolve_device(device)
    cuts = {k: v for k, v in (("episodes", episodes), ("seeds", seeds))
            if v is not None}
    if trials != TRIALS:
        cuts["trials"] = trials
    print(f"paper tables on {device}: "
          + (f"CUT budget {cuts} (full: presets' episodes, "
             f"{presets.N_SELECTION_SEEDS} seeds, {TRIALS} trials)" if cuts
             else "full budget"))
    out = {"cuts": cuts, "device": str(device), "train": {}, "tables": {}}
    policies = {}
    for name in ("sdqn", "sdqn_n"):
        tr = train_policy(name, episodes, seeds, device)
        policies[name] = tr.pop("params")
        tr["ms_per_pod_step"] = 1e3 * tr["seconds"] / tr["pod_steps"]
        out["train"][name] = tr
        print(f"trained {name}: {tr['seeds']} seeds x {tr['episodes']} "
              f"episodes in {tr['seconds']:.1f} s "
              f"({tr['ms_per_pod_step']:.3f} ms a pod step with validation), "
              f"validation metric {tr['val_metric']:.3f}")
    selectors = {"default": schedulers.make_kube_selector(CFG)}
    for name in ("sdqn", "sdqn_n"):
        selectors[name] = schedulers.make_sdqn_selector(policies[name], CFG)
    for name, select in selectors.items():
        out["tables"][name] = table(name, evaluate(select, trials, device))
    d = out["tables"]["default"]["mean"]
    print("\n--- comparison (avg CPU %, lower = better) ---")
    print(f"{'scheduler':10s} {'port':>8s} {'paper':>8s} {'rel-to-default':>15s}"
          f" {'reference rel':>14s}")
    ref_rel = {"default": 0.0, "sdqn": REFERENCE["sdqn_rel_pct"],
               "sdqn_n": REFERENCE["sdqn_n_rel_pct"]}
    for name in ("default", "sdqn", "sdqn_n"):
        m = out["tables"][name]["mean"]
        rel = 100.0 * (m / d - 1.0)
        out["tables"][name]["rel_to_default_pct"] = rel
        print(f"{name:10s} {m:7.2f}% {PAPER[name]:7.2f}% {rel:+14.1f}% "
              f"{ref_rel[name]:+13.1f}%")
    print(f"(reference calibration: default {REFERENCE['default']:.2f}%)")
    out["params"] = policies
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--episodes", type=int, default=None,
                    help="training episodes per variant (default: presets')")
    ap.add_argument("--seeds", type=int, default=None,
                    help=f"candidates per variant (default "
                         f"{presets.N_SELECTION_SEEDS})")
    ap.add_argument("--trials", type=int, default=TRIALS)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run there (default: the CUDA card)")
    ap.add_argument("--json", default=None, help="write the numbers here")
    args = ap.parse_args(argv)
    if args.device is None:
        torch.backends.cuda.matmul.allow_tf32 = False
    out = run(args.episodes, args.seeds, args.trials, args.device)
    out.pop("params")
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
