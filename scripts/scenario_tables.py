#!/usr/bin/env python3
"""The scenario sweep, the lifecycle rows and the green Pareto rows on the
PyTorch/CUDA port.

    python3 scripts/scenario_tables.py [--episodes N] [--trials T]
                                       [--pods P] [--device cpu] [--json PATH]

The protocol of the reference's ``benchmarks/scenario_bench.sweep`` and
``benchmarks/lifecycle_bench`` (``rows``, ``pareto_rows``):

* **Scenario sweep.**  One SDQN trained across the scenario mixture
  (``presets.SCENARIO_MIX_NAMES``, ``SDQN_SCENARIO_MIX_PRESET``, generator
  seed 42) against the default kube-scheduler on every registered
  scenario except the scoring-only cluster-of-clusters family: the
  average CPU per node, its spread, pods placed and dropped.  On the
  scenarios whose nodes fail mid-episode (``preemptible-flaky``,
  ``batch-flaky``, ``train-flaky``) each trial samples a failure trace,
  and the rows add the pods evicted, rescheduled and lost.
* **Lifecycle rows.**  The four churn scenarios
  (``presets.LIFECYCLE_MIX_NAMES``) under kube, an SDQN trained across
  them (``SDQN_LIFECYCLE_PRESET``, seed 42) and SDQN-n
  (``SDQN_N_LIFECYCLE_PRESET``, seed 43) with the in-episode consolidation
  pass every 30 s: time-averaged active nodes, energy billed to the
  workload, the average CPU, pods retired and pods the pass moved.
* **Green Pareto rows.**  On each churn scenario, kube, TOPSIS
  (``sched.topsis``) and one SDQN-n with the pass per ``energy_weight``
  of ``PARETO_ENERGY_WEIGHTS`` (each trained as the lifecycle SDQN-n with
  that weight, seed 43; 15.0 is the lifecycle SDQN-n itself): the average
  CPU, the energy and the drops of each, and how many SDQN-n points are
  no worse than TOPSIS on all three axes (``dominates_or_matches``, 2%
  slack).

Training takes the reference benches' default of 120 episodes a policy
(of 50 pods, 16 envs); trials are 3, drawn from a generator seeded 100,
each scenario's own arrivals.  ``--episodes``, ``--trials`` and
``--pods`` (arrivals per trial and per training episode) cut the budget;
every cut is printed.  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import scenarios  # noqa: E402
from repro_torch.core import env as kenv, presets, schedulers  # noqa: E402
from repro_torch.core import train_rl  # noqa: E402
from repro_torch.core.draws import TorchDraws  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.eval import engine as eval_engine  # noqa: E402
from repro_torch.sched import elastic, topsis  # noqa: E402

EPISODES = 120              # benchmarks/scenario_bench.py, lifecycle_bench.py
TRIALS = 3
TRIAL_SEED = 100
CONSOLIDATE_EVERY_S = 30.0  # benchmarks/lifecycle_bench.py
TRAIN_SEEDS = {"mixture": 42, "lifecycle_sdqn": 42, "lifecycle_sdqnn": 43}
POLICIES = ("kube", "sdqn", "sdqnn")
# benchmarks/lifecycle_bench.py: 0 through 2x the lifecycle preset's 15.0
PARETO_ENERGY_WEIGHTS = (0.0, 7.5, 15.0, 30.0)


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def train(name: str, cfg_names, preset, episodes, pods, device,
          seed=None) -> dict:
    """One Q-net across ``cfg_names`` (``train_rl.train_mixture``)."""
    rl = dataclasses.replace(preset, episodes=episodes, **(
        {} if pods is None else {"pods_per_episode": pods}))
    gen = torch.Generator(device=device).manual_seed(
        TRAIN_SEEDS[name] if seed is None else seed)
    t0 = time.perf_counter()
    params, metrics = train_rl.train_mixture(
        TorchDraws(gen, (rl.n_envs,)), scenarios.training_mixture(cfg_names),
        rl, device=device)
    _synchronize(device)
    secs = time.perf_counter() - t0
    steps = int(metrics["loss"].shape[0]) * rl.pods_per_episode
    print(f"trained {name}: {int(metrics['loss'].shape[0])} episodes x "
          f"{rl.pods_per_episode} pods x {rl.n_envs} envs across "
          f"{len(cfg_names)} scenarios in {secs:.1f} s "
          f"({1e3 * secs / steps:.3f} ms a pod step)")
    return {"params": params, "seconds": secs,
            "episodes": int(metrics["loss"].shape[0]),
            "ms_per_pod_step": 1e3 * secs / steps}


def evaluate(cfg, select, trials, pods, device, consolidate=None) -> dict:
    """Every trial as one batch: the summary, and its wall time."""
    draws = TorchDraws(torch.Generator(device=device).manual_seed(TRIAL_SEED),
                       (trials,))
    t0 = time.perf_counter()
    res = eval_engine.make_batch_episode(cfg, select, pods, consolidate,
                                         device=device)(draws)
    out = eval_engine.summarize(res)
    _synchronize(device)
    out["seconds"] = time.perf_counter() - t0
    return out


def sweep(params, names, trials, pods, device) -> dict:
    """kube and the mixture-trained SDQN on each scenario of ``names``."""
    print("\n--- scenario sweep (avg CPU %, lower = better) ---")
    rows = {}
    for name in names:
        cfg = scenarios.make_env(name)
        rows[name] = {}
        for policy, select in (
                ("kube", schedulers.make_kube_selector(cfg)),
                ("sdqn", schedulers.make_sdqn_selector(params, cfg))):
            r = evaluate(cfg, select, trials, pods, device)
            rows[name][policy] = r
            chaos = (f" evicted={r['evicted_mean']:.2f} rescheduled="
                     f"{r['rescheduled_mean']:.2f} lost={r['lost_mean']:.2f}"
                     if kenv.has_chaos(cfg) else "")
            print(f"  {name:22s} {policy:5s} avg_cpu={r['metric_mean']:6.2f}%"
                  f" (+-{r['metric_std']:.2f}) placed="
                  f"{r['pods_placed_mean']:.0f} dropped={r['dropped_mean']:.1f}"
                  f"{chaos} nodes={cfg.n_nodes} wall={r['seconds']:.2f}s")
    return rows


def lifecycle(qp, qpn, names, trials, pods, device) -> dict:
    """The churn scenarios under kube, SDQN and SDQN-n with the pass."""
    print("\n--- lifecycle sweep (time-averaged active nodes, lower = "
          "greener) ---")
    rows = {}
    for name in names:
        base = scenarios.make_env(name)
        rows[name] = {}
        for policy in POLICIES:
            cfg, consolidate = base, None
            if policy == "kube":
                select = schedulers.make_kube_selector(cfg)
            elif policy == "sdqn":
                select = schedulers.make_sdqn_selector(qp, cfg)
            else:
                cfg = dataclasses.replace(
                    base, consolidate_every_s=CONSOLIDATE_EVERY_S)
                select = schedulers.make_sdqn_selector(qpn, cfg)
                consolidate = elastic.make_consolidator(qpn, cfg)
            r = evaluate(cfg, select, trials, pods, device, consolidate)
            rows[name][policy] = r
            print(f"  {name:22s} {policy:5s} "
                  f"nodes_active={r['nodes_active_mean']:5.2f} "
                  f"energy={r['energy_wh_mean']:7.2f}Wh "
                  f"avg_cpu={r['metric_mean']:6.2f}% "
                  f"retired={r['retired_mean']:.0f} "
                  f"dropped={r['dropped_mean']:.1f} "
                  f"moved={r['moved_mean']:.1f}")
        k = rows[name]["kube"]["nodes_active_mean"]
        print(f"  {name:22s} sdqnn/kube active nodes "
              f"{rows[name]['sdqnn']['nodes_active_mean'] / k:.3f}")
    return rows


def dominates_or_matches(a: dict, b: dict, tol: float = 0.02) -> bool:
    """Point ``a`` is no worse than ``b`` on all three Pareto axes
    (average CPU, energy, drops), with ``tol`` relative slack and half a
    pod of absolute slack on drops (``benchmarks/lifecycle_bench.py``)."""
    return (a["metric_mean"] <= b["metric_mean"] * (1 + tol)
            and a["energy_wh_mean"] <= b["energy_wh_mean"] * (1 + tol)
            and a["dropped_mean"] <= b["dropped_mean"] * (1 + tol) + 0.5)


def _wtag(w: float) -> str:
    return f"w{w:g}".replace(".", "p")


def pareto(qpn_by_weight: dict, names, trials, pods, device) -> dict:
    """kube, TOPSIS and the SDQN-n of each energy weight (with the pass)
    on each churn scenario: the frontier points and the dominance count."""
    print("\n--- green Pareto frontier (avg-CPU% / energy Wh / drops) ---")
    rows = {}
    for name in names:
        base = scenarios.make_env(name)
        points = {
            "kube": evaluate(base, schedulers.make_kube_selector(base),
                             trials, pods, device),
            "topsis": evaluate(base, topsis.make_topsis_selector(base),
                               trials, pods, device)}
        cfg = dataclasses.replace(base,
                                  consolidate_every_s=CONSOLIDATE_EVERY_S)
        for w, qpn in qpn_by_weight.items():
            points[f"sdqnn_{_wtag(w)}"] = evaluate(
                cfg, schedulers.make_sdqn_selector(qpn, cfg), trials, pods,
                device, elastic.make_consolidator(qpn, cfg))
        for arm, r in points.items():
            print(f"  {name:22s} {arm:12s} cpu={r['metric_mean']:6.2f}% "
                  f"energy={r['energy_wh_mean']:7.2f}Wh "
                  f"dropped={r['dropped_mean']:.1f}")
        dom = sum(1 for arm, r in points.items() if arm.startswith("sdqnn_")
                  and dominates_or_matches(r, points["topsis"]))
        print(f"  {name:22s} sdqnn dominates/matches topsis on {dom} of "
              f"{len(qpn_by_weight)} frontier points")
        rows[name] = dict(points, sdqnn_dominates=dom)
    return rows


def run(episodes=None, trials=None, pods=None, device=None, names=None,
        lifecycle_names=None,
        pareto_weights=PARETO_ENERGY_WEIGHTS) -> dict:
    """Train the policies, run the sweep, the lifecycle rows and the
    Pareto rows; returns every number (the params under ``"params"``)."""
    device = resolve_device(device)
    cuts = {k: v for k, v in (("episodes", episodes), ("trials", trials),
                              ("pods", pods)) if v is not None}
    episodes = EPISODES if episodes is None else episodes
    trials = TRIALS if trials is None else trials
    print(f"scenario tables on {device}: "
          + (f"CUT budget {cuts} (full: {EPISODES} training episodes, "
             f"{TRIALS} trials, each scenario's own arrivals)" if cuts
             else "full budget"))
    if names is None:
        names = tuple(n for n in scenarios.scenario_names()
                      if n not in scenarios.SCORING_ONLY)
    if lifecycle_names is None:
        lifecycle_names = presets.LIFECYCLE_MIX_NAMES
    out = {"cuts": cuts, "device": str(device), "train": {}, "params": {}}
    for name, mix, preset in (
            ("mixture", presets.SCENARIO_MIX_NAMES,
             presets.SDQN_SCENARIO_MIX_PRESET),
            ("lifecycle_sdqn", presets.LIFECYCLE_MIX_NAMES,
             presets.SDQN_LIFECYCLE_PRESET),
            ("lifecycle_sdqnn", presets.LIFECYCLE_MIX_NAMES,
             presets.SDQN_N_LIFECYCLE_PRESET)):
        tr = train(name, mix, preset, episodes, pods, device)
        out["params"][name] = tr.pop("params")
        out["train"][name] = tr
    out["scenarios"] = sweep(out["params"]["mixture"], names, trials, pods,
                             device)
    out["lifecycle"] = lifecycle(out["params"]["lifecycle_sdqn"],
                                 out["params"]["lifecycle_sdqnn"],
                                 lifecycle_names, trials, pods, device)
    qpn_by_weight = {}
    for w in pareto_weights:
        if w == presets.SDQN_N_LIFECYCLE_PRESET.energy_weight:
            qpn_by_weight[w] = out["params"]["lifecycle_sdqnn"]
            continue
        name = f"pareto_sdqnn_{_wtag(w)}"
        tr = train(name, presets.LIFECYCLE_MIX_NAMES, dataclasses.replace(
            presets.SDQN_N_LIFECYCLE_PRESET, energy_weight=float(w)),
            episodes, pods, device, seed=TRAIN_SEEDS["lifecycle_sdqnn"])
        qpn_by_weight[w] = out["params"][name] = tr.pop("params")
        out["train"][name] = tr
    out["pareto"] = pareto(qpn_by_weight, lifecycle_names, trials, pods,
                           device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--episodes", type=int, default=None,
                    help=f"training episodes a policy (default {EPISODES})")
    ap.add_argument("--trials", type=int, default=None,
                    help=f"trials a cell (default {TRIALS})")
    ap.add_argument("--pods", type=int, default=None,
                    help="arrivals a trial and a training episode (default: "
                         "each scenario's, 50 in training)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run there (default: the CUDA card)")
    ap.add_argument("--json", default=None, help="write the numbers here")
    args = ap.parse_args(argv)
    if args.device is None:
        torch.backends.cuda.matmul.allow_tf32 = False
    out = run(args.episodes, args.trials, args.pods, args.device)
    out.pop("params")
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
