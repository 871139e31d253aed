#!/usr/bin/env python3
"""Tables 8–12 and Figure 6 of the paper on the PyTorch/CUDA port.

    python3 scripts/paper_tables.py [--episodes N] [--seeds S] [--trials T]
                                    [--pods P] [--device cpu] [--json PATH]

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
reference's very episodes.

Then the paper's baselines (``run_baselines``): the LSTM and Transformer
scorers (Tables 6/7) trained by regression onto Table-3 rewards along
kube-scheduler trajectories, ``N_SUPERVISED_SEEDS`` each for
``SUPERVISED_EPISODES`` episodes (generators seeded 70 + s and 90 + s),
the best on the validation bursts kept (Tables 11/12); Figure 6's three
claims; the literal Table-4 ablation (bandit targets, unshaped rewards,
3 seeds, seed 7); and the policy-class table (kube and the registry's
"mlp", "attention" and "mamba" classes trained through the same learner
for 40 episodes, 2 seeds each, seeds 1100 + i), as the reference's
``benchmarks/paper_tables.py`` does.

``--episodes``, ``--seeds``, ``--trials`` and ``--pods`` (pods per training
episode) cut the budget of every learned scheduler; every cut is printed.
Runs on the card unless ``--device cpu``.
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

from repro_torch.core import baselines, policy, presets, schedulers  # noqa: E402
from repro_torch.core import train_rl  # noqa: E402
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

# the paper's Tables 8-12 means (benchmarks/paper_tables.py:32)
PAPER = {"default": 30.87, "sdqn": 27.21, "sdqn_n": 22.35,
         "lstm": 30.53, "transformer": 30.15}
# the reference's calibration (repro/core/presets.py:4-8): default's mean,
# the learned schedulers' change relative to it
REFERENCE = {"default": 30.42, "sdqn_rel_pct": -9.2, "sdqn_n_rel_pct": -23.0}
LABELS = {"default": "Table 8: default kube-scheduler",
          "sdqn": "Table 9: SDQN scheduler",
          "sdqn_n": "Table 10: SDQN-n (n=2) scheduler",
          "lstm": "Table 11: LSTM-based scheduler",
          "transformer": "Table 12: Transformer-based scheduler"}
PRESETS = {"sdqn": presets.SDQN_PRESET, "sdqn_n": presets.SDQN_N_PRESET,
           "sdqn_literal": presets.SDQN_LITERAL_PRESET}
SCORERS = {"lstm": (baselines.init_lstm, baselines.lstm_score, 70),
           "transformer": (baselines.init_transformer,
                           baselines.transformer_score, 90)}
VALIDATION_SEED = 5000      # the reference's PRNGKey(5000 + t) bursts
VALIDATION_TRIALS = 6
LITERAL_SEEDS, LITERAL_SEED = 3, 7
POLICY_EPISODES, POLICY_SEEDS, POLICY_SEED = 40, 2, 1100


def preset(name: str, episodes=None, pods=None):
    """The variant's preset, its episodes and pods per training episode
    cut to ``episodes`` / ``pods`` if given."""
    rl = PRESETS[name]
    cut = {k: v for k, v in (("episodes", episodes),
                             ("pods_per_episode", pods)) if v is not None}
    return dataclasses.replace(rl, **cut)


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def train_policy(name: str, episodes=None, seeds=None, device=None,
                 pods=None, rl=None, seed=None) -> dict:
    """Train and select one learned scheduler (``name``'s preset, or
    ``rl``); returns its params, the validation metric and the wall time
    (seconds, synchronized)."""
    device = resolve_device(device)
    rl = preset(name, episodes, pods) if rl is None else rl
    n_seeds = presets.N_SELECTION_SEEDS if seeds is None else seeds
    gen = torch.Generator(device=device).manual_seed(
        TRAIN_SEEDS[name] if seed is None else seed)
    t0 = time.perf_counter()
    params, val = train_engine.train_and_select(
        TorchDraws(gen, (n_seeds, rl.n_envs)), TCFG, CFG, rl,
        n_seeds=n_seeds, device=device)
    _synchronize(device)
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


def _stats(res) -> tuple:
    mets = [float(m) for m in res.metric.cpu()]
    mean = float(np.mean(mets))
    return mets, mean, float(np.std(mets) / mean * 100.0)


def table(name: str, res) -> dict:
    """Print one table: each trial's experiment pods per slave and its
    metric, the mean and CV beside the paper's; returns the numbers."""
    rows = res.exp_pods.cpu().tolist()
    mets, mean, cv = _stats(res)
    print(f"\n--- {LABELS[name]}, {len(mets)} trials ---")
    print("trial | slave1 slave2 slave3 slave4 | avg CPU util")
    for i, (dist, m) in enumerate(zip(rows, mets)):
        print(f"  {i + 1}   | " + " ".join(f"{x:6d}" for x in dist)
              + f" | {m:6.2f}%")
    print(f"  mean={mean:.2f}%  CV={cv:.2f}%   (paper: {PAPER[name]:.2f}%)")
    return {"exp_pods": rows, "metric": mets, "mean": mean, "cv_pct": cv,
            "dropped": res.dropped.cpu().tolist()}


def _cuts(episodes, seeds, trials, pods) -> dict:
    cuts = {k: v for k, v in (("episodes", episodes), ("seeds", seeds),
                              ("pods", pods)) if v is not None}
    if trials != TRIALS:
        cuts["trials"] = trials
    return cuts


def run(episodes=None, seeds=None, trials: int = TRIALS, device=None,
        pods=None) -> dict:
    """Train SDQN and SDQN-n, evaluate the three schedulers, print Tables
    8-10 and the comparison; returns every number, and the selected
    params under ``"params"``."""
    device = resolve_device(device)
    cuts = _cuts(episodes, seeds, trials, pods)
    print(f"paper tables on {device}: "
          + (f"CUT budget {cuts} (full: presets' episodes, "
             f"{presets.N_SELECTION_SEEDS} seeds, {TRIALS} trials)" if cuts
             else "full budget"))
    out = {"cuts": cuts, "device": str(device), "train": {}, "tables": {}}
    policies = {}
    for name in ("sdqn", "sdqn_n"):
        tr = train_policy(name, episodes, seeds, device, pods)
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


def train_scorer(name: str, episodes=None, seeds=None, device=None,
                 pods=None) -> dict:
    """Train ``N_SUPERVISED_SEEDS`` LSTM or Transformer scorers one after
    another (``train_rl.train_supervised_scorer``, generator ``salt + s``)
    and keep the best on the validation bursts (every candidate on the
    same ones); returns its params, the validation metric and the wall
    time."""
    device = resolve_device(device)
    init_fn, score_fn, salt = SCORERS[name]
    n_seeds = presets.N_SUPERVISED_SEEDS if seeds is None else seeds
    n_eps = presets.SUPERVISED_EPISODES if episodes is None else episodes
    kw = {} if pods is None else {"pods_per_episode": pods}
    best, best_m = None, float("inf")
    t0 = time.perf_counter()
    for s in range(n_seeds):
        gen = torch.Generator(device=device).manual_seed(salt + s)
        params = train_rl.train_supervised_scorer(
            TorchDraws(gen, (8,)), TCFG, init_fn, score_fn, episodes=n_eps,
            device=device, **kw)
        val = TorchDraws(torch.Generator(device=device).manual_seed(
            VALIDATION_SEED), (VALIDATION_TRIALS,))
        res = eval_engine.make_batch_episode(
            CFG, schedulers.make_neural_selector(params, score_fn, CFG),
            N_PODS, device=device)(val)
        m = float(res.metric.mean())
        if m < best_m:
            best, best_m = params, m
    _synchronize(device)
    return {"params": best, "val_metric": best_m,
            "seconds": time.perf_counter() - t0, "episodes": n_eps,
            "seeds": n_seeds}


def figure6(tables: dict) -> dict:
    """Figure 6: every scheduler's mean beside the paper's, relative to the
    default, and the paper's three claims (not asserted)."""
    means = {k: tables[k]["mean"] for k in ("default", "sdqn", "sdqn_n",
                                            "lstm", "transformer")}
    d = means["default"]
    print("\n--- Figure 6: comparison of schedulers (avg CPU %, lower=better) "
          "---")
    print(f"{'scheduler':14s} {'port':>8s} {'paper':>8s} {'rel-to-default':>15s}")
    for name, m in means.items():
        print(f"{name:14s} {m:7.2f}% {PAPER[name]:7.2f}% "
              f"{100.0 * (m / d - 1.0):+14.1f}%")
    claims = {
        "claim1_sdqn_reduces_~10pct": means["sdqn"] / d - 1.0 <= -0.05,
        "claim2_sdqn_n_exceeds_20pct": means["sdqn_n"] / d - 1.0 <= -0.20,
        "claim3_lstm_tr_no_advantage": (
            means["lstm"] >= means["sdqn"]
            and means["transformer"] >= means["sdqn_n"]),
    }
    print("claims:", {k: ("PASS" if v else "FAIL") for k, v in claims.items()})
    return claims


def literal_ablation(episodes=None, seeds=None, trials: int = TRIALS,
                     device=None, pods=None) -> dict:
    """The literal Table-4 update (bandit targets, unshaped rewards)."""
    tr = train_policy("sdqn_literal", episodes, min(LITERAL_SEEDS, seeds or
                                                    LITERAL_SEEDS),
                      device, pods, seed=LITERAL_SEED)
    res = evaluate(schedulers.make_sdqn_selector(tr.pop("params"), CFG),
                   trials, device)
    mets, mean, cv = _stats(res)
    print(f"\n--- Ablation: literal Table-4 (bandit, unshaped) SDQN: "
          f"{mean:.2f}% (CV {cv:.2f}%; {tr['seeds']} seeds x "
          f"{tr['episodes']} episodes in {tr['seconds']:.1f} s) ---")
    return dict(tr, metric=mets, mean=mean, cv_pct=cv)


def policy_class_table(episodes=None, seeds=None, trials: int = TRIALS,
                       device=None, pods=None) -> dict:
    """kube and every registered policy class trained through the same
    learner with an equal budget, on the Table-8 protocol's trials."""
    print("\n--- Policy-class table: registry head-to-head, Table-8 "
          "protocol ---")
    rows = {}
    _, mean, cv = _stats(evaluate(schedulers.make_kube_selector(CFG), trials,
                                  device))
    rows["kube"] = {"mean": mean, "cv_pct": cv}
    print(f"  {'kube':10s} avg_cpu={mean:6.2f}%  CV={cv:.2f}%")
    n_eps = POLICY_EPISODES if episodes is None else episodes
    for i, name in enumerate(sorted(policy.names())):
        rl = dataclasses.replace(preset("sdqn", n_eps, pods), policy=name)
        tr = train_policy("sdqn", seeds=min(POLICY_SEEDS, seeds or
                                            POLICY_SEEDS),
                          device=device, rl=rl, seed=POLICY_SEED + i)
        sel = schedulers.make_policy_selector(policy.get(name),
                                              tr.pop("params"), CFG)
        _, mean, cv = _stats(evaluate(sel, trials, device))
        rows[name] = dict(tr, mean=mean, cv_pct=cv)
        print(f"  {name:10s} avg_cpu={mean:6.2f}%  CV={cv:.2f}%  "
              f"trained {tr['seeds']} seeds x {tr['episodes']} episodes in "
              f"{tr['seconds']:.1f} s")
    return rows


def run_baselines(episodes=None, seeds=None, trials: int = TRIALS,
                  device=None, pods=None, tables=None) -> dict:
    """Tables 11/12, Figure 6, the literal ablation and the policy-class
    table; ``tables`` is ``run``'s output (run here when not given).
    Returns every number, the scorers' params under ``"params"``."""
    device = resolve_device(device)
    if tables is None:
        tables = run(episodes, seeds, trials, device, pods)
    cuts = _cuts(episodes, seeds, trials, pods)
    print(f"\npaper baselines on {device}: "
          + (f"CUT budget {cuts} (full: {presets.N_SUPERVISED_SEEDS} seeds x "
             f"{presets.SUPERVISED_EPISODES} episodes a scorer)" if cuts
             else "full budget"))
    out = {"cuts": cuts, "device": str(device), "train": {}, "params": {},
           "tables": dict(tables["tables"])}
    for name, (_, score_fn, _) in SCORERS.items():
        tr = train_scorer(name, episodes, seeds, device, pods)
        out["params"][name] = params = tr.pop("params")
        out["train"][name] = tr
        print(f"trained {name}: {tr['seeds']} seeds x {tr['episodes']} "
              f"episodes in {tr['seconds']:.1f} s, validation metric "
              f"{tr['val_metric']:.3f}")
        res = evaluate(schedulers.make_neural_selector(params, score_fn, CFG),
                       trials, device)
        out["tables"][name] = table(name, res)
    out["claims"] = figure6(out["tables"])
    out["literal"] = literal_ablation(episodes, seeds, trials, device, pods)
    out["policy_class"] = policy_class_table(episodes, seeds, trials, device,
                                             pods)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--episodes", type=int, default=None,
                    help="training episodes per learned scheduler (default: "
                         "the presets')")
    ap.add_argument("--seeds", type=int, default=None,
                    help=f"candidates per variant (default "
                         f"{presets.N_SELECTION_SEEDS}, "
                         f"{presets.N_SUPERVISED_SEEDS} a scorer)")
    ap.add_argument("--trials", type=int, default=TRIALS)
    ap.add_argument("--pods", type=int, default=None,
                    help="pods per training episode (default 50)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run there (default: the CUDA card)")
    ap.add_argument("--json", default=None, help="write the numbers here")
    args = ap.parse_args(argv)
    if args.device is None:
        torch.backends.cuda.matmul.allow_tf32 = False
    out = run(args.episodes, args.seeds, args.trials, args.device, args.pods)
    base = run_baselines(args.episodes, args.seeds, args.trials,
                         args.device, args.pods, tables=out)
    base.pop("params")
    out["baselines"] = base
    out.pop("params")
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
