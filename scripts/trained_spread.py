#!/usr/bin/env python3
"""Do the port's trained policies land where the reference's do, when
both are scored on the same trials?

    python3 scripts/trained_spread.py --side reference [--study S] [--draws N] [--first D] --json ref.json
    python3 scripts/trained_spread.py --side paired    [--study S] [--draws N] [--first D] --json paired.json
    python3 scripts/trained_spread.py --side port [--device cpu|cuda] [--trials reference|port]
                                      [--study S] [--draws N] [--first D] --json port.json
    python3 scripts/trained_spread.py --compare A.json[,A2.json...] B.json[,B2.json...] [--json out.json]

``--study tables`` (the default) is Tables 8-10 at ``chip_smoke.py`` phase
16's cut: kube, and SDQN and SDQN-n from their presets cut to 20 episodes,
2 candidate seeds each, the best kept on 12 validation bursts, each scored
on 5 trials of 50 pods on the paper cluster.  ``--study baselines`` is the
rest of Figure 6 at the budgets of the port's ``scripts/paper_tables.py``:
the LSTM and Transformer scorers (4 seeds x 30 supervised episodes of 8
clusters, the best on 6 validation bursts) and the literal Table-4
ablation (its preset, 500 episodes, 3 seeds, the best on 12 bursts).
Draw ``d`` trains SDQN from seed ``d``, SDQN-n from ``1000 + d``, the
scorers' seed ``s`` from ``(2000 + d, salt + s)`` (salts 70 and 90, as
the reference's ``benchmarks/paper_tables.py``) and the literal ablation
from ``3000 + d``:

* ``--side reference`` trains with the JAX package from
  ``PRNGKey(seed)`` (the scorers from ``fold_in(PRNGKey(2000 + d),
  salt + s)``), validates on ``fixed_trial_keys(5000, ...)`` and scores
  on ``fixed_trial_keys(100, 5)``, as the reference does;
* ``--side paired`` runs the reference as above and, on the CPU, the
  port's own ``train_and_select`` (``train_supervised_scorer``) on the
  reference's very draws, rebuilt from its keys by
  ``tests/torch_parity.py``; it writes each side's selected seed and
  validation metrics, the first (episode, step, seed, env) whose actions
  differ with the gap between the port's two best feasible Q values there,
  the port's first near tie (a greedy choice whose two best Q values lie
  within ``TIE_TOL``), and both sides' trial metrics;
* ``--side port`` imports no JAX on its own path: its training draws come
  from CPU ``TorchDraws`` generators seeded as above, recorded and
  replayed on ``--device`` through ``ArrayDraws``, so a card run and a CPU
  run of one draw train on the same numbers.  ``--trials reference``
  validates and scores it on the reference's bursts and trials (rebuilt
  with the JAX package, which must import there); ``--trials port`` on
  bursts and trials recorded from CPU ``TorchDraws`` seeded 5000 and 100.

``--study scenarios | lifecycle | pareto`` are the reference benches'
scenario sweep, lifecycle rows and green Pareto rows
(``benchmarks/scenario_bench.py``, ``lifecycle_bench.py``): each policy
trained by ``train_mixture`` at their 120 episodes (``MIX_POLICIES``;
draw ``d`` from ``PRNGKey(base + d)`` on the reference, a generator
seeded ``base + d`` on the port), each cell scored on 3 trials of each
scenario's own arrivals: the reference's ``trial_keys(PRNGKey(100),
3)`` (``reference:100x3``, failure traces included) or recorded from a
CPU ``TorchDraws`` seeded 100 (``port:100x3``).  Their ``--compare``
holds kube and TOPSIS equal trial by trial and decides every trained
(scenario, policy, metric) row by Welch and Brown-Forsythe, each
family Holm-adjusted over the study's rows; their paired arm also
follows both learners' ReLU gates, params and bootstrap argmax margin
step by step (``_GateDrift``).

Every line and every JSON names its trial set (``reference:100x5`` or
``port:100x5``).  ``--compare`` refuses two files scored on different
trials; otherwise, per scheduler, it prints Welch's t-test on the draws'
means, Brown-Forsythe (``levene(center="median")``) on their spread and
the ratio of standard deviations with a bootstrap 95% interval, each
decided at ``ALPHA`` = 0.01, fixed before any run.  Given two port runs of
the same draws (the card's and the CPU's), it also says per draw whether
the learner's actions are equal up to the first near tie, and the wall
time a draw on each.  A comma-separated list of files on either side
joins the shards of one run (``--first``, ``--draws``).

Order: the reference arm and the port arm on the reference's trials,
compared; the paired arm, which tells a learner fault from a stream's;
then on the card ``--device cuda --trials port`` beside ``--device cpu
--trials port`` on the same draws.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import importlib.util
import json
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import scenarios  # noqa: E402
from repro_torch.core import baselines, presets, schedulers  # noqa: E402
from repro_torch.core import env as kenv, train_rl  # noqa: E402
from repro_torch.core.draws import (ArrayDraws, SegmentDraws,  # noqa: E402
                                    TorchDraws, record_mixture_draws,
                                    record_supervised_draws,
                                    record_train_draws, record_trial_draws)
from repro_torch.core.types import paper_cluster, training_cluster  # noqa: E402
from repro_torch.eval import engine as eval_engine  # noqa: E402
from repro_torch.sched import elastic, topsis  # noqa: E402
from repro_torch.train import engine as train_engine  # noqa: E402

ALPHA = 0.01                 # the decision level, fixed before any run
TIE_TOL = 1e-5               # a near tie: two best feasible Q values closer
METRIC_RTOL = 1e-5           # a trial metric's float32 sums, reassociated
BOOTSTRAP = 10_000
N_PODS = 50
TRIAL_SEED, VALIDATION_SEED = 100, 5000
# the studies' budgets: phase 16's cut, and scripts/paper_tables.py's
TABLES = dict(episodes=20, seeds=2, trials=5, val_trials=12)
BASELINES = dict(sup_seeds=presets.N_SUPERVISED_SEEDS,
                 sup_episodes=presets.SUPERVISED_EPISODES, sup_envs=8,
                 sup_val_trials=6, literal_seeds=3, literal_episodes=None,
                 trials=5, val_trials=12)
# the scenario studies (benchmarks/scenario_bench.py, lifecycle_bench.py):
# 120 training episodes a policy, 3 trials a cell, the draws a side
MIX = dict(episodes=120, trials=3)
MIX_DRAWS = {"scenarios": 16, "lifecycle": 16, "pareto": 8}
FIXED_ARMS = ("kube", "topsis")      # no training: the trials alone decide


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the port's scenario tables: the pass period, the Pareto weights, the
# dominance rule and the weights' tags, as benchmarks/lifecycle_bench.py
ST = _load("scenario_tables", ROOT / "scripts" / "scenario_tables.py")
# a trained policy: (mixture, preset, energy weight, seed base); every
# Pareto weight trains from the lifecycle SDQN-n's seed, as the bench's 43
MIX_POLICIES = {
    "scenarios": {"sdqn": ("SCENARIO_MIX_NAMES", "SDQN_SCENARIO_MIX_PRESET",
                           None, "mixture")},
    "lifecycle": {"sdqn": ("LIFECYCLE_MIX_NAMES", "SDQN_LIFECYCLE_PRESET",
                           None, "lifecycle_sdqn"),
                  "sdqnn": ("LIFECYCLE_MIX_NAMES", "SDQN_N_LIFECYCLE_PRESET",
                            None, "lifecycle_sdqnn")},
    "pareto": {f"sdqnn_{ST._wtag(w)}": ("LIFECYCLE_MIX_NAMES",
                                        "SDQN_N_LIFECYCLE_PRESET", w,
                                        "lifecycle_sdqnn")
               for w in ST.PARETO_ENERGY_WEIGHTS}}
MIX_METRICS = {"scenarios": ("avg_cpu", "placed", "dropped"),
               "lifecycle": ("nodes_active", "energy_wh", "avg_cpu",
                             "retired", "moved"),
               "pareto": ("avg_cpu", "energy_wh", "dropped")}
CHAOS_METRICS = ("evicted", "rescheduled", "lost")
FLOAT_METRICS = ("avg_cpu", "nodes_active", "energy_wh")
STUDIES = {"tables": ("default", "sdqn", "sdqn_n"),
           "baselines": ("default", "lstm", "transformer", "literal"),
           "scenarios": ("kube", "sdqn"),
           "lifecycle": ("kube", "sdqn", "sdqnn"),
           "pareto": ("kube", "topsis") + tuple(MIX_POLICIES["pareto"])}
SEED_BASE = {"sdqn": 0, "sdqn_n": 1000, "scorers": 2000, "literal": 3000,
             "mixture": 4000, "lifecycle_sdqn": 4100,
             "lifecycle_sdqnn": 4200}
SALT = {"lstm": 70, "transformer": 90}
RL_PRESET = {"sdqn": "SDQN_PRESET", "sdqn_n": "SDQN_N_PRESET",
             "literal": "SDQN_LITERAL_PRESET"}
SCORERS = {"lstm": (baselines.init_lstm, baselines.lstm_score),
           "transformer": (baselines.init_transformer,
                           baselines.transformer_score)}
CPU = torch.device("cpu")


def trial_set(kind: str, trials: int) -> str:
    return f"{kind}:{TRIAL_SEED}x{trials}"


def validation_set(kind: str, budget: dict) -> str:
    sizes = [budget["val_trials"]] + ([budget["sup_val_trials"]]
                                      if "sup_val_trials" in budget else [])
    return f"{kind}:" + ",".join(f"{VALIDATION_SEED}x{n}" for n in sizes)


def _rl(name: str, budget: dict, pkg=presets):
    """The preset of ``name`` with the study's episodes."""
    rl = getattr(pkg, RL_PRESET[name])
    eps = (budget["episodes"] if name != "literal"
           else budget["literal_episodes"])
    return rl if eps is None else dataclasses.replace(rl, episodes=eps)


def _n_seeds(name: str, budget: dict) -> int:
    return budget["literal_seeds"] if name == "literal" else budget["seeds"]


def _scorer_seed(d: int, name: str, s: int) -> int:
    """The port's generator seed of scorer candidate ``s`` in draw ``d``."""
    return 100 * (SEED_BASE["scorers"] + d) + SALT[name] + s


def _host(x) -> np.ndarray:
    """A torch tensor or a JAX array as a numpy array."""
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


def _trial_row(res) -> dict:
    metric = [float(m) for m in _host(res.metric)]
    return {"metric": metric, "mean": float(np.mean(metric)),
            "exp_pods": _host(res.exp_pods).tolist()}


class _SelectSpy:
    """Records the per-candidate validation metrics ``select_best`` gets
    in ``module`` (the reference's or the port's ``train.engine``) and the
    seed it picks (the first guarded minimum)."""

    def __init__(self, module):
        self.module = module

    def __enter__(self):
        self.metrics = None
        self._orig = orig = self.module.select_best

        def spy(stacked, metrics):
            self.metrics = [float(m) for m in _host(metrics)]
            return orig(stacked, metrics)

        self.module.select_best = spy
        return self

    def __exit__(self, *exc):
        self.module.select_best = self._orig

    @property
    def selected(self) -> int:
        guarded = [np.inf if np.isnan(m) else m for m in self.metrics]
        return int(np.argmin(guarded))


class _LearnerSpy:
    """The port learner's selections (``train_rl.masked_argmax``): per pod
    step the actions, a digest of them, and the gap between the two best
    feasible Q values of every row (with whether the row was greedy)."""

    def __enter__(self):
        self.actions, self.gaps, self.greedy = [], [], []
        self._orig = orig = train_rl.masked_argmax

        def spy(gen, scores, ok, epsilon=0.0, *, u=None, noise=None):
            a = orig(gen, scores, ok, epsilon, u=u, noise=noise)
            masked = torch.where(ok, scores,
                                 torch.full_like(scores, -torch.inf))
            top = torch.topk(masked, min(2, scores.shape[-1]), dim=-1).values
            greedy = torch.isfinite(top[..., -1])
            if u is not None:
                greedy &= u >= epsilon
            self.actions.append(a.cpu().numpy().astype(np.int32))
            self.gaps.append((top[..., 0] - top[..., -1]).cpu().numpy())
            self.greedy.append(greedy.cpu().numpy())
            return a

        train_rl.masked_argmax = spy
        return self

    def __exit__(self, *exc):
        train_rl.masked_argmax = self._orig

    def first_near_tie(self):
        for i, (g, ok) in enumerate(zip(self.gaps, self.greedy)):
            if bool(np.any(g[ok] <= TIE_TOL)):
                return i
        return None

    def digests(self):
        return [hashlib.blake2b(a.tobytes(), digest_size=6).hexdigest()
                for a in self.actions]

    def min_gaps(self):
        """Each pod step's smallest gap over its greedy rows (None where
        every row explored)."""
        return [float(g[ok].min()) if ok.any() else None
                for g, ok in zip(self.gaps, self.greedy)]


# ---------------------------------------------------------------------------
# the reference (JAX), CPU
# ---------------------------------------------------------------------------

class _Reference:
    """The JAX package's side of a study, its trials and bursts."""

    def __init__(self, budget: dict):
        import jax

        from repro.core import baselines as jbase, presets as jpresets
        from repro.core import schedulers as jsched, train_rl as jtrain
        from repro.core.types import paper_cluster as jpaper
        from repro.core.types import training_cluster as jtraining
        from repro.eval import engine as jeval
        from repro.train import engine as jengine

        self.jax, self.jpresets = jax, jpresets
        self.jsched, self.jtrain, self.jeval = jsched, jtrain, jeval
        self.jengine = jengine
        self.cfg, self.tcfg = jpaper(), jtraining()
        self.budget = budget
        self.keys = jeval.fixed_trial_keys(TRIAL_SEED, budget["trials"])
        self.scorers = {"lstm": (jbase.init_lstm, jbase.lstm_score),
                        "transformer": (jbase.init_transformer,
                                        jbase.transformer_score)}

    def key(self, name: str, d: int):
        return self.jax.random.PRNGKey(SEED_BASE[name] + d)

    def score(self, select) -> dict:
        return _trial_row(self.jeval.make_batch_episode(
            self.cfg, select, N_PODS)(self.keys))

    def kube(self) -> dict:
        return self.score(self.jsched.make_kube_selector(self.cfg))

    def rl(self, name):
        return _rl(name, self.budget, self.jpresets)

    def learned(self, name: str, d: int) -> dict:
        """train_and_select of ``name`` for draw ``d``, and its trials."""
        with _SelectSpy(self.jengine) as sel:
            params, val = self.jengine.train_and_select(
                self.key(name, d), self.tcfg, self.cfg, self.rl(name),
                n_seeds=_n_seeds(name, self.budget),
                val_trials=self.budget["val_trials"])
        row = self.score(self.jsched.make_sdqn_selector(params, self.cfg))
        row.update(selected=sel.selected, val=sel.metrics, val_metric=val)
        return row, params

    def scorer_key(self, name: str, d: int, s: int):
        base = self.jax.random.PRNGKey(SEED_BASE["scorers"] + d)
        return self.jax.random.fold_in(base, SALT[name] + s)

    def scorer(self, name: str, d: int) -> dict:
        """The reference's ``pick_supervised`` for draw ``d``."""
        init_fn, score_fn = self.scorers[name]
        b = self.budget
        evaluator = self.jeval.make_param_evaluator(
            self.cfg, lambda p: self.jsched.make_neural_selector(
                p, score_fn, self.cfg), N_PODS)
        val_keys = self.jeval.fixed_trial_keys(VALIDATION_SEED,
                                               b["sup_val_trials"])
        vals, cands = [], []
        for s in range(b["sup_seeds"]):
            p = self.jtrain.train_supervised_scorer(
                self.scorer_key(name, d, s), self.tcfg, init_fn, score_fn,
                episodes=b["sup_episodes"], n_envs=b["sup_envs"])
            vals.append(float(np.mean(np.asarray(evaluator(p,
                                                           val_keys).metric))))
            cands.append(p)
        best = _first_min(vals)
        row = self.score(self.jsched.make_neural_selector(
            cands[best], score_fn, self.cfg))
        row.update(selected=best, val=vals, val_metric=vals[best])
        return row, cands


def _first_min(vals) -> int:
    """The first candidate strictly below every earlier one, as the
    scripts' ``m < best_m`` loops keep it."""
    best, best_m = 0, float("inf")
    for i, m in enumerate(vals):
        if m < best_m:
            best, best_m = i, m
    return best


def reference_draw(d: int, study: str, budget: dict, ref=None) -> dict:
    """One draw of the reference: {scheduler: its trials and selection}."""
    ref = ref or _Reference(budget)
    out = {"default": ref.kube()}
    for name in STUDIES[study][1:]:
        out[name] = (ref.scorer(name, d) if name in SCORERS
                     else ref.learned(name, d))[0]
    return out


# ---------------------------------------------------------------------------
# the port on the reference's own draws (paired), CPU
# ---------------------------------------------------------------------------

def _parity():
    return _load("torch_parity", ROOT / "tests" / "torch_parity.py")


def _port_trials(arrays, select, device) -> dict:
    return _trial_row(eval_engine.make_batch_episode(
        paper_cluster(), select, N_PODS, device=device)(
            ArrayDraws(**arrays, device=device)))


def _first_diff(spy: _LearnerSpy, ref_actions: dict, pods: int):
    """The first (episode, step, seed, env) where the port's action differs
    from the reference's, with the port's Q gap there; None if none."""
    for i, a in enumerate(spy.actions):
        ep, t = divmod(i, pods)
        for s, e in np.ndindex(a.shape):
            want = ref_actions[(s, ep, t, e)]
            if int(a[s, e]) != want:
                return {"episode": ep, "step": t, "seed": s, "env": e,
                        "port": int(a[s, e]), "reference": want,
                        "gap": float(spy.gaps[i][s, e]),
                        "greedy": bool(spy.greedy[i][s, e])}
    return None


class _ReferenceActions:
    """Records the reference learner's (key bytes, action) of every
    selection, through a ``jax.debug.callback`` around its
    ``masked_argmax`` (installed before its first trace)."""

    def __init__(self, ref: _Reference):
        jax, jtrain = ref.jax, ref.jtrain
        self.seen = []
        orig = ref.jsched.masked_argmax

        def spy(key, scores, ok, epsilon=0.0):
            a = orig(key, scores, ok, epsilon)
            jax.debug.callback(lambda k, x: self.seen.append(
                (np.asarray(k, np.uint32).tobytes(), int(x))), key, a)
            return a

        jtrain.masked_argmax = spy
        self.restore = lambda: setattr(jtrain, "masked_argmax", orig)


def paired_draw(d: int, study: str, budget: dict, ref=None,
                recorder=None) -> dict:
    """One draw of the reference and the port trained on the reference's
    draws, compared step by step."""
    ref = ref or _Reference(budget)
    recorder = recorder or _ReferenceActions(ref)
    tp = _parity()
    tcfg, cfg = training_cluster(), paper_cluster()
    trials = tp.reference_trial_draws(ref.keys, ref.cfg, N_PODS)
    out = {"default": {"reference": ref.kube(),
                       "port": _port_trials(
                           trials, schedulers.make_kube_selector(cfg), CPU)}}
    for name in STUDIES[study][1:]:
        if name in SCORERS:
            out[name] = _paired_scorer(ref, tp, name, d, trials)
            continue
        recorder.seen.clear()
        want, _ = ref.learned(name, d)
        rl, n_seeds = _rl(name, budget), _n_seeds(name, budget)
        names = {}
        draws = tp.seeded_train_draws(ref.key(name, d), ref.tcfg,
                                      ref.rl(name), n_seeds, names=names)
        ref_actions = {names[k]: a for k, a in recorder.seen}
        val = tp.reference_trial_draws(ref.jeval.fixed_trial_keys(
            VALIDATION_SEED, budget["val_trials"]), ref.cfg, N_PODS)
        with _LearnerSpy() as spy, _SelectSpy(train_engine) as sel:
            params, vm = train_engine.train_and_select(
                ArrayDraws(**draws, device=CPU), tcfg, cfg, rl,
                n_seeds=n_seeds, val_trials=budget["val_trials"],
                val_draws=ArrayDraws(**val, device=CPU), device=CPU)
        got = _port_trials(trials, schedulers.make_sdqn_selector(params, cfg),
                           CPU)
        got.update(selected=sel.selected, val=sel.metrics, val_metric=vm)
        steps = rl.episodes * rl.pods_per_episode * n_seeds * rl.n_envs
        assert len(ref_actions) == steps, (len(ref_actions), steps)
        diff = _first_diff(spy, ref_actions, rl.pods_per_episode)
        tie = spy.first_near_tie()
        out[name] = {"reference": want, "port": got, "first_diff": diff,
                     "first_near_tie": tie, "pod_steps": len(spy.actions)}
        step = (None if diff is None
                else diff["episode"] * rl.pods_per_episode + diff["step"])
        if step is not None and (tie is None or tie > step):
            out[name]["single_seed"] = _single_seed_check(
                ref, recorder, tp, name, d, diff["seed"], spy)
    return out


def _single_seed_check(ref, recorder, tp, name, d, seed, spy) -> dict:
    """Where the port departs from the reference's ``train_seeds`` with no
    near tie first: the same seed against the reference's own
    single-seed ``train(fold_in(key, seed))``, which ``train_seeds`` is
    documented to equal."""
    jax = ref.jax
    rl = ref.rl(name)
    key = jax.random.fold_in(ref.key(name, d), seed)
    recorder.seen.clear()
    jax.jit(lambda k: ref.jtrain.train(k, ref.tcfg, rl))(key)
    _, names = tp.reference_train_draws(key, ref.tcfg, rl)
    actions = {(0,) + names[k]: a for k, a in recorder.seen}
    one = _LearnerSpy()
    one.actions = [a[seed:seed + 1] for a in spy.actions]
    one.gaps = [g[seed:seed + 1] for g in spy.gaps]
    one.greedy = [g[seed:seed + 1] for g in spy.greedy]
    diff = _first_diff(one, actions, rl.pods_per_episode)
    return {"seed": seed, "first_diff": diff,
            "first_near_tie": one.first_near_tie()}


def _paired_scorer(ref, tp, name, d, trials) -> dict:
    """A scorer's candidates trained by the port on the reference's own
    draws (``reference_supervised_draws``), selected on the reference's
    bursts and scored on its trials, beside the reference's."""
    from repro_torch import convert

    b = ref.budget
    want, jcands = ref.scorer(name, d)
    init_fn, score_fn = SCORERS[name]
    cfg = paper_cluster()
    val = ArrayDraws(**tp.reference_trial_draws(ref.jeval.fixed_trial_keys(
        VALIDATION_SEED, b["sup_val_trials"]), ref.cfg, N_PODS), device=CPU)
    evaluator = eval_engine.make_param_evaluator(
        cfg, lambda p: schedulers.make_neural_selector(p, score_fn, cfg),
        N_PODS, device=CPU)
    vals, cands, diffs = [], [], []
    for s in range(b["sup_seeds"]):
        draws = tp.reference_supervised_draws(
            ref.scorer_key(name, d, s), ref.tcfg, ref.scorers[name][0],
            b["sup_episodes"], 50, b["sup_envs"])
        p = train_rl.train_supervised_scorer(
            ArrayDraws(**draws, device=CPU), training_cluster(), init_fn,
            score_fn, episodes=b["sup_episodes"], n_envs=b["sup_envs"],
            device=CPU)
        jp = convert.baseline_params_from_numpy(
            {k: np.asarray(v) for k, v in jcands[s].items()}, name,
            device=CPU)
        diffs.append(max(float((p[k] - jp[k]).abs().max()) for k in p))
        vals.append(float(evaluator(p, val).metric.mean()))
        cands.append(p)
    best = _first_min(vals)
    got = _port_trials(trials, schedulers.make_neural_selector(
        cands[best], score_fn, cfg), CPU)
    got.update(selected=best, val=vals, val_metric=vals[best])
    return {"reference": want, "port": got, "params_max_abs_diff": diffs}


# ---------------------------------------------------------------------------
# the port alone, on the CPU or the card
# ---------------------------------------------------------------------------

def _need_jax():
    """JAX, which rebuilding the reference's trials needs."""
    try:
        import jax
    except ImportError:
        raise SystemExit("--trials reference rebuilds the reference's trials "
                         "with the JAX package, which does not import here; "
                         "give --trials port") from None
    return jax


def _recorded_bursts(kind: str, seed: int, trials: int):
    """``trials`` episodes' draws from ``seed`` as numpy arrays: the
    reference's (``fixed_trial_keys(seed, trials)``, rebuilt with the JAX
    package) or recorded from a CPU ``TorchDraws`` seeded ``seed``."""
    if kind == "port":
        return record_trial_draws(TorchDraws(
            torch.Generator().manual_seed(seed), (trials,)), paper_cluster(),
            N_PODS)
    _need_jax()
    from repro.core.types import paper_cluster as jpaper
    from repro.eval import engine as jeval

    return _parity().reference_trial_draws(jeval.fixed_trial_keys(seed,
                                                                  trials),
                                           jpaper(), N_PODS)


class _Port:
    """The port's side of a study on ``device``, its bursts and trials of
    kind ``trials``."""

    def __init__(self, budget: dict, trials: str, device):
        self.budget, self.device = budget, torch.device(device)
        self.trials = _recorded_bursts(trials, TRIAL_SEED, budget["trials"])
        self.val = _recorded_bursts(trials, VALIDATION_SEED,
                                    budget["val_trials"])
        self.sup_val = (_recorded_bursts(trials, VALIDATION_SEED,
                                         budget["sup_val_trials"])
                        if "sup_val_trials" in budget else None)
        self.cfg, self.tcfg = paper_cluster(), training_cluster()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def score(self, select) -> dict:
        return _port_trials(self.trials, select, self.device)

    def learned(self, name: str, d: int) -> dict:
        rl, n_seeds = _rl(name, self.budget), _n_seeds(name, self.budget)
        arrays = record_train_draws(TorchDraws(
            torch.Generator().manual_seed(SEED_BASE[name] + d),
            (n_seeds, rl.n_envs)), self.tcfg, rl, n_seeds, CPU)
        t0 = time.perf_counter()
        with _LearnerSpy() as spy, _SelectSpy(train_engine) as sel:
            params, vm = train_engine.train_and_select(
                ArrayDraws(**arrays, device=self.device), self.tcfg, self.cfg,
                rl, n_seeds=n_seeds, val_trials=self.budget["val_trials"],
                val_draws=ArrayDraws(**self.val, device=self.device),
                device=self.device)
            self._sync()
        secs = time.perf_counter() - t0
        row = self.score(schedulers.make_sdqn_selector(params, self.cfg))
        row.update(selected=sel.selected, val=sel.metrics, val_metric=vm,
                   train_seconds=secs, actions=spy.digests(),
                   min_gaps=spy.min_gaps(),
                   first_near_tie=spy.first_near_tie())
        return row

    def scorer(self, name: str, d: int) -> dict:
        init_fn, score_fn = SCORERS[name]
        b = self.budget
        evaluator = eval_engine.make_param_evaluator(
            self.cfg, lambda p: schedulers.make_neural_selector(
                p, score_fn, self.cfg), N_PODS, device=self.device)
        vals, cands = [], []
        t0 = time.perf_counter()
        for s in range(b["sup_seeds"]):
            arrays = record_supervised_draws(TorchDraws(
                torch.Generator().manual_seed(_scorer_seed(d, name, s)),
                (b["sup_envs"],)), self.tcfg, init_fn, b["sup_episodes"],
                N_PODS, b["sup_envs"], CPU)
            p = train_rl.train_supervised_scorer(
                ArrayDraws(**arrays, device=self.device), self.tcfg, init_fn,
                score_fn, episodes=b["sup_episodes"], n_envs=b["sup_envs"],
                device=self.device)
            vals.append(float(evaluator(p, ArrayDraws(
                **self.sup_val, device=self.device)).metric.mean()))
            cands.append(p)
        self._sync()
        secs = time.perf_counter() - t0
        best = _first_min(vals)
        row = self.score(schedulers.make_neural_selector(cands[best],
                                                         score_fn, self.cfg))
        row.update(selected=best, val=vals, val_metric=vals[best],
                   train_seconds=secs)
        return row


def port_draw(d: int, study: str, budget: dict, port: _Port) -> dict:
    """One draw of the port: {scheduler: its trials and selection}."""
    out = {"default": port.score(schedulers.make_kube_selector(port.cfg))}
    for name in STUDIES[study][1:]:
        out[name] = (port.scorer(name, d) if name in SCORERS
                     else port.learned(name, d))
    return out


# ---------------------------------------------------------------------------
# the scenario studies: the sweep, the lifecycle rows, the green Pareto rows
# ---------------------------------------------------------------------------

def mix_cells(study: str) -> list:
    """``[(scenario, arm, consolidating)]`` of a scenario study, in its
    bench's order: every scenario but the scoring-only family under kube
    and the mixture SDQN; or each churn scenario under its arms, the
    SDQN-n arms with the pass every ``ST.CONSOLIDATE_EVERY_S``."""
    if study == "scenarios":
        return [(n, arm, False) for n in scenarios.scenario_names()
                if n not in scenarios.SCORING_ONLY for arm in STUDIES[study]]
    return [(n, arm, arm.startswith("sdqnn"))
            for n in presets.LIFECYCLE_MIX_NAMES for arm in STUDIES[study]]


def mix_metrics(study: str, scenario: str) -> tuple:
    """The metrics of a study's rows on ``scenario``; the scenario sweep
    adds the chaos counts where nodes fail."""
    extra = (CHAOS_METRICS if study == "scenarios"
             and kenv.has_chaos(scenarios.make_env(scenario)) else ())
    return MIX_METRICS[study] + extra


def _mix_rl(study: str, name: str, budget: dict, pkg=presets):
    """(the mixture's scenario names, the RL config) of a trained policy,
    from ``pkg``'s presets at the budget's episodes."""
    mix, preset, weight, _ = MIX_POLICIES[study][name]
    rl = dataclasses.replace(getattr(pkg, preset),
                             episodes=budget["episodes"])
    if weight is not None:
        rl = dataclasses.replace(rl, energy_weight=float(weight))
    return getattr(pkg, mix), rl


def _mix_seed(study: str, name: str, d: int) -> int:
    return SEED_BASE[MIX_POLICIES[study][name][3]] + d


def _episode_row(metric, dropped, n, stats: dict, exp_pods) -> dict:
    """A cell's per-trial numbers (lists over trials)."""
    row = {"avg_cpu": _host(metric).astype(float).tolist(),
           "dropped": _host(dropped).astype(int).tolist(),
           "placed": (n - _host(dropped).astype(int)).tolist(),
           "exp_pods": _host(exp_pods).tolist()}
    for k, v in stats.items():
        row[k] = _host(v).tolist()
    return row


def _mix_cfg(pkg_scenarios, scenario: str, consolidating: bool):
    cfg = pkg_scenarios.make_env(scenario)
    if consolidating:
        cfg = dataclasses.replace(cfg,
                                  consolidate_every_s=ST.CONSOLIDATE_EVERY_S)
    return cfg


class _MixReference:
    """The JAX package's side of a scenario study: its trials
    (``trial_keys(PRNGKey(100), 3)``, the keys ``evaluate_scenario`` and
    the lifecycle bench fold in), its trainers and its cells."""

    def __init__(self, budget: dict):
        import jax

        from repro import scenarios as jscn
        from repro.core import env as jenv, presets as jpresets
        from repro.core import schedulers as jsched, train_rl as jtrain
        from repro.eval import engine as jeval
        from repro.sched import elastic as jelastic, topsis as jtopsis

        self.jax, self.jscn, self.jenv, self.jpresets = jax, jscn, jenv, \
            jpresets
        self.jsched, self.jtrain, self.jeval = jsched, jtrain, jeval
        self.jelastic, self.jtopsis = jelastic, jtopsis
        self.budget = budget
        self.keys = jeval.trial_keys(jax.random.PRNGKey(TRIAL_SEED),
                                     budget["trials"])

    def train(self, study: str, name: str, d: int):
        """``train_mixture`` of a study's policy for draw ``d``: (params,
        seconds)."""
        mix, rl = _mix_rl(study, name, self.budget, self.jpresets)
        t0 = time.perf_counter()
        params, _ = self.jtrain.train_mixture(
            self.jax.random.PRNGKey(_mix_seed(study, name, d)),
            self.jscn.training_mixture(mix), rl)
        params = self.jax.block_until_ready(params)
        return params, time.perf_counter() - t0

    def cell(self, scenario: str, arm: str, consolidating: bool,
             params=None, count_moved: bool = False) -> dict:
        """One cell on the reference's trials, every trial one batch (the
        benches' ``make_batch_episode`` body, its episode statistics
        kept).  ``count_moved``: the pods the pass moved, which the
        reference's episode drops, counted from a callback in the pass on
        each trial run alone."""
        jax, jenv = self.jax, self.jenv
        cfg = _mix_cfg(self.jscn, scenario, consolidating)
        n = cfg.scenario.n_pods
        if arm == "kube":
            select = self.jsched.make_kube_selector(cfg)
        elif arm == "topsis":
            select = self.jtopsis.make_topsis_selector(cfg)
        else:
            select = self.jsched.make_sdqn_selector(params, cfg)
        cons = (self.jelastic.make_consolidator(params, cfg)
                if consolidating else None)
        res = jax.jit(jax.vmap(lambda k: jenv.run_episode(
            k, cfg, select, n, consolidate=cons)))(self.keys)
        st = res.stats
        row = _episode_row(res.metric, res.dropped, n, dict(
            nodes_active=st.nodes_active_mean, energy_wh=st.energy_wh,
            retired=st.retired, evicted=st.evicted,
            rescheduled=st.rescheduled, lost=st.lost), res.state.exp_pods)
        row["moved"] = [0] * len(row["avg_cpu"])
        if cons is not None and count_moved:
            row["moved"], alone = self._moved(cfg, select, n, cons)
            row["moved_run_max_rel"] = float(np.max(np.abs(
                np.asarray(alone) / np.asarray(row["avg_cpu"]) - 1.0)))
        return row

    def _moved(self, cfg, select, n, cons):
        jax, seen = self.jax, []

        def counting(st, led):
            out = cons(st, led)
            jax.debug.callback(lambda m: seen.append(int(m)), out[2])
            return out

        one = jax.jit(lambda k: self.jenv.run_episode(
            k, cfg, select, n, consolidate=counting))
        moved, metric = [], []
        for k in self.keys:
            seen.clear()
            res = jax.block_until_ready(one(k))
            jax.effects_barrier()
            moved.append(sum(seen))
            metric.append(float(res.metric))
        return moved, metric


QNET_KEYS = ("w1", "b1", "w2", "b2")
PARAM_PART = 1e-5            # params apart by more than float error


class _GateDrift:
    """The two learners' discrete choices and params, step by step.  On
    equal actions the Q-nets can part only where a discrete choice
    differs: an action (``TIE_TOL``), a hidden unit's ReLU gate on a
    replay row that carries weight (its pre-activation on the other side
    of zero passes a gradient on one side only), or Double DQN's
    bootstrap argmax (``train_rl._bootstrap_bonus``).  The reference's
    learner step (``repro.core.policy.make_train_step``, the Table-4 net)
    reports its gates and its params after the step through a callback;
    the port's step compares its own at the same step, and the port's
    bootstrap reports the gap of its two best feasible online Q values."""

    def __init__(self, ref):
        import repro.core.policy as jpol

        jax, jnp = ref.jax, ref.jax.numpy
        self.steps = []
        orig = jpol.make_train_step

        def make(spec):
            step = orig(spec)

            def wrapped(params, opt_state, feats, targets, weights=None):
                gate = (feats @ params["w1"] + params["b1"]) > 0
                if weights is not None:
                    gate &= (weights > 0)[:, None]
                out = step(params, opt_state, feats, targets, weights)
                flat = jnp.concatenate([out[0][k].ravel() for k in QNET_KEYS])
                jax.debug.callback(lambda g, f: self.steps.append(
                    (np.packbits(np.asarray(g)), np.asarray(f))), gate, flat,
                    ordered=True)
                return out

            return wrapped

        jpol.make_train_step = make
        self.restore = lambda: setattr(jpol, "make_train_step", orig)

    def __enter__(self):
        from repro_torch.core import dqn, policy as tpol

        self.i, self.first_flip, self.flip_pre = 0, None, None
        self.diffs, self.boot_gaps, self.parted = [], [], False
        self.flips = []           # (step, largest |pre|) before the params part
        self._orig = orig = tpol.make_train_step
        self._orig_boot = boot = train_rl._bootstrap_bonus

        def bootstrap(online, target, state, pod, cfg, rl, spec=None,
                      embed=None, fused="auto"):
            ok = kenv.feasible(state, train_rl.pod_rows(pod, state.base_cpu),
                               cfg)
            q = train_rl.score_states(online, state, pod, cfg, fused=fused,
                                      policy=spec, embed=embed)
            top = torch.topk(torch.where(ok, q, torch.full_like(q, -torch.inf)),
                             min(2, q.shape[-1]), dim=-1).values
            gap = (top[..., 0] - top[..., -1])[torch.isfinite(top[..., -1])]
            self.boot_gaps.append(float(gap.min()) if gap.numel() else None)
            return boot(online, target, state, pod, cfg, rl, spec, embed,
                        fused)

        train_rl._bootstrap_bonus = bootstrap

        def make(spec):
            step = orig(spec)

            def wrapped(params, opt_state, feats, targets, weights=None):
                pre = dqn.linear(feats, params["w1"], params["b1"])
                gate = pre > 0
                if weights is not None:
                    gate &= (weights > 0)[..., None]
                out = step(params, opt_state, feats, targets, weights)
                ref_gate, ref_flat = self.steps[self.i]
                g = gate.reshape(-1).cpu().numpy()
                flip = np.unpackbits(ref_gate)[:g.size].astype(bool) != g
                if flip.any():
                    event = (self.i, float(pre.reshape(-1).cpu()[
                        torch.from_numpy(flip)].abs().max()))
                    if self.first_flip is None:
                        self.first_flip, self.flip_pre = event
                    if not self.parted:
                        self.flips.append(event)
                flat = torch.cat([out[0][k].reshape(-1) for k in QNET_KEYS])
                self.diffs.append(float(np.abs(flat.detach().cpu().numpy()
                                               - ref_flat).max()))
                self.parted |= self.diffs[-1] > PARAM_PART
                self.i += 1
                return out

            return wrapped

        tpol.make_train_step = make
        return self

    def __exit__(self, *exc):
        from repro_torch.core import policy as tpol

        tpol.make_train_step = self._orig
        train_rl._bootstrap_bonus = self._orig_boot

    def record(self) -> dict:
        """The first gate flip and bootstrap near tie, and where the params
        first part by more than ``PARAM_PART``: the last of either event
        at or before that step (its kind, step and size), the discrete
        choice the parting starts from."""
        part = next((i for i, d in enumerate(self.diffs) if d > PARAM_PART),
                    None)
        ties = [(i, g) for i, g in enumerate(self.boot_gaps)
                if g is not None and g <= TIE_TOL]
        tie = ties[0][0] if ties else None
        last = None
        if part is not None:
            events = ([("gate", i, m) for i, m in self.flips if i <= part]
                      + [("bootstrap", i, g) for i, g in ties if i <= part])
            last = max(events, key=lambda e: e[1], default=None)
        return {"last_event_before_part": last,
                "first_gate_flip": self.first_flip,
                "gate_flip_pre": self.flip_pre,
                "first_bootstrap_near_tie": tie,
                "bootstrap_gap": None if tie is None else self.boot_gaps[tie],
                "params_part_step": part}


def _port_cell(scenario: str, arm: str, consolidating: bool, params,
               arrays: dict, device) -> dict:
    """One cell on the port, on ``arrays`` (a scenario's trial draws)."""
    cfg = _mix_cfg(scenarios, scenario, consolidating)
    n = cfg.scenario.n_pods
    if arm == "kube":
        select = schedulers.make_kube_selector(cfg)
    elif arm == "topsis":
        select = topsis.make_topsis_selector(cfg)
    else:
        select = schedulers.make_sdqn_selector(params, cfg)
    cons = elastic.make_consolidator(params, cfg) if consolidating else None
    res = eval_engine.make_batch_episode(cfg, select, n, cons,
                                         device=device)(
        ArrayDraws(**arrays, device=device))
    return _episode_row(res.metric, res.dropped, n, dict(
        nodes_active=res.nodes_active, energy_wh=res.energy_wh,
        retired=res.retired, evicted=res.evicted,
        rescheduled=res.rescheduled, lost=res.lost, moved=res.moved),
        res.exp_pods)


def _mix_trials(kind: str, trials: int, names) -> dict:
    """{scenario: its trial draws as ``ArrayDraws`` arrays} of each of
    ``names``: the reference's own (``trial_keys(PRNGKey(100), trials)``,
    rebuilt with the JAX package, failure traces included) or recorded
    from a CPU ``TorchDraws`` seeded 100."""
    if kind == "port":
        return {n: record_trial_draws(TorchDraws(
            torch.Generator().manual_seed(TRIAL_SEED), (trials,)),
            scenarios.make_env(n), scenarios.make_env(n).scenario.n_pods)
            for n in names}
    jax = _need_jax()
    from repro import scenarios as jscn
    from repro.eval import engine as jeval

    keys = jeval.trial_keys(jax.random.PRNGKey(TRIAL_SEED), trials)
    tp = _parity()
    return {n: tp.reference_scenario_trial_draws(
        keys, jscn.make_env(n), jscn.make_env(n).scenario.n_pods)
        for n in names}


def _tree_diff(port: dict, ref) -> float:
    return max(float(np.max(np.abs(_host(port[k]) - np.asarray(ref[k]))))
               for k in port)


class _MixRun:
    """One arm of a scenario study: the fixed arms' rows (kube, TOPSIS)
    once, then per draw its trained policies and their rows."""

    def __init__(self, side: str, study: str, budget: dict, device, trials):
        self.side, self.study, self.budget = side, study, budget
        self.device = torch.device(device)
        self.cells = mix_cells(study)
        self.ref = _MixReference(budget) if side != "port" else None
        if side == "paired":
            self.recorder = _ReferenceActions(self.ref)
            self.drift = _GateDrift(self.ref)
            self.tp = _parity()
        self.arrays = (_mix_trials(trials, budget["trials"],
                                   dict.fromkeys(c[0] for c in self.cells))
                       if side != "reference" else None)
        self.fixed = {}
        for scenario, arm, cons in self.cells:
            if arm in FIXED_ARMS:
                self.fixed.setdefault(scenario, {})[arm] = self._row(
                    scenario, arm, cons, None, None)

    def close(self):
        """Undo the paired arm's patches of the reference's learner."""
        if self.side == "paired":
            self.recorder.restore()
            self.drift.restore()

    def _row(self, scenario, arm, cons, jparams, params):
        count = self.study == "lifecycle"
        if self.side == "reference":
            return self.ref.cell(scenario, arm, cons, jparams, count)
        got = _port_cell(scenario, arm, cons, params, self.arrays[scenario],
                         self.device)
        if self.side == "port":
            return got
        return {"reference": self.ref.cell(scenario, arm, cons, jparams,
                                           count), "port": got}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _train_port(self, name, d, blocks=None, drift=None):
        mix, rl = _mix_rl(self.study, name, self.budget)
        cfgs = scenarios.training_mixture(mix)
        if blocks is None:
            blocks = record_mixture_draws(TorchDraws(
                torch.Generator().manual_seed(_mix_seed(self.study, name, d)),
                (rl.n_envs,)), cfgs, rl, device=CPU)
        draws = SegmentDraws([(ep0, ArrayDraws(**b, device=self.device))
                              for ep0, b in blocks])
        t0 = time.perf_counter()
        with _LearnerSpy() as spy, (drift or contextlib.nullcontext()):
            params, _ = train_rl.train_mixture(draws, cfgs, rl,
                                               device=self.device)
            self._sync()
        return params, spy, time.perf_counter() - t0, rl

    def _train(self, name, d):
        """(reference params, port params, the policy's record)."""
        if self.side == "reference":
            jparams, secs = self.ref.train(self.study, name, d)
            return jparams, None, {"train_seconds": secs}
        if self.side == "port":
            params, spy, secs, _ = self._train_port(name, d)
            return None, params, {
                "train_seconds": secs, "actions": spy.digests(),
                "min_gaps": spy.min_gaps(),
                "first_near_tie": spy.first_near_tie()}
        self.recorder.seen.clear()
        self.drift.steps.clear()
        jparams, ref_secs = self.ref.train(self.study, name, d)
        self.ref.jax.effects_barrier()
        mix, jrl = _mix_rl(self.study, name, self.budget,
                           self.ref.jpresets)
        blocks, names = self.tp.reference_mixture_draws(
            self.ref.jax.random.PRNGKey(_mix_seed(self.study, name, d)),
            self.ref.jscn.training_mixture(mix), jrl, 4)
        ref_actions = {(0,) + names[k]: a for k, a in self.recorder.seen}
        params, spy, secs, rl = self._train_port(name, d, blocks, self.drift)
        assert len(ref_actions) == len(spy.actions) * rl.n_envs, (
            len(ref_actions), len(spy.actions))
        return jparams, params, dict(
            first_diff=_first_diff(spy, ref_actions, rl.pods_per_episode),
            first_near_tie=spy.first_near_tie(), pod_steps=len(spy.actions),
            params_max_abs_diff=_tree_diff(params, jparams),
            train_seconds=[ref_secs, secs], **self.drift.record())

    def draw(self, d: int) -> dict:
        policies, trained = {}, {}
        for name in MIX_POLICIES[self.study]:
            jparams, params, policies[name] = self._train(name, d)
            trained[name] = (jparams, params)
        rows = {}
        for scenario, arm, cons in self.cells:
            rows.setdefault(scenario, {})[arm] = (
                self.fixed[scenario][arm] if arm in FIXED_ARMS
                else self._row(scenario, arm, cons, *trained[arm]))
        return {"policies": policies, "rows": rows}


def mix_samples(out: dict, side: str = "port") -> dict:
    """``{(scenario, arm, metric): [a draw's trial mean, ...]}`` of a
    scenario study's run (a paired run: ``side``'s rows); the Pareto
    study adds ``(scenario, "sdqnn", "dominates")``, the SDQN-n points
    that dominate or match TOPSIS."""
    study, samples = out["study"], {}
    for r in out["per_draw"]:
        for scenario, arms in r["rows"].items():
            means = {}
            for arm, row in arms.items():
                row = row[side] if "port" in row else row
                means[arm] = {m: float(np.mean(row[m]))
                              for m in mix_metrics(study, scenario)}
                for m, v in means[arm].items():
                    samples.setdefault((scenario, arm, m), []).append(v)
            if study == "pareto":
                point = {a: {"metric_mean": v["avg_cpu"],
                             "energy_wh_mean": v["energy_wh"],
                             "dropped_mean": v["dropped"]}
                         for a, v in means.items()}
                samples.setdefault((scenario, "sdqnn", "dominates"), []).append(
                    float(sum(ST.dominates_or_matches(v, point["topsis"])
                              for a, v in point.items()
                              if a.startswith("sdqnn"))))
    return samples


def holm(pvalues) -> list:
    """Holm's step-down adjustment: the i-th smallest of m p-values times
    (m - i), running maximum, capped at 1; in the given order."""
    p = np.asarray(pvalues, np.float64)
    order = np.argsort(p, kind="stable")
    adj = np.minimum(1.0, np.maximum.accumulate(
        p[order] * (len(p) - np.arange(len(p)))))
    out = np.empty_like(p)
    out[order] = adj
    return out.tolist()


def _same_row(a: dict, b: dict, metrics) -> tuple:
    """(the per-trial numbers of two rows equal: counts exactly, floats
    within ``METRIC_RTOL``; their largest relative difference)."""
    rel = 0.0
    for m in metrics:
        x, y = np.asarray(a[m], np.float64), np.asarray(b[m], np.float64)
        if m in FLOAT_METRICS:
            with np.errstate(divide="ignore", invalid="ignore"):
                d = np.where(y == x, 0.0, np.abs(x / y - 1.0))
            rel = max(rel, float(d.max()))
        elif not np.array_equal(x, y):
            rel = float("inf")
    return rel <= METRIC_RTOL, rel


def compare_mix(a: dict, b: dict, log=print) -> dict:
    """A scenario study's rows, A against B: the fixed arms (kube, TOPSIS)
    equal trial by trial; each trained row by Welch and Brown-Forsythe,
    each family Holm-adjusted over the study's rows, decided at
    ``ALPHA``; two port runs of the same draws also by their actions."""
    study, tset = a["study"], a["trials"]
    sa, sb = mix_samples(a), mix_samples(b)
    rows = {key: compare_samples(sa[key], sb[key]) for key in sa
            if key[1] not in FIXED_ARMS}
    for key, res in rows.items():      # the draws above kube, each side
        kube = (key[0], "kube", key[2])
        if kube in sa:
            res["above_kube"] = [int(sum(x > s[kube][0] for x in s[key]))
                                 for s in (sa, sb)]
    fixed = {}
    for r in a["per_draw"] + b["per_draw"]:
        for scenario, arms in r["rows"].items():
            for arm in FIXED_ARMS:
                if arm in arms:
                    row = arms[arm]
                    row = row["port"] if "port" in row else row
                    first = fixed.setdefault((scenario, arm), {
                        "row": row, "equal": True, "max_rel": 0.0})
                    ok, rel = _same_row(row, first["row"],
                                        mix_metrics(study, scenario))
                    first["equal"] &= ok
                    first["max_rel"] = max(first["max_rel"], rel)
    keys = list(rows)
    for test in ("welch", "bf"):
        for key, p in zip(keys, holm([rows[k][f"{test}_p"] for k in keys])):
            rows[key][f"{test}_holm"] = p
    for key in keys:
        res = rows[key]
        res["reject"] = min(res["welch_holm"], res["bf_holm"]) < ALPHA
        log(f"compare {study} {'/'.join(key)} [{tset} episodes="
            f"{a['budget']['episodes']}] {a['side']}/{a['device']} vs "
            f"{b['side']}/{b['device']}: n={res['n']} mean={res['mean']} "
            f"std={res['std']} welch_p={res['welch_p']} bf_p={res['bf_p']} "
            f"welch_holm={res['welch_holm']} bf_holm={res['bf_holm']} "
            f"sd_ratio={res['sd_ratio']} ci95={res['sd_ratio_ci95']} "
            f"above_kube={res.get('above_kube')} "
            f"reject={res['reject']} (alpha {ALPHA}, Holm over "
            f"{len(keys)} rows)")
    n_fixed = sum(v["equal"] for v in fixed.values())
    log(f"compare {study} fixed arms {FIXED_ARMS} [{tset}]: {n_fixed} of "
        f"{len(fixed)} cells equal trial by trial in every draw of both "
        f"sides, max_rel={max(v['max_rel'] for v in fixed.values())}")
    for key, v in fixed.items():
        v.pop("row")
        if not v["equal"]:
            log(f"  fixed cell {'/'.join(key)} differs: max_rel="
                f"{v['max_rel']}")
    n_rej = sum(r["reject"] for r in rows.values())
    log(f"compare {study} [{tset}]: {n_rej} of {len(rows)} rows rejected "
        f"after Holm at alpha {ALPHA}")
    out = {"a": a.get("spec"), "b": b.get("spec"), "study": study,
           "trials": tset, "alpha": ALPHA,
           "rows": {"/".join(k): v for k, v in rows.items()},
           "fixed": {"/".join(k): v for k, v in fixed.items()},
           "rejected": n_rej}
    if a["side"] == b["side"] == "port":
        out["actions"] = _compare_mix_runs(a, b, log)
    return out


def _compare_mix_runs(a: dict, b: dict, log) -> dict:
    """Two port runs of the same draws: per draw and trained policy, the
    actions up to the first near tie, and its cells' trials."""
    rows_b = {r["draw"]: r for r in b["per_draw"]}
    per = {}
    for ra in a["per_draw"]:
        rb = rows_b.get(ra["draw"])
        if rb is None:
            continue
        for name, pa in ra["policies"].items():
            m = _action_match(pa, rb["policies"][name])
            same, rel = True, 0.0
            for scenario, arms in ra["rows"].items():
                if name in arms:
                    ok, r = _same_row(arms[name], rb["rows"][scenario][name],
                                      mix_metrics(a["study"], scenario))
                    same, rel = same and ok, max(rel, r)
            m.update(trials_identical=same, trials_max_rel=rel,
                     train_seconds=[pa["train_seconds"],
                                    rb["policies"][name]["train_seconds"]])
            per.setdefault(name, {})[ra["draw"]] = m
    for name, rows in per.items():
        secs = np.asarray([m["train_seconds"] for m in rows.values()])
        log(f"paired runs {name}: draws={len(rows)} equal_to_first_near_tie="
            f"{sum(m['equal_to_first_near_tie'] for m in rows.values())} "
            f"identical={sum(m['identical'] for m in rows.values())} "
            f"trials_identical="
            f"{sum(m['trials_identical'] for m in rows.values())} "
            f"train_seconds_mean a={secs[:, 0].mean()} b={secs[:, 1].mean()}")
        for d, m in rows.items():
            if not m["identical"]:
                log(f"  draw {d} {name}: first_diff_step="
                    f"{m['first_diff_step']} first_near_tie="
                    f"{m['first_near_tie']} gaps_at_first_diff="
                    f"{m['gaps_at_first_diff']} trials_identical="
                    f"{m['trials_identical']} trials_max_rel="
                    f"{m['trials_max_rel']}")
    return per


def _mix_paired_lines(study: str, row: dict) -> list:
    """A paired draw's lines: each policy's first parting from the
    reference and its first near tie, and how many of its cells' trials
    equal the reference's."""
    lines = []
    for name, pol in row["policies"].items():
        n_same, n = 0, 0
        for scenario, arms in row["rows"].items():
            if name in arms:
                n += 1
                n_same += _same_row(arms[name]["port"],
                                    arms[name]["reference"],
                                    mix_metrics(study, scenario))[0]
        lines.append(f"paired {name}: first_diff={pol['first_diff']} "
                     f"first_near_tie={pol['first_near_tie']} "
                     f"first_gate_flip={pol['first_gate_flip']} "
                     f"gate_flip_pre={pol['gate_flip_pre']} "
                     f"first_bootstrap_near_tie="
                     f"{pol['first_bootstrap_near_tie']} bootstrap_gap="
                     f"{pol['bootstrap_gap']} last_event_before_part="
                     f"{pol['last_event_before_part']} params_part_step="
                     f"{pol['params_part_step']} pod_steps="
                     f"{pol['pod_steps']} params_max_abs_diff="
                     f"{pol['params_max_abs_diff']} cells_equal={n_same}/{n}")
    return lines


# ---------------------------------------------------------------------------
# running and comparing
# ---------------------------------------------------------------------------

def budget_of(study: str) -> dict:
    if study in MIX_POLICIES:
        return dict(MIX)
    return dict(TABLES if study == "tables" else BASELINES)


def run_mix(side: str, study: str, draws: int, first: int, device: str,
            trials: str, budget: dict, log=print) -> dict:
    """Draws ``first .. first + draws - 1`` of one arm of a scenario
    study; the JSON's contents."""
    tset = trial_set(trials, budget["trials"])
    tag = f"[{tset} episodes={budget['episodes']}]"
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    runner = _MixRun(side, study, budget, device, trials)
    out = {"side": side, "study": study, "trials": tset, "validation": None,
           "device": device, "budget": budget, "first": first,
           "per_draw": []}
    if torch.device(device).type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(0)
    t_all = time.perf_counter()
    for d in range(first, first + draws):
        t0 = time.perf_counter()
        row = runner.draw(d)
        secs = time.perf_counter() - t0
        out["per_draw"].append(dict(draw=d, seconds=secs, **row))
        train_s = {k: v["train_seconds"] for k, v in row["policies"].items()}
        log(f"{side} {study} draw {d} {tag} seconds={secs} "
            f"train_seconds={train_s}")
        for name in row["policies"]:
            cpu = {sc: float(np.mean((arms[name]["port"] if side == "paired"
                                      else arms[name])["avg_cpu"]))
                   for sc, arms in row["rows"].items() if name in arms}
            log(f"  {name} avg_cpu {tag}: " + " ".join(
                f"{k}={v}" for k, v in cpu.items()))
        if side == "paired":
            for line in _mix_paired_lines(study, row):
                log(f"  {line} {tag}")
    out["seconds"] = time.perf_counter() - t_all
    return out


def run(side: str, study: str = "tables", draws: int = 1, first: int = 0,
        device: str = "cpu", trials: str = "reference", budget=None,
        log=print) -> dict:
    """Draws ``first .. first + draws - 1`` of one arm; the JSON's
    contents."""
    budget = budget or budget_of(study)
    if side != "port" and (device != "cpu" or trials != "reference"):
        raise SystemExit(f"--side {side} runs on the CPU, on the "
                         f"reference's trials")
    if study in MIX_POLICIES:
        return run_mix(side, study, draws, first, device, trials, budget, log)
    tset = trial_set(trials, budget["trials"])
    if side == "reference":
        ref = _Reference(budget)
        one = lambda d: reference_draw(d, study, budget, ref)  # noqa: E731
    elif side == "paired":
        ref = _Reference(budget)
        recorder = _ReferenceActions(ref)
        one = lambda d: paired_draw(d, study, budget, ref,  # noqa: E731
                                    recorder)
    else:
        port = _Port(budget, trials, device)
        if port.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
        one = lambda d: port_draw(d, study, budget, port)  # noqa: E731
    out = {"side": side, "study": study, "trials": tset,
           "validation": validation_set(trials, budget),
           "device": device, "budget": budget, "first": first,
           "per_draw": []}
    if side == "port" and device == "cuda":
        out["device_name"] = torch.cuda.get_device_name(0)
    t_all = time.perf_counter()
    for d in range(first, first + draws):
        t0 = time.perf_counter()
        row = one(d)
        secs = time.perf_counter() - t0
        out["per_draw"].append({"draw": d, "seconds": secs,
                                "schedulers": row})
        means = {k: (v["mean"] if "mean" in v else v["port"]["mean"])
                 for k, v in row.items()}
        log(f"{side} draw {d} [{tset}] seconds={secs} "
            + " ".join(f"{k}={v}" for k, v in means.items()))
        if side == "paired":
            for k, v in row.items():
                if k != "default":
                    log(f"  paired {k} [{tset}]: " + _paired_line(v))
    out["seconds"] = time.perf_counter() - t_all
    for name in STUDIES[study]:
        vals = np.asarray(_means(out, name))
        log(f"{side} {name} [{tset}]: n={len(vals)} mean={vals.mean()} "
            f"min={vals.min()} max={vals.max()} "
            f"std={vals.std(ddof=1) if len(vals) > 1 else 0.0}")
    return out


def _paired_line(v: dict) -> str:
    r, p = v["reference"], v["port"]
    same = (r["exp_pods"] == p["exp_pods"]
            and np.allclose(p["metric"], r["metric"], rtol=METRIC_RTOL, atol=0))
    return (f"selected ref={r['selected']} port={p['selected']} "
            f"val ref={r['val']} port={p['val']} mean ref={r['mean']} "
            f"port={p['mean']} trials_equal={same} "
            + (f"first_diff={v['first_diff']} first_near_tie="
               f"{v['first_near_tie']} single_seed={v.get('single_seed')}"
               if "first_diff" in v else
               f"params_max_abs_diff={max(v['params_max_abs_diff'])}"))


def _means(out: dict, name: str, side: str = "port"):
    rows = [p["schedulers"][name] for p in out["per_draw"]]
    return [r[side]["mean"] if "reference" in r else r["mean"] for r in rows]


def load(spec: str) -> dict:
    """One arm's JSON, or the shards of one arm joined (comma-separated)."""
    parts = [json.loads(pathlib.Path(p).read_text())
             for p in spec.split(",")]
    head = dict(parts[0])
    for key in ("side", "study", "trials", "validation", "device"):
        if any(p[key] != head[key] for p in parts):
            raise SystemExit(f"{spec}: shards differ in {key}")
    head["per_draw"] = sorted((r for p in parts for r in p["per_draw"]),
                              key=lambda r: r["draw"])
    draws = [r["draw"] for r in head["per_draw"]]
    if len(set(draws)) != len(draws):
        raise SystemExit(f"{spec}: a draw appears twice")
    return head


def compare_samples(a, b, seed: int = 0) -> dict:
    """Welch's t-test, Brown-Forsythe, and the ratio of standard deviations
    (a over b) with a bootstrap 95% interval; decisions at ``ALPHA``."""
    from scipy import stats

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if np.ptp(a) == 0.0 and np.ptp(b) == 0.0:     # kube: the same trials
        p_t = 1.0 if abs(a[0] - b[0]) <= METRIC_RTOL * abs(b[0]) else 0.0
        return {"n": [len(a), len(b)], "mean": [a[0], b[0]],
                "std": [0.0, 0.0], "welch_p": p_t, "bf_p": 1.0,
                "sd_ratio": None, "sd_ratio_ci95": None,
                "means_differ": p_t < ALPHA, "spreads_differ": False}
    sa, sb = a.std(ddof=1), b.std(ddof=1)
    p_t = float(stats.ttest_ind(a, b, equal_var=False).pvalue)
    p_bf = float(stats.levene(a, b, center="median").pvalue)
    rng = np.random.default_rng(seed)
    ia = rng.integers(0, len(a), (BOOTSTRAP, len(a)))
    ib = rng.integers(0, len(b), (BOOTSTRAP, len(b)))
    with np.errstate(divide="ignore", invalid="ignore"):
        boot = a[ia].std(axis=1, ddof=1) / b[ib].std(axis=1, ddof=1)
    finite = boot[np.isfinite(boot)]
    lo, hi = (np.percentile(finite, [2.5, 97.5]) if finite.size
              else (float("nan"), float("nan")))
    return {"n": [len(a), len(b)], "mean": [float(a.mean()), float(b.mean())],
            "std": [float(sa), float(sb)], "welch_p": p_t, "bf_p": p_bf,
            "sd_ratio": float(sa / sb) if sb > 0 else float("inf"),
            "sd_ratio_ci95": [float(lo), float(hi)],
            "means_differ": p_t < ALPHA, "spreads_differ": p_bf < ALPHA}


def _action_match(ra: dict, rb: dict):
    """Two port runs of one learner draw: (equal up to the first near
    tie of either, the first differing pod step)."""
    xa, xb = ra.get("actions"), rb.get("actions")
    if xa is None or xb is None:
        return None
    ties = [t for t in (ra["first_near_tie"], rb["first_near_tie"])
            if t is not None]
    stop = min(ties) if ties else len(xa)
    diff = next((i for i, (p, q) in enumerate(zip(xa, xb)) if p != q), None)
    gaps = None
    if diff is not None and "min_gaps" in ra and "min_gaps" in rb:
        gaps = [ra["min_gaps"][diff], rb["min_gaps"][diff]]
    return {"equal_to_first_near_tie": diff is None or diff >= stop,
            "first_near_tie": min(ties) if ties else None,
            "first_diff_step": diff, "gaps_at_first_diff": gaps,
            "identical": diff is None and len(xa) == len(xb)}


def compare(spec_a: str, spec_b: str, log=print) -> dict:
    a, b = load(spec_a), load(spec_b)
    if a["study"] != b["study"]:
        raise SystemExit(f"refused: {spec_a} is study {a['study']}, {spec_b} "
                         f"study {b['study']}; compare runs of one study")
    for key in ("trials", "validation"):
        if a[key] != b[key]:
            raise SystemExit(
                f"refused: {spec_a} was scored on {key} {a[key]}, {spec_b} "
                f"on {b[key]}; compare runs scored on the same {key}")
    if a["study"] in MIX_POLICIES:
        if a["budget"] != b["budget"]:
            raise SystemExit(f"refused: {spec_a} ran at {a['budget']}, "
                             f"{spec_b} at {b['budget']}")
        a["spec"], b["spec"] = spec_a, spec_b
        return compare_mix(a, b, log)
    tset = a["trials"]
    out = {"a": spec_a, "b": spec_b, "trials": tset, "alpha": ALPHA,
           "schedulers": {}}
    for name in STUDIES[a["study"]]:
        res = compare_samples(_means(a, name), _means(b, name))
        out["schedulers"][name] = res
        log(f"compare {name} [{tset}] {a['side']}/{a['device']} vs "
            f"{b['side']}/{b['device']}: n={res['n']} mean={res['mean']} "
            f"std={res['std']} welch_p={res['welch_p']} "
            f"bf_p={res['bf_p']} sd_ratio={res['sd_ratio']} "
            f"ci95={res['sd_ratio_ci95']} means_differ={res['means_differ']}"
            f" spreads_differ={res['spreads_differ']} (alpha {ALPHA})")
    rows_b = {r["draw"]: r for r in b["per_draw"]}
    shared = [(r, rows_b[r["draw"]]) for r in a["per_draw"]
              if r["draw"] in rows_b]
    if a["side"] == b["side"] == "port" and shared:
        per = {}
        for ra, rb in shared:
            for name, sa in ra["schedulers"].items():
                m = _action_match(sa, rb["schedulers"][name])
                if m is None:
                    continue
                same = sa["exp_pods"] == rb["schedulers"][name]["exp_pods"]
                rel = float(np.max(np.abs(
                    np.asarray(sa["metric"]) / np.asarray(
                        rb["schedulers"][name]["metric"]) - 1.0)))
                m.update(trials_exp_pods_equal=same, trials_max_rel=rel,
                         train_seconds=[sa["train_seconds"],
                                        rb["schedulers"][name][
                                            "train_seconds"]])
                per.setdefault(name, {})[ra["draw"]] = m
        for name, rows in per.items():
            n_eq = sum(m["equal_to_first_near_tie"] for m in rows.values())
            n_id = sum(m["identical"] for m in rows.values())
            secs = np.asarray([m["train_seconds"] for m in rows.values()])
            log(f"paired runs {name}: draws={len(rows)} "
                f"equal_to_first_near_tie={n_eq} identical={n_id} "
                f"train_seconds_mean a={secs[:, 0].mean()} "
                f"b={secs[:, 1].mean()}")
            for d, m in rows.items():
                if not m["identical"]:
                    log(f"  draw {d} {name}: first_diff_step="
                        f"{m['first_diff_step']} first_near_tie="
                        f"{m['first_near_tie']} gaps_at_first_diff="
                        f"{m['gaps_at_first_diff']} trials_exp_pods_equal="
                        f"{m['trials_exp_pods_equal']} trials_max_rel="
                        f"{m['trials_max_rel']}")
        out["actions"] = per
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--side", choices=("reference", "paired", "port"))
    ap.add_argument("--study", choices=tuple(STUDIES), default="tables")
    ap.add_argument("--draws", type=int, default=None,
                    help="32; a scenario study's MIX_DRAWS")
    ap.add_argument("--first", type=int, default=0)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--trials", choices=("reference", "port"),
                    default="reference")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--json", default=None, help="write the numbers here")
    args = ap.parse_args(argv)
    if args.compare:
        out = compare(*args.compare)
    elif args.side:
        draws = (args.draws if args.draws is not None
                 else MIX_DRAWS.get(args.study, 32))
        out = run(args.side, args.study, draws, args.first, args.device,
                  args.trials)
    else:
        ap.error("give --side or --compare")
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
