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

from repro_torch.core import baselines, presets, schedulers  # noqa: E402
from repro_torch.core import train_rl  # noqa: E402
from repro_torch.core.draws import (ArrayDraws, TorchDraws,  # noqa: E402
                                    record_supervised_draws,
                                    record_train_draws, record_trial_draws)
from repro_torch.core.types import paper_cluster, training_cluster  # noqa: E402
from repro_torch.eval import engine as eval_engine  # noqa: E402
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
STUDIES = {"tables": ("default", "sdqn", "sdqn_n"),
           "baselines": ("default", "lstm", "transformer", "literal")}
SEED_BASE = {"sdqn": 0, "sdqn_n": 1000, "scorers": 2000, "literal": 3000}
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


def _load(name: str, path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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

def _recorded_bursts(kind: str, seed: int, trials: int):
    """``trials`` episodes' draws from ``seed`` as numpy arrays: the
    reference's (``fixed_trial_keys(seed, trials)``, rebuilt with the JAX
    package) or recorded from a CPU ``TorchDraws`` seeded ``seed``."""
    if kind == "port":
        return record_trial_draws(TorchDraws(
            torch.Generator().manual_seed(seed), (trials,)), paper_cluster(),
            N_PODS)
    try:
        import jax  # noqa: F401
    except ImportError:
        raise SystemExit("--trials reference rebuilds the reference's trials "
                         "with the JAX package, which does not import here; "
                         "give --trials port") from None
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
# running and comparing
# ---------------------------------------------------------------------------

def budget_of(study: str) -> dict:
    return dict(TABLES if study == "tables" else BASELINES)


def run(side: str, study: str = "tables", draws: int = 1, first: int = 0,
        device: str = "cpu", trials: str = "reference", budget=None,
        log=print) -> dict:
    """Draws ``first .. first + draws - 1`` of one arm; the JSON's
    contents."""
    budget = budget or budget_of(study)
    if side != "port" and (device != "cpu" or trials != "reference"):
        raise SystemExit(f"--side {side} runs on the CPU, on the "
                         f"reference's trials")
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
    lo, hi = np.percentile(boot[np.isfinite(boot)], [2.5, 97.5])
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
        raise SystemExit(f"studies differ: {a['study']} / {b['study']}")
    for key in ("trials", "validation"):
        if a[key] != b[key]:
            raise SystemExit(
                f"refused: {spec_a} was scored on {key} {a[key]}, {spec_b} "
                f"on {b[key]}; compare runs scored on the same {key}")
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
    ap.add_argument("--draws", type=int, default=32)
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
        out = run(args.side, args.study, args.draws, args.first, args.device,
                  args.trials)
    else:
        ap.error("give --side or --compare")
    if args.json:
        pathlib.Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
