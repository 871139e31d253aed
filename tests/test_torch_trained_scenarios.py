"""The scenario studies of ``scripts/trained_spread.py`` (``--study
scenarios | lifecycle | pareto``) against the JAX reference, at a cut.

One whole lifecycle SDQN-n draw (``SDQN_N_LIFECYCLE_PRESET``, its
``energy_weight``, ``train_mixture`` over ``LIFECYCLE_MIX_NAMES`` cut to 4
episodes) trains on the reference's own draws (``reference_mixture_draws``
joined by ``SegmentDraws``) with the reference's actions in every pod
step, its one near tie (1e-5) included, params within 1e-5; scored with the
consolidation pass every 30 s on ``reference:100x3`` (the reference's
``trial_keys(PRNGKey(100), 3)``), each churn scenario's trials equal the
reference's: counts and pods moved exactly, average CPU, active nodes
and energy within ``METRIC_RTOL``.  kube and TOPSIS, which no training
touches, give equal trials on both sides.  ``--compare`` refuses runs of
other studies, trial sets or budgets and Holm-adjusts each test's
p-values over a study's rows; ``record_trial_draws`` records a flaky
scenario's failure trace and re-placement draws, so the port arm's
``port:100x3`` trials replay the live ``TorchDraws`` episode.
"""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import scenarios as tscn
from repro_torch.core import env as tenv, presets as tpresets
from repro_torch.core import schedulers as tsched, train_rl as ttrain
from repro_torch.core.draws import (ArrayDraws, TorchDraws,
                                    record_mixture_draws, record_trial_draws)
from repro_torch.eval import engine as teval

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import trained_spread as ts  # noqa: E402

CUT = dict(episodes=4, trials=3)
CHURN = tpresets.LIFECYCLE_MIX_NAMES
CHAOS = tpresets.CHAOS_MIX_NAMES


@pytest.fixture(scope="module")
def paired():
    """The paired arm of the Pareto study at ``CUT``: kube's and TOPSIS's
    cells on both sides, and the lifecycle SDQN-n of draw 0 (the Pareto
    point of weight 15, the preset's) trained on both; its patches of the
    reference's learner undone after the module."""
    runner = ts._MixRun("paired", "pareto", dict(CUT), "cpu", "reference")
    try:
        yield (runner,) + runner._train("sdqnn_w15", 0)
    finally:
        runner.close()


def test_lifecycle_sdqnn_draw_follows_the_reference(paired):
    """Every pod step's actions as the reference's, through the draw's
    one near tie (pod step 148) too, every ReLU gate of every learner
    step as the reference's, and params within 1e-5 after 4 episodes of
    50 pods on 16 clusters (one segment a churn scenario)."""
    record = paired[3]
    assert record["first_diff"] is None
    assert record["first_near_tie"] == 148
    assert record["first_gate_flip"] is None
    assert record["params_part_step"] is None
    assert record["pod_steps"] == CUT["episodes"] * 50
    assert record["params_max_abs_diff"] <= 1e-5


@pytest.mark.parametrize("scenario", CHURN)
def test_lifecycle_sdqnn_rows_equal_the_reference(paired, scenario):
    """The draw's SDQN-n with the pass on the reference's trials: each
    lifecycle metric trial by trial, pods moved counted on the
    reference's side from its pass."""
    runner, jparams, params, _ = paired
    want = runner.ref.cell(scenario, "sdqnn", True, jparams, count_moved=True)
    got = ts._port_cell(scenario, "sdqnn", True, params,
                        runner.arrays[scenario], "cpu")
    ok, rel = ts._same_row(got, want, ts.mix_metrics("lifecycle", scenario)
                           + ("dropped", "placed"))
    assert ok, (scenario, rel, got, want)
    assert got["exp_pods"] == want["exp_pods"]
    assert want["moved_run_max_rel"] <= ts.METRIC_RTOL


@pytest.mark.parametrize("arm", ts.FIXED_ARMS)
@pytest.mark.parametrize("scenario", CHURN)
def test_fixed_arms_equal_on_both_sides(paired, scenario, arm):
    """kube and TOPSIS on the reference's trials, port against
    reference: every Pareto and lifecycle metric and the final
    experiment pods."""
    got = paired[0].fixed[scenario][arm]
    metrics = (ts.MIX_METRICS["lifecycle"] + ts.MIX_METRICS["pareto"]
               + ("placed",))
    ok, rel = ts._same_row(got["port"], got["reference"], metrics)
    assert ok, (scenario, arm, rel)
    assert got["port"]["exp_pods"] == got["reference"]["exp_pods"]


@pytest.mark.parametrize("scenario", CHAOS)
def test_recorded_flaky_trials_replay_the_live_episode(scenario):
    """``record_trial_draws`` on a flaky scenario records the failure
    trace and each arrival's re-placement tie-break: kube on the recorded
    draws evicts, and equals its run on the live ``TorchDraws``."""
    cfg = tscn.make_env(scenario)
    n = cfg.scenario.n_pods
    arrays = record_trial_draws(TorchDraws(torch.Generator().manual_seed(100),
                                           (3,)), cfg, n)
    assert arrays["failure"].shape == (1, 3, cfg.chaos_cycles, 2,
                                       cfg.n_nodes)
    assert arrays["reschedule"]["tiebreak"].shape == (1, n, 3, cfg.n_nodes)
    run = teval.make_batch_episode(cfg, tsched.make_kube_selector(cfg), n,
                                   device="cpu")
    got = run(ArrayDraws(**arrays, device="cpu"))
    want = run(TorchDraws(torch.Generator().manual_seed(100), (3,)))
    for f in ("exp_pods", "dropped", "evicted", "rescheduled", "lost",
              "metric"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert tenv.has_chaos(cfg) and int(got.evicted.sum()) > 0


def test_recorded_mixture_draws_follow_the_schedule():
    """``record_mixture_draws`` gives one block a ``mixture_schedule``
    segment, each with its scenario's node count, the params once, and
    replay indices below the replay's size so far."""
    rl = ttrain.RLConfig(episodes=5, pods_per_episode=6, n_envs=2,
                         batch_size=8, buffer_capacity=20)
    cfgs = tscn.training_mixture(CHURN)
    blocks = record_mixture_draws(TorchDraws(torch.Generator().manual_seed(0),
                                             (2,)), cfgs, rl, rounds=1,
                                  device="cpu")
    segments = ttrain.mixture_schedule(cfgs, rl.episodes, 1)
    assert [b[0] for b in blocks] == [ep0 for _, ep0, _ in segments]
    assert "params" in blocks[0][1]
    assert all("params" not in b for _, b in blocks[1:])
    size = 0
    for (_, b), (cfg, _, n_eps) in zip(blocks, segments):
        assert b["noise"].shape == (n_eps, 6, 2, cfg.n_nodes)
        for ep in range(n_eps):
            for t in range(6):
                size = min(size + 2, rl.buffer_capacity)
                assert b["replay_idx"][ep, t].max() < size


def test_holm_on_planted_pvalues():
    """Holm's step-down: the i-th smallest of m p-values times (m - i),
    kept monotone, capped at 1, returned in the given order."""
    got = ts.holm([0.01, 0.04, 0.03, 0.005, 0.5])
    np.testing.assert_allclose(got, [0.04, 0.09, 0.09, 0.025, 0.5])
    assert ts.holm([0.2, 0.3]) == [0.4, 0.4]
    assert ts.holm([0.9, 0.001]) == [0.9, 0.002]


def _mix_arm(path, side, study="lifecycle", trials="reference:100x3",
             shift=0.0, budget=None, seed=0):
    """A synthetic scenario-study run: 16 draws, every lifecycle cell on
    every churn scenario; SDQN-n's average CPU on short-job-burst shifted
    by ``shift``."""
    rng = np.random.default_rng(seed)
    per = []
    for d in range(16):
        rows = {}
        for scenario, arm, _ in ts.mix_cells("lifecycle"):
            row = {m: [10.0, 11.0, 12.0] for m in ts.MIX_METRICS["lifecycle"]}
            if arm != "kube":
                row = {m: list(rng.normal(30.0, 1.0, 3))
                       for m in ts.MIX_METRICS["lifecycle"]}
                if arm == "sdqnn" and scenario == "short-job-burst":
                    row["avg_cpu"] = [x + shift for x in row["avg_cpu"]]
            rows.setdefault(scenario, {})[arm] = row
        per.append({"draw": d, "seconds": 1.0, "rows": rows, "policies": {}})
    path.write_text(json.dumps({
        "side": side, "study": study, "trials": trials, "validation": None,
        "device": "cpu", "budget": budget or dict(ts.MIX), "per_draw": per}))
    return str(path)


@pytest.mark.parametrize("what", ["study", "trials", "budget"])
def test_compare_refuses_mismatched_runs(tmp_path, what):
    a = _mix_arm(tmp_path / "a.json", "reference")
    b = _mix_arm(tmp_path / "b.json", "port", **{
        "study": dict(study="pareto"),
        "trials": dict(trials="port:100x3"),
        "budget": dict(budget=dict(ts.MIX, episodes=60))}[what])
    with pytest.raises(SystemExit, match="refused"):
        ts.compare(a, b, log=lambda s: None)


def test_compare_holm_rejects_only_the_planted_row(tmp_path):
    """A mean shift of 3 SD in one of 40 trained rows is the one Holm
    rejection; kube's cells compare equal trial by trial."""
    out = ts.compare(_mix_arm(tmp_path / "a.json", "reference", seed=1),
                     _mix_arm(tmp_path / "b.json", "port", shift=3.0,
                              seed=2), log=lambda s: None)
    assert len(out["rows"]) == 4 * 2 * 5
    rejected = [k for k, v in out["rows"].items() if v["reject"]]
    assert rejected == ["short-job-burst/sdqnn/avg_cpu"]
    res = out["rows"]["short-job-burst/sdqnn/avg_cpu"]
    assert res["welch_holm"] == pytest.approx(
        min(1.0, res["welch_p"] * 40), rel=1e-12)
    assert all(v["equal"] for v in out["fixed"].values())
    assert len(out["fixed"]) == 4


def test_scenario_port_arm_imports_neither_jax_nor_reference():
    """The lifecycle study's port arm on ``port:100x3`` runs with JAX and
    the reference made unimportable."""
    budget = dict(episodes=1, trials=1)
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'): sys.modules[m] = None\n"
            f"sys.path.insert(0, {str(REPO / 'scripts')!r})\n"
            "import trained_spread as ts\n"
            "out = ts.run('port', 'lifecycle', draws=1, trials='port', "
            f"budget={budget!r}, log=lambda s: None)\n"
            "r = out['per_draw'][0]['rows']['short-job-burst']['sdqnn']\n"
            "print(out['trials'], r['avg_cpu'][0], r['moved'][0])\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    trials, cpu, moved = res.stdout.split()
    assert trials == "port:100x1" and np.isfinite(float(cpu))
    assert int(moved) >= 0
