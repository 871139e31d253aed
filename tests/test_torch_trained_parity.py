"""The whole of ``train.engine.train_and_select`` on the port against the
reference on the reference's own draws, and ``scripts/trained_spread.py``.

One draw of SDQN at the preset's widths (16 envs, batch 256, 50 pods an
episode) cut to ``EPISODES`` episodes, 2 candidate seeds and 12
validation bursts: the port trains on the reference's draws
(``seeded_train_draws``), validates on the reference's bursts
(``fixed_trial_keys(5000, 12)``) and is scored on its Table-9 trials
(``fixed_trial_keys(100, 5)``), all rebuilt by ``tests/torch_parity.py``.
Tolerances, as ``tests/test_torch_train.py``'s: actions identical with
every greedy choice's two best feasible Q values more than ``TIE_TOL``
apart (asserted, so that an identical action is not luck), the same
selected seed, each validation metric within 1e-5, Table 9's experiment
pods identical and its metrics within 1e-5 relative.
"""
import ast
import dataclasses
import json
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.core import presets as jpresets, schedulers as jsched
from repro.core import types as jtypes
from repro.eval import engine as jeval
from repro.train import engine as jengine
from repro_torch.core import presets as tpresets, schedulers as tsched
from repro_torch.core import types as ttypes
from repro_torch.core.draws import ArrayDraws
from repro_torch.eval import engine as teval
from repro_torch.train import engine as tengine
from test_torch_train import _record_port, _record_reference
from torch_parity import reference_trial_draws, seeded_train_draws

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import trained_spread as ts  # noqa: E402

EPISODES, SEEDS, VAL_TRIALS = 3, 2, 12
METRIC_RTOL = 1e-5
VAL_TOL = 1e-5


class _Metrics:
    """The per-candidate validation metrics ``select_best`` gets."""

    def __init__(self, module, monkeypatch):
        orig = module.select_best

        def spy(stacked, metrics):
            self.got = np.asarray(metrics, np.float64)
            return orig(stacked, metrics)

        monkeypatch.setattr(module, "select_best", spy)


def test_train_and_select_matches_reference_on_its_draws(monkeypatch):
    cfg_j, tcfg_j = jtypes.paper_cluster(), jtypes.training_cluster()
    cfg_t, tcfg_t = ttypes.paper_cluster(), ttypes.training_cluster()
    jrl = dataclasses.replace(jpresets.SDQN_PRESET, episodes=EPISODES)
    trl = dataclasses.replace(tpresets.SDQN_PRESET, episodes=EPISODES)
    key = jax.random.PRNGKey(3)

    seen = _record_reference(monkeypatch)
    jval = _Metrics(jengine, monkeypatch)
    want_p, want_m = jengine.train_and_select(key, tcfg_j, cfg_j, jrl,
                                              n_seeds=SEEDS,
                                              val_trials=VAL_TRIALS)
    names = {}
    draws = seeded_train_draws(key, tcfg_j, jrl, SEEDS, names=names)
    actions = {names[k]: a for k, a in seen}
    assert len(actions) == (SEEDS * jrl.n_envs * jrl.episodes
                            * jrl.pods_per_episode)

    got_steps = _record_port(monkeypatch)    # asserts no greedy near tie
    tval = _Metrics(tengine, monkeypatch)
    val = reference_trial_draws(jeval.fixed_trial_keys(5000, VAL_TRIALS),
                                cfg_j, 50)
    got_p, got_m = tengine.train_and_select(
        ArrayDraws(**draws, device="cpu"), tcfg_t, cfg_t, trl, n_seeds=SEEDS,
        val_trials=VAL_TRIALS, val_draws=ArrayDraws(**val, device="cpu"),
        device="cpu")
    assert len(got_steps) == trl.episodes * trl.pods_per_episode
    for i, a in enumerate(got_steps):
        ep, t = divmod(i, trl.pods_per_episode)
        want = [[actions[(s, ep, t, e)] for e in range(trl.n_envs)]
                for s in range(SEEDS)]
        assert a.tolist() == want, (ep, t)

    np.testing.assert_allclose(tval.got, jval.got, rtol=0, atol=VAL_TOL)
    assert int(np.argmin(tval.got)) == int(np.argmin(jval.got))
    assert abs(np.diff(jval.got)[0]) > VAL_TOL     # a selection, not a tie
    assert abs(got_m - want_m) <= VAL_TOL

    keys = jeval.fixed_trial_keys(100, 5)
    want = jeval.make_batch_episode(
        cfg_j, jsched.make_sdqn_selector(want_p, cfg_j), 50)(keys)
    got = teval.make_batch_episode(
        cfg_t, tsched.make_sdqn_selector(got_p, cfg_t), 50, device="cpu")(
            ArrayDraws(**reference_trial_draws(keys, cfg_j, 50), device="cpu"))
    np.testing.assert_array_equal(got.exp_pods.numpy(),
                                  np.asarray(want.exp_pods))
    np.testing.assert_allclose(got.metric.numpy(), np.asarray(want.metric),
                               rtol=METRIC_RTOL)


def test_port_follows_reference_train_over_a_whole_paired_draw(
        monkeypatch):
    """The one paired draw of the 32-draw study (PERF.md section 7) whose
    actions left the reference's with no near tie first: SDQN-n, draw 8,
    candidate seed 1, 20 episodes at the preset's widths.  The port left
    the reference's ``train_seeds`` (its seed batch, one vmapped program)
    at episode 14, step 3, env 5, where ``train_seeds``' own Q values had
    moved up to 2e-2 from those of ``train(fold_in(key, 1))``, which it is
    documented to equal.  Against ``train`` itself the port keeps every
    action of the 16,000, with no near tie, and its params within
    ``PARAM_TOL``."""
    from repro.core import train_rl as jtrain
    from repro_torch.core import train_rl as ttrain
    from test_torch_train import PARAM_TOL, _close_trees
    from torch_parity import _np, reference_train_draws

    jrl = dataclasses.replace(jpresets.SDQN_N_PRESET, episodes=20)
    trl = dataclasses.replace(tpresets.SDQN_N_PRESET, episodes=20)
    cfg = jtypes.training_cluster()
    key = jax.random.fold_in(jax.random.PRNGKey(1000 + 8), 1)
    seen = _record_reference(monkeypatch)
    want, _ = jax.jit(lambda k: jtrain.train(k, cfg, jrl))(key)
    draws, names = reference_train_draws(key, cfg, jrl)
    actions = {names[k]: a for k, a in seen}
    got_steps = _record_port(monkeypatch)    # asserts no greedy near tie
    got, _ = ttrain.train(ArrayDraws(**draws, device="cpu"),
                          ttypes.training_cluster(), trl, device="cpu")
    assert len(got_steps) == trl.episodes * trl.pods_per_episode
    for i, a in enumerate(got_steps):
        ep, t = divmod(i, trl.pods_per_episode)
        assert a[0].tolist() == [actions[(ep, t, e)]
                                 for e in range(trl.n_envs)], (ep, t)
    _close_trees(got, _np(want), PARAM_TOL)


# ---------------------------------------------------------------------------
# scripts/trained_spread.py
# ---------------------------------------------------------------------------

TINY = dict(ts.TABLES, episodes=1, trials=2, val_trials=2)


def test_port_arm_on_reference_trials_gives_reference_kube():
    """The port arm's trials are the reference's: kube's experiment pods
    and placements exactly, its metrics within 1e-6 relative (float32
    sums in another order)."""
    port = ts._Port(dict(ts.TABLES), "reference", "cpu")
    got = port.score(tsched.make_kube_selector(port.cfg))
    cfg = jtypes.paper_cluster()
    want = jeval.make_batch_episode(cfg, jsched.make_kube_selector(cfg), 50)(
        jeval.fixed_trial_keys(100, ts.TABLES["trials"]))
    assert got["exp_pods"] == np.asarray(want.exp_pods).tolist()
    np.testing.assert_allclose(got["metric"], np.asarray(want.metric),
                               rtol=1e-6)
    assert got["mean"] == pytest.approx(float(np.mean(np.asarray(
        want.metric, np.float64))), rel=1e-6)


def test_port_arm_imports_neither_jax_nor_reference():
    """No module-level import of the script reaches JAX or the reference,
    and the port arm on the port's trials runs with both made
    unimportable."""
    tree = ast.parse((REPO / "scripts" / "trained_spread.py").read_text())
    for node in tree.body:
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), name
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'): sys.modules[m] = None\n"
            f"sys.path.insert(0, {str(REPO / 'scripts')!r})\n"
            "import trained_spread as ts\n"
            f"out = ts.run('port', draws=1, trials='port', budget={TINY!r},"
            " log=lambda s: None)\n"
            "print(out['trials'], out['per_draw'][0]['schedulers']"
            "['sdqn']['mean'])\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    trials, mean = res.stdout.split()
    assert trials == "port:100x2" and np.isfinite(float(mean))


def test_paired_arm_is_clean_at_a_cut_budget():
    """The paired arm on one draw at one episode: both learners act alike
    with no near tie, select the same seed and give the same trials."""
    out = ts.run("paired", draws=1, budget=TINY, log=lambda s: None)
    assert out["trials"] == "reference:100x2"
    assert out["validation"] == "reference:5000x2"
    for name in ("sdqn", "sdqn_n"):
        row = out["per_draw"][0]["schedulers"][name]
        ref, port = row["reference"], row["port"]
        assert row["first_diff"] is None and row["first_near_tie"] is None
        assert ref["selected"] == port["selected"]
        np.testing.assert_allclose(port["val"], ref["val"], atol=VAL_TOL)
        assert port["exp_pods"] == ref["exp_pods"]
        np.testing.assert_allclose(port["metric"], ref["metric"],
                                   rtol=METRIC_RTOL)


def _arm(path, side, trials, means, device="cpu"):
    per = [{"draw": d, "seconds": 1.0, "schedulers": {
        name: {"mean": m, "metric": [m], "exp_pods": [[0, 0, 0, 0]]}
        for name, m in zip(ts.STUDIES["tables"], row)}}
        for d, row in enumerate(means)]
    path.write_text(json.dumps({
        "side": side, "study": "tables", "trials": trials,
        "validation": trials.split(":")[0] + ":5000x12", "device": device,
        "per_draw": per}))
    return str(path)


def _samples(seed, sd_a, sd_b, n=100):
    rng = np.random.default_rng(seed)
    a, b = rng.normal(30.0, sd_a, n), rng.normal(30.0, sd_b, n)
    return ([(30.3, x, x) for x in a], [(30.3, x, x) for x in b])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compare_decides_spread_and_means(tmp_path, seed):
    """At ``ALPHA`` = 0.01 and 100 draws a side: samples with a 4x
    variance ratio (sd 2 against 1) are told apart by Brown-Forsythe, with
    the ratio's bootstrap interval above 1; two samples of one
    distribution are not, and kube (the same trials every draw) compares
    equal.  (At 32 draws a side Brown-Forsythe detects this ratio 73% of
    the time, by simulation; at 100, all but never misses it.)"""
    a, b = _samples(seed, 2.0, 1.0)
    out = ts.compare(_arm(tmp_path / "a.json", "reference", "reference:100x5",
                          a),
                     _arm(tmp_path / "b.json", "port", "reference:100x5", b),
                     log=lambda s: None)
    res = out["schedulers"]["sdqn"]
    assert res["spreads_differ"] and res["bf_p"] < ts.ALPHA
    assert res["sd_ratio_ci95"][0] > 1.0
    assert out["schedulers"]["default"]["welch_p"] == 1.0
    a, b = _samples(100 + seed, 1.0, 1.0)
    out = ts.compare(_arm(tmp_path / "c.json", "reference", "reference:100x5",
                          a),
                     _arm(tmp_path / "d.json", "port", "reference:100x5", b),
                     log=lambda s: None)
    res = out["schedulers"]["sdqn"]
    assert not res["spreads_differ"] and not res["means_differ"]
    assert res["sd_ratio_ci95"][0] < 1.0 < res["sd_ratio_ci95"][1]


def test_compare_refuses_different_trials(tmp_path):
    a, b = _samples(0, 1.0, 1.0, n=4)
    with pytest.raises(SystemExit, match="refused"):
        ts.compare(_arm(tmp_path / "a.json", "reference", "reference:100x5",
                        a),
                   _arm(tmp_path / "b.json", "port", "port:100x5", b),
                   log=lambda s: None)
    first = _arm(tmp_path / "c.json", "port", "port:100x5", a[:2])
    rest = json.loads(pathlib.Path(_arm(tmp_path / "d.json", "port",
                                        "port:100x5", a)).read_text())
    rest["per_draw"] = rest["per_draw"][2:]
    (tmp_path / "d.json").write_text(json.dumps(rest))
    joined = ts.load(f"{first},{tmp_path / 'd.json'}")
    assert [r["draw"] for r in joined["per_draw"]] == [0, 1, 2, 3]
    with pytest.raises(SystemExit, match="twice"):
        ts.load(f"{first},{first}")


@pytest.mark.parametrize("case", ["identical", "after_tie", "before_tie"])
def test_compare_pairs_two_port_runs_up_to_the_first_near_tie(tmp_path,
                                                              case):
    """Two port runs of the same draws (the card's and the CPU's): a run
    whose actions first differ at or after either run's first near tie
    counts as equal to it, one that differs before counts as not, and the
    gaps at the first difference are reported."""
    steps = ["a", "b", "c", "d"]
    other = {"identical": steps, "after_tie": ["a", "b", "x", "d"],
             "before_tie": ["a", "x", "c", "d"]}[case]
    paths = []
    for dev, acts in (("cuda", steps), ("cpu", other)):
        row = {"mean": 30.0, "metric": [30.0], "exp_pods": [[1, 2, 3, 4]],
               "actions": acts, "min_gaps": [0.1, 0.2, 3e-6, 0.4],
               "first_near_tie": 2, "train_seconds": 1.0}
        per = [{"draw": 0, "seconds": 1.0, "schedulers": {
            "default": {"mean": 30.0, "metric": [30.0],
                        "exp_pods": [[1, 2, 3, 4]]},
            "sdqn": row, "sdqn_n": dict(row, actions=steps)}}]
        path = tmp_path / f"{dev}.json"
        path.write_text(json.dumps({
            "side": "port", "study": "tables", "trials": "port:100x5",
            "validation": "port:5000x12", "device": dev, "per_draw": per}))
        paths.append(str(path))
    out = ts.compare(*paths, log=lambda s: None)
    m = out["actions"]["sdqn"][0]
    assert m["identical"] == (case == "identical")
    assert m["equal_to_first_near_tie"] == (case != "before_tie")
    assert m["first_diff_step"] == {"identical": None, "after_tie": 2,
                                    "before_tie": 1}[case]
    if case == "before_tie":
        assert m["gaps_at_first_diff"] == [0.2, 0.2]
    assert out["actions"]["sdqn_n"][0]["identical"]
