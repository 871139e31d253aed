"""The paper's LSTM and Transformer baselines (Tables 6/7, 11/12) on the
port (``repro_torch.core.baselines``, ``train_rl.train_supervised_scorer``,
``schedulers.make_neural_selector``) against the JAX reference, and the
two scripts that print the paper's tables at a cut budget.

Stateless arithmetic (the two scorers, one regression step with Adam) is
held within 1e-6 on params the reference drew, carried over with
``convert.baseline_params_from_numpy``.  A short supervised training runs
on the reference's own draws (``reference_supervised_draws`` rebuilds its
resets and kube tie-break rows from its keys, as
``repro/core/train_rl.py:train_supervised_scorer`` derives them): params
within 1e-5.  A Table-11 trial set on reference-trained params gives the
reference's experiment pods exactly and its metrics within 1e-5 relative,
every greedy choice's two best scores more than 1e-5 apart (asserted).
"""
import ast
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import schedulers as jsched, train_rl as jtrain
from repro.core import types as jtypes
from repro.eval import engine as jeval
from repro.optim import adam_update
from repro_torch import convert
from repro_torch.core import baselines as tbase, schedulers as tsched
from repro_torch.core import train_rl as ttrain, types as ttypes
from repro_torch.core.draws import ArrayDraws
from repro_torch.eval import engine as teval
from repro_torch.optim import adam_init
from test_torch_train import PARAM_TOL, _close_trees, _record_port
from torch_parity import _np, reference_supervised_draws, reference_trial_draws

TOL = dict(rtol=1e-6, atol=1e-6)
REPO = pathlib.Path(__file__).resolve().parents[1]
KINDS = {"lstm": (jbase.init_lstm, jbase.lstm_score, tbase.init_lstm,
                  tbase.lstm_score),
         "transformer": (jbase.init_transformer, jbase.transformer_score,
                         tbase.init_transformer, tbase.transformer_score)}
SUP = dict(episodes=2, pods_per_episode=12, n_envs=8)


def _port(params, kind):
    return convert.baseline_params_from_numpy(_np(params), kind, device="cpu")


@pytest.mark.parametrize("kind", list(KINDS))
def test_scorers_match_reference(kind):
    jinit, jscore, tinit, _ = KINDS[kind]
    params = jinit(jax.random.PRNGKey(1))
    feats = np.random.default_rng(0).uniform(-1, 2, (3, 7, 6)).astype(
        np.float32)
    np.testing.assert_allclose(
        KINDS[kind][3](_port(params, kind), torch.tensor(feats)).numpy(),
        np.asarray(jscore(params, jnp.asarray(feats))), **TOL)
    mine = tinit(torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: tuple(np.shape(v)) for k, v in params.items()}
    with pytest.raises(ValueError, match="keys"):
        convert.baseline_params_from_numpy({"wx": 0}, kind, device="cpu")


@pytest.mark.parametrize("kind", list(KINDS))
def test_regression_step_matches_reference(kind):
    """One weighted-MSE step: the loss and every updated param and Adam
    moment within 1e-6; the Transformer's ``wq`` / ``wk`` (never reached
    on a length-1 sequence) get zero gradients, so their moments stay 0."""
    jinit, jscore, _, tscore = KINDS[kind]
    params, opt = jbase.init_regression_state(jinit, jax.random.PRNGKey(2))
    rng = np.random.default_rng(1)
    feats = rng.uniform(0, 1.5, (8, 6)).astype(np.float32)
    targets = rng.uniform(-1, 1, 8).astype(np.float32)
    weights = (rng.uniform(size=8) > 0.2).astype(np.float32)

    def loss_fn(p):
        err = jnp.square(jscore(p, feats) - targets)
        return jnp.sum(err * weights) / jnp.maximum(jnp.sum(weights), 1e-9)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    want_p, want_opt, _ = adam_update(params, grads, opt, jbase.ADAM)
    step = tbase.make_regression_trainer(tscore)
    tp = _port(params, kind)
    got_p, got_opt, got_loss = step(tp, adam_init(tp, tbase.ADAM),
                                    torch.tensor(feats),
                                    torch.tensor(targets),
                                    torch.tensor(weights))
    np.testing.assert_allclose(float(got_loss), float(loss), **TOL)
    _close_trees(got_p, _np(want_p), 1e-6)
    _close_trees(got_opt["m"], _np(want_opt["m"]), 1e-6)
    _close_trees(got_opt["v"], _np(want_opt["v"]), 1e-6)
    assert int(got_opt["step"]) == int(want_opt["step"])
    if kind == "transformer":
        for k in ("wq", "wk"):
            assert float(got_opt["m"][k].abs().max()) == 0.0
            np.testing.assert_array_equal(got_p[k].numpy(),
                                          np.asarray(params[k]))


@functools.lru_cache(maxsize=None)
def _reference_supervised(kind):
    jinit, jscore = KINDS[kind][:2]
    cfg = jtypes.training_cluster()
    key = jax.random.PRNGKey(70)
    params = jtrain.train_supervised_scorer(key, cfg, jinit, jscore, **SUP)
    draws = reference_supervised_draws(key, cfg, jinit, SUP["episodes"],
                                       SUP["pods_per_episode"], SUP["n_envs"])
    return _np(params), draws


@pytest.mark.parametrize("kind", list(KINDS))
def test_train_supervised_scorer_matches_reference(kind):
    params, draws = _reference_supervised(kind)
    _, _, tinit, tscore = KINDS[kind]
    got = ttrain.train_supervised_scorer(
        ArrayDraws(**draws, device="cpu"), ttypes.training_cluster(), tinit,
        tscore, device="cpu", **SUP)
    _close_trees(got, params, PARAM_TOL)


@pytest.mark.parametrize("kind", list(KINDS))
def test_table11_trials_on_reference_trained_params(kind, monkeypatch):
    """The neural selector on reference-trained params: the Table-8
    protocol's trials give the reference's experiment pods and metrics."""
    params, _ = _reference_supervised(kind)
    _, jscore, _, tscore = KINDS[kind]
    cfg_j, cfg_t = jtypes.paper_cluster(), ttypes.paper_cluster()
    keys = jeval.fixed_trial_keys(100, 5)
    want = jeval.make_batch_episode(
        cfg_j, jsched.make_neural_selector(params, jscore, cfg_j), 50)(keys)
    seen = _record_port(monkeypatch, tsched)
    got = teval.make_batch_episode(
        cfg_t, tsched.make_neural_selector(_port(params, kind), tscore, cfg_t),
        50, device="cpu")(ArrayDraws(**reference_trial_draws(keys, cfg_j, 50),
                                     device="cpu"))
    assert len(seen) == 50
    np.testing.assert_array_equal(got.exp_pods.numpy(),
                                  np.asarray(want.exp_pods))
    np.testing.assert_allclose(got.metric.numpy(), np.asarray(want.metric),
                               rtol=1e-5)


def _script(name):
    path = REPO / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, path


@pytest.mark.parametrize("name", ["paper_tables", "scenario_tables"])
def test_scripts_import_neither_jax_nor_reference(name):
    _, path = _script(name)
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        for mod in names:
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), mod


def test_paper_tables_baselines_at_a_cut_budget(capsys):
    """Tables 11/12, Figure 6's claims and the policy-class table end to
    end on the CPU at 1 episode x 2 seeds x 2 trials: the cut is printed,
    every trial places or drops its 50 pods, the paper's means are
    quoted."""
    from benchmarks import paper_tables as jpt

    pt, _ = _script("paper_tables")
    assert pt.PAPER == jpt.PAPER
    out = pt.run_baselines(episodes=1, seeds=2, trials=2, device="cpu",
                           pods=6)
    text = capsys.readouterr().out
    assert "Table 11" in text and "Table 12" in text and "claims" in text
    assert set(out["claims"]) == {"claim1_sdqn_reduces_~10pct",
                                  "claim2_sdqn_n_exceeds_20pct",
                                  "claim3_lstm_tr_no_advantage"}
    for name in ("lstm", "transformer"):
        tb = out["tables"][name]
        for row, dropped in zip(tb["exp_pods"], tb["dropped"]):
            assert sum(row) + dropped == pt.N_PODS, name
    assert set(out["policy_class"]) == {"kube", "mlp", "attention", "mamba"}
    assert np.isfinite(out["literal"]["mean"])


def test_scenario_tables_at_a_cut_budget(capsys):
    """The scenario sweep, the lifecycle rows and the Pareto rows on the
    CPU at 2 training episodes, 1 trial and 6 pods: the cut is printed,
    the chaos scenario has its row with the pods evicted, rescheduled and
    lost (balanced), every row is finite, and the dominance count is the
    script's rule applied to the printed points."""
    st, _ = _script("scenario_tables")
    out = st.run(episodes=2, trials=1, pods=6, device="cpu",
                 names=("paper-burst", "hetero-bigsmall", "train-flaky"),
                 lifecycle_names=("short-job-burst",))
    text = capsys.readouterr().out
    assert "CUT" in text and "train-flaky" in text and "evicted=" in text
    assert set(out["scenarios"]) == {"paper-burst", "hetero-bigsmall",
                                     "train-flaky"}
    for row in out["scenarios"].values():
        assert set(row) == {"kube", "sdqn"}
        assert all(np.isfinite(r["metric_mean"]) for r in row.values())
    for r in out["scenarios"]["train-flaky"].values():
        assert r["evicted_mean"] == pytest.approx(
            r["rescheduled_mean"] + r["lost_mean"])
    pareto = out["pareto"]["short-job-burst"]
    arms = {"kube", "topsis"} | {f"sdqnn_{st._wtag(w)}"
                                 for w in st.PARETO_ENERGY_WEIGHTS}
    assert set(pareto) == arms | {"sdqnn_dominates"}
    assert pareto["sdqnn_dominates"] == sum(
        st.dominates_or_matches(pareto[a], pareto["topsis"])
        for a in arms if a.startswith("sdqnn_"))
    assert "green Pareto frontier" in text
    # the rule is the reference bench's, on points either side of the slack
    from benchmarks import lifecycle_bench as jlb

    rng = np.random.default_rng(0)
    for _ in range(200):
        a, b = ({k: float(v) for k, v in zip(
            ("metric_mean", "energy_wh_mean", "dropped_mean"),
            rng.uniform(0.9, 1.1, 3) * (20.0, 50.0, 1.0))} for _ in range(2))
        assert st.dominates_or_matches(a, b) == jlb._dominates_or_matches(a, b)
    rows = out["lifecycle"]["short-job-burst"]
    assert set(rows) == {"kube", "sdqn", "sdqnn"}
    for r in rows.values():
        for k in ("nodes_active_mean", "energy_wh_mean", "metric_mean",
                  "retired_mean", "moved_mean"):
            assert np.isfinite(r[k]), k
    assert rows["kube"]["moved_mean"] == rows["sdqn"]["moved_mean"] == 0.0
    assert out["train"]["mixture"]["episodes"] == 2
