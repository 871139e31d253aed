"""The port's learner and evaluation (``repro_torch.core.train_rl``,
``train.engine``, ``eval.engine``) against the JAX reference on the
reference's own draws.

torch cannot reproduce JAX's threefry streams, so ``reference_train_draws``
and ``reference_trial_draws`` (``tests/torch_parity.py``) rebuild every
draw the reference takes from its key — resets, explore uniforms, noise rows, replay indices,
kube-scheduler tie-breaks — by calling the reference's own ``env.reset``,
``env.sample_pod_table`` and ``jax.random`` under the key derivation of
``repro/core/train_rl.py`` (``_init_carry``, ``_make_episode_fn``) and
``repro/core/env.py`` (``run_episode``), and hands them to the port through
``core.draws.ArrayDraws``.  The reference runs as ``jax.jit(train_rl.train)``
(the unsharded arm; never ``mesh=``), its actions recorded by a
``jax.debug.callback`` around its ``masked_argmax``.

Tolerances: actions identical, and every greedy choice's two best feasible
Q values more than ``TIE_TOL`` = 1e-5 apart (asserted, so that an identical
action is not luck); params within 1e-5 (``PARAM_TOL``, the scoring
tolerance of ``tests/test_kernels.py``: float32 sums reassociate between
XLA and torch); Table 8's experiment pods identical and its metric within
1e-5 relative.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jpol, schedulers as jsched
from repro.core import train_rl as jtrain, types as jtypes
from repro.eval import engine as jeval
from repro.train import engine as jengine
from repro_torch import convert
from repro_torch.core import schedulers as tsched, train_rl as ttrain
from repro_torch.core import types as ttypes
from repro_torch.core.draws import ArrayDraws, TorchDraws
from repro_torch.eval import engine as teval
from repro_torch.train import engine as tengine
from torch_parity import (_key_bytes, _np, reference_train_draws,
                          reference_trial_draws, seeded_train_draws)

PARAM_TOL = 1e-5
TIE_TOL = 1e-5
METRIC_RTOL = 1e-5
SHORT = dict(episodes=2, pods_per_episode=6, n_envs=2, batch_size=8,
             buffer_capacity=16, target_update_every=5)
ARMS = {"mlp": dict(policy="mlp"),
        "mlp-bandit": dict(policy="mlp", bootstrap=False),
        "attention": dict(policy="attention"),
        "mamba": dict(policy="mamba")}


def _record_reference(monkeypatch):
    """Record the reference's (key bytes, action) of every selection."""
    seen = []
    orig = jsched.masked_argmax

    def spy(key, scores, ok, epsilon=0.0):
        a = orig(key, scores, ok, epsilon)
        jax.debug.callback(lambda k, x: seen.append((_key_bytes(k), int(x))),
                           key, a)
        return a

    monkeypatch.setattr(jtrain, "masked_argmax", spy)
    return seen


def _record_port(monkeypatch, module=ttrain):
    """Record the port's actions (one tensor a step) and assert that every
    greedy choice has no near tie."""
    seen = []
    orig = tsched.masked_argmax

    def spy(gen, scores, ok, epsilon=0.0, *, u=None, noise=None):
        a = orig(gen, scores, ok, epsilon, u=u, noise=noise)
        masked = torch.where(ok, scores, torch.full_like(scores, -torch.inf))
        top2 = torch.topk(masked, 2, dim=-1).values
        greedy = torch.isfinite(top2[..., 1])
        if u is not None:
            greedy &= u >= epsilon
        gap = (top2[..., 0] - top2[..., 1])[greedy]
        assert bool(torch.all(gap > TIE_TOL)), f"near tie: {gap.min()}"
        seen.append(a.clone())
        return a

    monkeypatch.setattr(module, "masked_argmax", spy)
    return seen


def _configs(**kw):
    jrl = jtrain.RLConfig(**dict(SHORT, **kw))
    return jrl, ttrain.RLConfig(**dict(SHORT, **kw))


@functools.lru_cache(maxsize=None)
def _reference_run(arm):
    """(reference params, its actions by (ep, t, env), the draws) of one
    arm, compiled and run once per test process."""
    mp = pytest.MonkeyPatch()
    try:
        seen = _record_reference(mp)
        jrl, _ = _configs(**ARMS[arm])
        cfg = jtypes.training_cluster()
        key = jax.random.PRNGKey(3)
        # a fresh wrapper: its trace cannot come from a cache made without
        # the spy
        params, _ = jax.jit(lambda k: jtrain.train(k, cfg, jrl))(key)
        params = _np(params)
    finally:
        mp.undo()
    draws, names = reference_train_draws(key, cfg, jrl)
    actions = {names[k]: a for k, a in seen}
    assert len(actions) == jrl.episodes * jrl.pods_per_episode * jrl.n_envs
    return params, actions, draws


def _close_trees(got, want, tol):
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    for path, w in flat_w:
        g = got
        for p in path:
            g = g[p.key]
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=tol, atol=tol, err_msg=str(path))


@pytest.mark.parametrize("arm", list(ARMS))
def test_short_train_matches_reference(arm, monkeypatch):
    params, actions, draws = _reference_run(arm)
    _, trl = _configs(**ARMS[arm])
    seen = _record_port(monkeypatch)
    got, metrics = ttrain.train(ArrayDraws(**draws, device="cpu"),
                                ttypes.training_cluster(), trl, device="cpu")
    assert len(seen) == trl.episodes * trl.pods_per_episode
    for i, a in enumerate(seen):
        ep, t = divmod(i, trl.pods_per_episode)
        want = [actions[(ep, t, e)] for e in range(trl.n_envs)]
        assert a[0].tolist() == want, (ep, t)
    _close_trees(got, params, PARAM_TOL)
    assert set(metrics) == {"loss", "reward", "avg_cpu"}
    assert all(v.shape == (trl.episodes,) and bool(torch.isfinite(v).all())
               for v in metrics.values())


def test_train_starts_from_the_reference_carry():
    """The reference's initial ``TrainCarry`` (params, Adam state, ring)
    through ``convert`` gives the same run as fresh draws' params."""
    params, _, draws = _reference_run("mlp")
    jrl, trl = _configs(policy="mlp")
    c0 = jtrain._init_carry(jax.random.PRNGKey(3), jrl)
    carry = ttrain.TrainCarry(
        params=convert.qnet_from_numpy(_np(jax.tree.map(lambda x: x[None],
                                                        c0.params)), "cpu"),
        opt_state=convert.opt_state_from_numpy(
            _np(jax.tree.map(lambda x: np.asarray(x)[None], c0.opt_state)),
            "cpu"),
        target_params=convert.qnet_from_numpy(
            _np(jax.tree.map(lambda x: x[None], c0.target_params)), "cpu"),
        buffer=convert.replay_from_numpy(np.asarray(c0.buffer.data)[None],
                                         c0.buffer.ptr, c0.buffer.size, "cpu"),
        learn_step=int(c0.learn_step))
    no_params = {k: v for k, v in draws.items() if k != "params"}
    got, _ = ttrain.train(ArrayDraws(**no_params, device="cpu"),
                          ttypes.training_cluster(), trl, carry=carry,
                          device="cpu")
    _close_trees(got, params, PARAM_TOL)
    with pytest.raises(KeyError, match="params"):
        ttrain.train(ArrayDraws(**no_params, device="cpu"),
                     ttypes.training_cluster(), trl, device="cpu")


@pytest.fixture(scope="module")
def seeds_run():
    jrl, trl = _configs(policy="mlp")
    cfg = jtypes.training_cluster()
    key = jax.random.PRNGKey(11)
    stacked, metrics = jengine.train_seeds(key, cfg, jrl, 2)
    return _np(stacked), _np(metrics), seeded_train_draws(key, cfg, jrl, 2), trl


def test_train_seeds_matches_reference(seeds_run):
    stacked, metrics, draws, trl = seeds_run
    got, tm = tengine.train_seeds(ArrayDraws(**draws, device="cpu"),
                                  ttypes.training_cluster(), trl, 2,
                                  device="cpu")
    _close_trees(got, stacked, PARAM_TOL)
    for k in ("reward", "avg_cpu"):
        np.testing.assert_allclose(tm[k].numpy(), metrics[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_select_best_nan_guard():
    stacked = {"w": torch.arange(3.0)[:, None] * torch.ones(3, 2)}
    best = tengine.select_best(stacked, torch.tensor([2.0, float("nan"),
                                                      1.0]))
    assert best.params["w"].tolist() == [2.0, 2.0]
    assert float(best.metric) == 1.0 and not bool(best.diverged)
    best = tengine.select_best(stacked, torch.full((3,), float("nan")))
    assert best.params["w"].tolist() == [0.0, 0.0]
    assert float(best.metric) == float("inf") and bool(best.diverged)
    ref = jengine.select_best({"w": jnp.asarray(stacked["w"].numpy())},
                              jnp.asarray([2.0, np.nan, 1.0]))
    assert np.asarray(ref.params["w"]).tolist() == [2.0, 2.0]


def test_train_and_select_warns_when_every_seed_diverged(monkeypatch):
    trl = ttrain.RLConfig(**dict(SHORT, episodes=1))
    orig = tengine.select_best
    monkeypatch.setattr(tengine, "select_best", lambda p, m: orig(
        p, torch.full_like(m, float("nan"))))
    gen = torch.Generator().manual_seed(0)
    with pytest.warns(RuntimeWarning, match="NaN"):
        params, metric = tengine.train_and_select(
            TorchDraws(gen, (2, trl.n_envs)), ttypes.training_cluster(),
            ttypes.paper_cluster(), trl, n_seeds=2, val_trials=2,
            val_pods=4, device="cpu")
    assert metric == float("inf") and params["w1"].shape == (6, 32)


def _table_trials(select_j, select_t, n_trials=5, n_pods=50):
    cfg_j, cfg_t = jtypes.paper_cluster(), ttypes.paper_cluster()
    keys = jeval.fixed_trial_keys(100, n_trials)
    want = jeval.make_batch_episode(cfg_j, select_j, n_pods)(keys)
    draws = ArrayDraws(**reference_trial_draws(keys, cfg_j, n_pods),
                       device="cpu")
    got = teval.make_batch_episode(cfg_t, select_t, n_pods,
                                   device="cpu")(draws)
    return got, want


def test_table8_kube_matches_reference():
    got, want = _table_trials(jsched.make_kube_selector(jtypes.paper_cluster()),
                              tsched.make_kube_selector(ttypes.paper_cluster()))
    np.testing.assert_array_equal(got.exp_pods.numpy(),
                                  np.asarray(want.exp_pods))
    np.testing.assert_array_equal(got.distribution.numpy(),
                                  np.asarray(want.distribution))
    np.testing.assert_allclose(got.metric.numpy(), np.asarray(want.metric),
                               rtol=METRIC_RTOL)
    assert got.dropped.tolist() == np.asarray(want.dropped).tolist()
    for f in ("nodes_active", "node_seconds", "energy_wh"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   err_msg=f)
    summary = teval.summarize(got)
    assert summary["trials"] == 5.0 and summary["pods_placed_mean"] == 50.0


def test_reference_trained_params_give_reference_table9(monkeypatch):
    """Params the reference trained, carried over with ``convert``, give
    its per-trial SDQN metrics on the Table-8 protocol's trials."""
    params, _, _ = _reference_run("mlp")
    seen = _record_port(monkeypatch, tsched)
    cfg_j, cfg_t = jtypes.paper_cluster(), ttypes.paper_cluster()
    tp = convert.qnet_from_numpy(params, "cpu")
    got, want = _table_trials(jsched.make_sdqn_selector(params, cfg_j),
                              tsched.make_sdqn_selector(tp, cfg_t))
    np.testing.assert_array_equal(got.exp_pods.numpy(),
                                  np.asarray(want.exp_pods))
    np.testing.assert_allclose(got.metric.numpy(), np.asarray(want.metric),
                               rtol=METRIC_RTOL)
    assert len(seen) == 50


def test_multi_param_evaluator_shares_trials_across_candidates():
    """Every candidate row of the (S, T) evaluation equals evaluating that
    candidate alone on the same draws."""
    stacked, _, _, _ = _seeds_params()
    cfg = ttypes.paper_cluster()
    spec = ttrain.policy_mod.get("mlp")
    factory = lambda p: tsched.make_policy_selector(spec, p, cfg)  # noqa: E731

    def draws():
        return TorchDraws(torch.Generator().manual_seed(5), (3,))

    multi = teval.make_multi_param_evaluator(cfg, factory, 20, "cpu")(
        stacked, draws())
    assert multi.metric.shape == (2, 3)
    for s in range(2):
        one = teval.make_param_evaluator(cfg, factory, 20, "cpu")(
            {k: v[s] for k, v in stacked.items()}, draws())
        np.testing.assert_allclose(multi.metric[s].numpy(),
                                   one.metric.numpy(), rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _seeds_params():
    trl = ttrain.RLConfig(**SHORT)
    gen = torch.Generator().manual_seed(1)
    stacked, metrics = tengine.train_seeds(TorchDraws(gen, (2, trl.n_envs)),
                                           ttypes.training_cluster(), trl, 2,
                                           device="cpu")
    return stacked, metrics, trl, gen


def test_raising_arms_name_their_roadmap_items():
    """The arms that raised run now.  An explicit failure trace drives an
    episode: every other node down over [2, 6) s evicts pods, and the
    ledger balances.  ``train_mixture`` over a chaos scenario gives the
    reference's params (its episodes take no failure trace), and the
    job->host drain planner gives the reference's plan.  Fuller parity:
    tests/test_torch_chaos*.py and tests/test_torch_elastic.py.
    ``train_mixture``, ``train_supervised_scorer`` and ``consolidate=``
    run once each at a tiny size; their parity is held in
    tests/test_torch_lifecycle.py and tests/test_torch_baselines.py."""
    from repro import scenarios as jscn
    from repro.sched import elastic as jel, placement as jpl
    from repro_torch import scenarios as tscn
    from repro_torch.core import baselines as tbase, env as tenv
    from repro_torch.core.draws import SegmentDraws
    from repro_torch.sched import elastic as telastic, placement as tpl
    from test_torch_lifecycle import reference_mixture_draws

    cfg = ttypes.paper_cluster()
    draws = TorchDraws(torch.Generator().manual_seed(0), (2,))
    kube = tsched.make_kube_selector(cfg)
    inf = float("inf")
    trace = ttypes.FailureTrace(
        fail_s=torch.tensor([[2.0, inf, 2.0, inf]]),
        recover_s=torch.tensor([[6.0, inf, 6.0, inf]]))
    res = tenv.run_episode(draws, cfg, kube, 4, failure_trace=trace,
                           device="cpu")
    assert int(res.stats.evicted.sum()) > 0
    assert torch.equal(res.stats.evicted,
                       res.stats.rescheduled + res.stats.lost)
    jcfgs = [jtypes.paper_cluster(), jscn.make_env("batch-flaky",
                                                   randomize=True)]
    tcfgs = [cfg, tscn.make_env("batch-flaky", randomize=True)]
    jrl, trl = _configs()
    key = jax.random.PRNGKey(2)
    want, _ = jtrain.train_mixture(key, jcfgs, jrl, rounds=1)
    blocks, _ = reference_mixture_draws(key, jcfgs, jrl, 1)
    got, _ = ttrain.train_mixture(
        SegmentDraws([(ep0, ArrayDraws(**d, device="cpu"))
                      for ep0, d in blocks]), tcfgs, trl, rounds=1,
        device="cpu")
    _close_trees(got, _np(want), PARAM_TOL)
    qp = jpol.get("mlp").init(jax.random.PRNGKey(0))
    jf = jpl.fresh_fleet(6)._replace(
        cpu_pct=jnp.array([40.0, 40.0, 6.0, 7.0, 30.0, 30.0]),
        num_jobs=jnp.array([8, 8, 1, 1, 6, 6], jnp.int32))
    plan = telastic.consolidation_plan(
        tpl.PlacementEngine(convert.qnet_from_numpy(_np(qp), "cpu")),
        convert.fleet_from_numpy(_np(jf), "cpu"), tpl.JobSpec(4.0))
    assert plan.migrations == jel.consolidation_plan(
        jpl.PlacementEngine(qp), jf, jpl.JobSpec(4.0)).migrations
    trl = ttrain.RLConfig(**SHORT)
    params, metrics = ttrain.train_mixture(
        draws, [ttypes.training_cluster(),
                tscn.make_env("hetero-bigsmall", randomize=True)], trl,
        rounds=1, device="cpu")
    assert metrics["loss"].shape == (2,) and params["w1"].shape == (6, 32)
    scorer = ttrain.train_supervised_scorer(
        TorchDraws(torch.Generator().manual_seed(1), (2,)), cfg,
        tbase.init_lstm, tbase.lstm_score, episodes=1, pods_per_episode=4,
        n_envs=2, device="cpu")
    assert all(bool(torch.isfinite(v).all()) for v in scorer.values())
    ccfg = dataclasses.replace(cfg, consolidate_every_s=4.0)
    res = teval.make_batch_episode(
        ccfg, kube, 4, consolidate=telastic.make_consolidator(params, ccfg),
        device="cpu")(draws)
    assert res.placed.tolist() == [4, 4]


def test_presets_match_reference():
    from repro.core import presets as jpresets
    from repro_torch.core import presets as tpresets
    for name in ("SDQN_PRESET", "SDQN_N_PRESET", "SDQN_LITERAL_PRESET"):
        assert (dataclasses.asdict(getattr(tpresets, name))
                == dataclasses.asdict(getattr(jpresets, name)))
    for name in ("N_SELECTION_SEEDS", "N_SUPERVISED_SEEDS",
                 "SUPERVISED_EPISODES"):
        assert getattr(tpresets, name) == getattr(jpresets, name)
    assert dataclasses.asdict(ttrain.RLConfig()) == dataclasses.asdict(
        jtrain.RLConfig())
    assert ttrain.REWARD_SCALE == jtrain.REWARD_SCALE


def _paper_tables_module():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "scripts" / \
        "paper_tables.py"
    spec = importlib.util.spec_from_file_location("paper_tables", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, path


def test_paper_tables_script_imports_neither_jax_nor_reference():
    import ast

    _, path = _paper_tables_module()
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), name


def test_paper_tables_run_at_a_cut_budget(capsys):
    """Tables 8-10 end to end on the CPU at 1 episode x 2 seeds x 2
    trials: the cut is printed, every trial places or drops its 50 pods,
    and the reference's numbers are quoted."""
    pt, _ = _paper_tables_module()
    assert pt.PAPER == {k: v for k, v in __import__(
        "benchmarks.paper_tables", fromlist=["PAPER"]).PAPER.items()
        if k in pt.PAPER}
    out = pt.run(episodes=1, seeds=2, trials=2, device="cpu")
    text = capsys.readouterr().out
    assert "CUT budget" in text and "Table 10" in text
    assert out["cuts"] == {"episodes": 1, "seeds": 2, "trials": 2}
    for name, tb in out["tables"].items():
        assert len(tb["metric"]) == 2 and np.all(np.isfinite(tb["metric"]))
        for row, dropped in zip(tb["exp_pods"], tb["dropped"]):
            assert sum(row) + dropped == pt.N_PODS, name
    assert set(out["params"]) == {"sdqn", "sdqn_n"}
