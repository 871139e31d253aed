"""Each random stream of the port's ``TorchDraws`` against the reference's
sampler, in distribution.

torch cannot reproduce JAX's threefry streams, so a standalone port run
draws other numbers than the reference's; what must hold is that they
come from the same distributions.  Each draw of ``core/draws.py`` (and
the ``core/env.py`` samplers behind it) is made about 2·10⁴ times from a
fixed seed and compared with the reference's own function at the same
arguments: two-sample Kolmogorov-Smirnov for continuous columns,
chi-square on the counts for categories and integers, both at
``ALPHA`` = 1e-4; a column that is constant on either side must be the
same constant on both.  The seeds are fixed, so the verdicts repeat.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro import scenarios as jscn
from repro.core import baselines as jbase, env as jenv, policy as jpol
from repro.core import types as jtypes
from repro_torch import scenarios as tscn
from repro_torch.core import baselines as tbase
from repro_torch.core import policy as tpol, types as ttypes
from repro_torch.core.draws import TorchDraws
from test_torch_chaos import reference_failure_units

ALPHA = 1e-4
M = 20_000


def _draws(seed, batch):
    return TorchDraws(torch.Generator().manual_seed(seed), batch)


def _keys(seed, n):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def _flat(x, limit=M):
    return np.asarray(x, np.float64).reshape(-1)[:limit]


def same_dist(got, want, what, discrete=False):
    """``got`` (port) and ``want`` (reference) from one distribution:
    equal constants, or chi-square on the counts of their values
    (``discrete``), or two-sample KS."""
    got, want = _flat(got), _flat(want)
    if np.ptp(got) == 0 or np.ptp(want) == 0:
        assert np.ptp(got) == np.ptp(want) == 0 and got[0] == want[0], (
            what, got[:4], want[:4])
        return
    if discrete:
        values = np.union1d(got, want)
        table = np.stack([[np.sum(got == v) for v in values],
                          [np.sum(want == v) for v in values]])
        p = stats.chi2_contingency(table).pvalue
    else:
        p = stats.ks_2samp(got, want).pvalue
    assert p > ALPHA, (what, p)


def binned(got, want, lo, hi, bins, what):
    """Chi-square on ``bins`` equal bins of [lo, hi) (integers over a
    range too wide for a cell each)."""
    edges = np.linspace(lo, hi, bins + 1)
    table = np.stack([np.histogram(_flat(got), edges)[0],
                      np.histogram(_flat(want), edges)[0]])
    assert table.sum() == 2 * min(len(_flat(got)), len(_flat(want)))
    p = stats.chi2_contingency(table).pvalue
    assert p > ALPHA, (what, p)


# ---------------------------------------------------------------------------
# initial params
# ---------------------------------------------------------------------------

INITS = {
    "mlp": (lambda k: jpol.get("mlp").init(k),
            lambda g: tpol.get("mlp").init(g, device="cpu")),
    "lstm": (jbase.init_lstm, lambda g: tbase.init_lstm(g, device="cpu")),
    "transformer": (jbase.init_transformer,
                    lambda g: tbase.init_transformer(g, device="cpu")),
}


@pytest.mark.parametrize("kind", list(INITS))
def test_init_matches_reference(kind):
    """Every leaf of ``init_qnet`` (the "mlp" class) and of the LSTM and
    Transformer scorers' inits, pooled over fresh inits until it holds
    about M values."""
    jinit, tinit = INITS[kind]
    sizes = {k: np.size(v) for k, v in jinit(jax.random.PRNGKey(0)).items()}
    n = min(-(-M // min(sizes.values())), 800)
    want = jax.vmap(jinit)(_keys(1, n))
    gen = torch.Generator().manual_seed(1)
    got = [tinit(gen) for _ in range(n)]
    assert set(got[0]) == set(sizes)
    for k in sizes:
        assert tuple(got[0][k].shape) == np.shape(want[k])[1:], k
        same_dist(torch.stack([g[k] for g in got]).numpy(), want[k],
                  f"{kind}.{k}")


# ---------------------------------------------------------------------------
# resets
# ---------------------------------------------------------------------------

CLUSTERS = {"paper": (jtypes.paper_cluster, ttypes.paper_cluster),
            "training": (jtypes.training_cluster, ttypes.training_cluster)}


@pytest.mark.parametrize("name", list(CLUSTERS))
def test_reset_columns_match_reference(name):
    """``reset`` column by column and node position by node position
    (the profiles are permuted per cluster): M clusters a side."""
    jcfg, tcfg = (f() for f in CLUSTERS[name])
    want = jax.jit(jax.vmap(lambda k: jenv.reset(k, jcfg)))(_keys(2, M))
    got = _draws(2, (M,)).reset(tcfg, device="cpu")
    for field in ttypes.ClusterState._fields:
        g = getattr(got, field).numpy()
        w = np.asarray(getattr(want, field))
        assert g.shape == w.shape, field
        if g.ndim == 1:                     # time_s: one a cluster
            same_dist(g, w, field)
            continue
        discrete = g.dtype in (np.int32, np.int64, np.bool_)
        for node in range(g.shape[-1]):
            same_dist(g[:, node].astype(np.float64),
                      w[:, node].astype(np.float64), f"{field}[{node}]",
                      discrete=discrete)


# ---------------------------------------------------------------------------
# arrival tables
# ---------------------------------------------------------------------------

TABLE_SCENARIOS = ("train-serve-mix", "longrun-train-mix", "diurnal-churn",
                   "hetero-bigsmall")
N_ARRIVALS = 50


@pytest.mark.parametrize("name", TABLE_SCENARIOS)
def test_pod_table_matches_reference(name):
    """``sample_pod_table`` on a scenario: pod-type frequencies, arrival
    gaps and lifetimes (their infinite share as a category), over M
    arrivals a side."""
    jcfg, tcfg = jscn.make_env(name), tscn.make_env(name)
    b = M // N_ARRIVALS
    want = jax.jit(jax.vmap(lambda k: jenv.sample_pod_table(
        k, jcfg, N_ARRIVALS)))(_keys(3, b))
    got = _draws(3, (b,)).pod_table(tcfg, N_ARRIVALS, device="cpu")
    same_dist(got.type_idx.numpy(), want.type_idx, "type_idx", discrete=True)
    same_dist(got.dt_s.numpy(), want.dt_s, "dt_s")
    for field in ttypes.PodSpec._fields:
        same_dist(getattr(got.specs, field).numpy(),
                  getattr(want.specs, field), field, discrete=True)
    g, w = got.lifetime_s.numpy(), np.asarray(want.lifetime_s)
    same_dist(np.isinf(g), np.isinf(w), "lifetime inf", discrete=True)
    if np.isfinite(g).any():
        same_dist(g[np.isfinite(g)], w[np.isfinite(w)], "lifetime_s")


# ---------------------------------------------------------------------------
# a step's uniforms, the replay sample, failure traces
# ---------------------------------------------------------------------------

N_NOISE = 4


@pytest.mark.parametrize("which", ["explore", "noise", "tiebreak"])
def test_step_uniforms_match_reference(which):
    """The epsilon-greedy uniform, its random argmax's noise row and the
    kube-scheduler's tie-break row: ``jax.random.uniform`` at the
    reference's shapes."""
    if which == "explore":
        want = jax.vmap(lambda k: jax.random.uniform(k))(_keys(4, M))
        got = _draws(4, (M,)).step(0, 0).explore()
    else:
        b = M // N_NOISE
        want = jax.vmap(lambda k: jax.random.uniform(k, (N_NOISE,)))(
            _keys(4, b))
        got = getattr(_draws(4, (b,)).step(0, 0), which)(N_NOISE)
    same_dist(got.numpy(), want, which)
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


@pytest.mark.parametrize("size,capacity", [(0, 4096), (7, 4096),
                                           (4096, 4096)],
                         ids=["empty", "small", "full"])
def test_replay_indices_match_reference(size, capacity):
    """``replay_indices`` over [0, max(size, 1)): one cell a value on a
    small ring, 64 equal bins on a full one."""
    hi = max(size, 1)
    want = jax.random.randint(jax.random.PRNGKey(5), (M,), 0, jnp.maximum(
        jnp.int32(size), 1))
    got = _draws(5, ()).replay_indices(0, 0, size, (M,))
    assert int(got.min()) >= 0 and int(got.max()) < hi
    if hi <= 64:
        same_dist(got.numpy(), want, f"replay[{size}]", discrete=True)
    else:
        binned(got.numpy(), want, 0, hi, 64, f"replay[{size}]")


@pytest.mark.parametrize("name", ["paper", "preemptible-flaky"])
def test_failure_draws_match_reference(name):
    """A failure trace's unit exponentials (``env.failure_draws``) against
    those ``sample_failure_trace`` draws."""
    if name == "paper":
        jcfg, tcfg = jtypes.paper_cluster(), ttypes.paper_cluster()
    else:
        jcfg, tcfg = jscn.make_env(name), tscn.make_env(name)
    per = jcfg.chaos_cycles * 2 * jcfg.n_nodes
    b = -(-M // per)
    want = jax.jit(jax.vmap(lambda k: reference_failure_units(k, jcfg)))(
        _keys(6, b))
    got = _draws(6, (b,)).failure(tcfg, device="cpu")
    assert tuple(got.shape) == np.shape(want)
    same_dist(got.numpy(), want, f"failure[{name}]")
    assert bool(torch.all(got >= 0))
