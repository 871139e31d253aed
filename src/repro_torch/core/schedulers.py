"""SDQN scheduling (PyTorch port): the scoring dispatch and the selectors.

All policies apply the k8s *filtering* phase first (paper §3.2) and only
score feasible nodes; SDQN scores afterstates with the Table-4 Q-net, and
a registered policy class (``core.policy``) through its ``score_set``.
Selectors are batched: ``select(step_draws, state, pod) -> node`` takes
clusters ``(..., N)`` with one pod each (fields ``(...)``) and returns
``(...)`` int32 nodes, ``NO_PLACEMENT`` where nothing fits; their
randomness comes from ``step_draws`` (``core.draws``), which may be
``None`` where no draw is taken (greedy selection).  A custom
``score_fn(params, feats (..., N, 6)) -> (..., N)`` (the paper's LSTM /
Transformer baselines, ``core.baselines``) scores the normalized
afterstate rows on the unfused path, as in the reference.
"""
from __future__ import annotations

import itertools
from typing import Callable

import torch

from repro_torch.core import dqn, env as kenv, policy as pol
from repro_torch.core.types import NO_PLACEMENT, ClusterState, EnvConfig, PodSpec

# At and above this node count SDQN scoring goes through the fused
# afterstate kernel (``kernels.ops.sdqn_score_afterstate``); below it the
# plain O(N) path.  The reference's threshold, not yet re-tuned for the card.
FUSED_SCORE_MIN_NODES = 4096

FUSED_CHOICES = ("auto", True, False, "plain")


def masked_argmax(gen: torch.Generator | None, scores: torch.Tensor,
                  ok: torch.Tensor, epsilon: float = 0.0, *,
                  u: torch.Tensor | None = None,
                  noise: torch.Tensor | None = None) -> torch.Tensor:
    """Greedy over feasible nodes (the last axis; first occurrence among
    equal maxima), with epsilon-greedy exploration: where ``u < epsilon``
    the argmax of ``noise`` over the feasible nodes instead.

    ``u (...)`` and ``noise (..., N)`` are the reference's two uniforms
    (``core.draws``); without them and with ``epsilon > 0`` they are drawn
    from ``gen``.  No value is read back to the host.  Returns int32
    ``(...)``, ``NO_PLACEMENT`` (-1) where no node is feasible: an argmax
    over all ``-inf`` would silently pick node 0."""
    neg = torch.full_like(scores, -torch.inf)
    choice = torch.argmax(torch.where(ok, scores, neg), dim=-1).to(torch.int32)
    if u is None and epsilon > 0.0:
        dev = gen.device if gen is not None else scores.device
        u = torch.rand(scores.shape[:-1], generator=gen, device=dev)
        noise = torch.rand(scores.shape, generator=gen, device=dev)
    if u is not None:
        explore = u.to(scores.device) < epsilon
        rand = torch.argmax(torch.where(ok, noise.to(scores.device), neg),
                            dim=-1).to(torch.int32)
        choice = torch.where(explore, rand, choice)
    return torch.where(torch.any(ok, dim=-1), choice, NO_PLACEMENT)


def check_scorer(fused, score_fn=None, policy=None, embed=None):
    """Validate a scoring request; returns the policy to score through, or
    ``None`` for the Table-4 kernels (no policy, or a fused-capable spec
    such as ``"mlp"``) and for a custom ``score_fn``.

    A ``score_fn`` goes with no policy and never with ``fused=True`` (no
    kernel computes it); an unregistered policy raises; ``embed`` goes
    with a sequence policy and nothing else, and a sequence policy needs
    it."""
    if fused not in FUSED_CHOICES:
        raise ValueError(f"fused must be one of {FUSED_CHOICES}, got {fused!r}")
    if score_fn is not None:
        if policy is not None:
            raise ValueError("pass either score_fn or policy, not both")
        if fused is True:
            raise ValueError("a custom score_fn cannot take the fused kernel "
                             "path")
    policy = pol.checked(policy)
    embed_dim = 0 if policy is None else policy.embed_dim
    if (embed is not None) != (embed_dim > 0):
        raise ValueError(f"embed goes with a sequence policy: policy "
                         f"{getattr(policy, 'name', None)!r} has embed_dim="
                         f"{embed_dim}, embed is "
                         f"{'given' if embed is not None else 'missing'}")
    if policy is None or policy.fused_kernel:
        return None
    if fused is True:
        raise ValueError(f"policy {policy.name!r} cannot take the fused "
                         f"kernel path")
    return policy


def policy_mode(fused):
    """The kernels' mode for a policy class: ``fused="plain"`` forces their
    plain versions (as it does the SDQN kernels'), anything else the
    default (the kernel on the card, the plain version on the CPU)."""
    return "plain" if fused == "plain" else None


def with_embed(feats: torch.Tensor, embed) -> torch.Tensor:
    """``feats (B, ..., F)`` with ``embed`` ((E,), or (B, E): one row per
    pod) appended to every row."""
    if embed is None:
        return feats
    e = embed.reshape(embed.shape[:-1] + (1,) * (feats.dim() - embed.dim())
                      + embed.shape[-1:])
    return torch.cat([feats, e.expand(feats.shape[:-1] + e.shape[-1:])],
                     dim=-1)


def score_afterstates_batch(qparams: dict, state: ClusterState, pods: PodSpec,
                            cfg: EnvConfig, fused="auto", pull_cost=None,
                            score_fn=None, policy=None,
                            embed=None) -> torch.Tensor:
    """(B, N) scores for a batch of pods (fields (B,)) against one snapshot.

    ``fused``: ``"auto"`` takes the fused kernel path from
    ``FUSED_SCORE_MIN_NODES`` nodes up (the CUDA kernel on the card, its
    plain twin on the CPU), ``True`` forces it at any N, ``"plain"`` forces
    the fused path through the plain twin even on the card, ``False`` the
    unfused ``hypothetical_place`` + ``qvalues`` path.  On the fused path
    the whole batch is ONE kernel launch.

    ``policy`` (a registered ``core.policy.PolicySpec``) scores through
    ``policy.score_set`` over the (B, N, F) normalized afterstate rows,
    with ``embed`` ((E,) or (B, E), sequence specs) appended to every row;
    fused-capable specs ("mlp") keep the kernel path.  ``"plain"`` runs the
    policy's kernels through their plain versions.  ``score_fn`` always
    takes the unfused path.
    """
    spec = check_scorer(fused, score_fn, policy, embed)
    use_fused = spec is None and score_fn is None and (
        fused in (True, "plain") or (
            fused == "auto" and state.n_nodes >= FUSED_SCORE_MIN_NODES))
    if use_fused:
        from repro_torch.kernels import ops

        mode = "plain" if fused == "plain" else None
        return ops.sdqn_score_afterstate(state, pods, cfg, qparams, mode=mode,
                                         pull_cost=pull_cost)
    device = state.base_cpu.device
    batch = PodSpec(*(torch.as_tensor(x, dtype=torch.float32,
                                      device=device).reshape(-1, 1)
                      for x in pods))
    after = kenv.hypothetical_place(state, batch, cfg, pull_cost=pull_cost)
    feats = kenv.normalize_features(after)                  # (B, N, 6)
    return _score_rows(qparams, feats, spec, score_fn, embed, fused)


def _score_rows(qparams, feats, spec, score_fn, embed, fused):
    """Scores of normalized afterstate rows ``(..., N, F)`` by the custom
    scorer, the policy class, or the Table-4 net."""
    if score_fn is not None:
        return score_fn(qparams, feats)
    if spec is None:
        return dqn.qvalues(qparams, feats)
    return spec.score_set(qparams, with_embed(feats, embed),
                          mode=policy_mode(fused))


def score_afterstates(qparams: dict, state: ClusterState, pod: PodSpec,
                      cfg: EnvConfig, fused="auto", pull_cost=None,
                      score_fn=None, policy=None, embed=None) -> torch.Tensor:
    """(N,) scores: Q(afterstate_i) for each candidate node i of one pod
    (``embed``: the pod's (E,) history embed, sequence specs)."""
    device = state.base_cpu.device
    batch = PodSpec(*(torch.as_tensor(x, dtype=torch.float32,
                                      device=device).reshape(1) for x in pod))
    return score_afterstates_batch(qparams, state, batch, cfg, fused=fused,
                                   pull_cost=pull_cost, score_fn=score_fn,
                                   policy=policy, embed=embed)[0]


def pod_rows(pod: PodSpec, like: torch.Tensor) -> PodSpec:
    """One pod per cluster (fields floats or ``(...)``) shaped ``(..., 1)``
    to broadcast over the node axis of ``like (..., N)``."""
    return PodSpec(*(torch.as_tensor(x, dtype=torch.float32,
                                     device=like.device)[..., None]
                     for x in pod))


def score_states(qparams, state: ClusterState, pod: PodSpec, cfg: EnvConfig,
                 fused="auto", policy=None, embed=None,
                 score_fn=None) -> torch.Tensor:
    """(..., N) scores of a batch of clusters ``state (..., N)``, each
    against its own pod (fields ``(...)``): Q of every candidate
    afterstate.  ``qparams`` may carry a leading seed dimension, which
    then leads the batch.  ``embed (..., E)``: sequence specs' history
    embeds, one per cluster.

    The dispatch of ``score_afterstates_batch``: the fused path (from
    ``FUSED_SCORE_MIN_NODES`` nodes up, or forced) runs kernel 1 once per
    cluster, since it scores B pods against ONE snapshot; the plain path
    and the policy classes score every cluster in one pass (one kernel-7
    launch for all sets, for "attention"); ``score_fn`` the unfused
    path."""
    spec = check_scorer(fused, score_fn, policy, embed)
    n = state.n_nodes
    if spec is None and score_fn is None and (fused in (True, "plain") or (
            fused == "auto" and n >= FUSED_SCORE_MIN_NODES)):
        from repro_torch.kernels import ops

        mode = "plain" if fused == "plain" else None
        batch = tuple(state.time_s.shape)
        per_seed = dqn.seeded(qparams)
        out = torch.empty(batch + (n,), dtype=torch.float32,
                          device=state.base_cpu.device)
        cols = PodSpec(*(torch.as_tensor(x, dtype=torch.float32,
                                         device=out.device).expand(batch)
                         for x in pod))
        for idx in itertools.product(*(range(b) for b in batch)):
            params = ({k: v[idx[0]] for k, v in qparams.items()}
                      if per_seed else qparams)
            out[idx] = ops.sdqn_score_afterstate(
                ClusterState(*(x[idx] for x in state)),
                PodSpec(*(x[idx] for x in cols)), cfg, params, mode=mode)
        return out
    after = kenv.hypothetical_place(state, pod_rows(pod, state.base_cpu), cfg)
    feats = kenv.normalize_features(after)                  # (..., N, 6)
    return _score_rows(qparams, feats, spec, score_fn, embed, fused)


def _explore_draws(step, epsilon: float, n: int) -> dict:
    """The selector's exploration draws: none when greedy."""
    if not epsilon:
        return {}
    return {"u": step.explore(), "noise": step.noise(n)}


def make_sdqn_selector(qparams: dict, cfg: EnvConfig, epsilon: float = 0.0,
                       fused="auto") -> Callable:
    """``select(step_draws, state, pod) -> node`` (int32 ``(...)``,
    ``NO_PLACEMENT`` where nothing fits).  ``qparams`` may carry a leading
    seed dimension (one selector for every candidate); ``fused`` is the
    scoring dispatch's (``"plain"`` holds kernel 1 to its plain
    version)."""

    def select(step, state, pod):
        ok = kenv.feasible(state, pod_rows(pod, state.base_cpu), cfg)
        q = score_states(qparams, state, pod, cfg, fused=fused)
        return masked_argmax(None, q, ok, epsilon,
                             **_explore_draws(step, epsilon, state.n_nodes))

    return select


# SDQN-n uses the same scoring machinery; consolidation comes from the
# reward the network was trained on (Table 5), not from another selector.
make_sdqn_n_selector = make_sdqn_selector


def make_policy_selector(spec, params, cfg: EnvConfig, epsilon: float = 0.0):
    """Episode selector for any registered policy class: ``(select,
    carry0)``.  Stateless specs (``embed_dim == 0``, or ``spec is None``)
    give ``select(step, state, pod)`` and ``carry0 = None``; sequence specs
    ``select(step, state, pod, carry) -> (node, carry)`` and the initial
    carry, for ``env.run_episode(select_carry=...)``."""
    if spec is None or spec.embed_dim == 0:

        def select(step, state, pod):
            ok = kenv.feasible(state, pod_rows(pod, state.base_cpu), cfg)
            q = score_states(params, state, pod, cfg, policy=spec)
            return masked_argmax(None, q, ok, epsilon,
                                 **_explore_draws(step, epsilon,
                                                  state.n_nodes))

        return select, None

    def select(step, state, pod, carry):
        carry2, emb = spec.encode_step(params, carry,
                                       pol.pod_workload_features(pod))
        ok = kenv.feasible(state, pod_rows(pod, state.base_cpu), cfg)
        q = score_states(params, state, pod, cfg, policy=spec, embed=emb)
        return masked_argmax(None, q, ok, epsilon,
                             **_explore_draws(step, epsilon,
                                              state.n_nodes)), carry2

    return select, spec.carry_init(params)


def make_neural_selector(params: dict, score_fn, cfg: EnvConfig) -> Callable:
    """The LSTM / Transformer baselines as greedy episode selectors: the
    same afterstate scoring protocol through ``score_fn``."""

    def select(step, state, pod):
        ok = kenv.feasible(state, pod_rows(pod, state.base_cpu), cfg)
        q = score_states(params, state, pod, cfg, score_fn=score_fn)
        return masked_argmax(None, q, ok)

    return select


def make_kube_selector(cfg: EnvConfig) -> Callable:
    """The default kube-scheduler as an episode selector; its random
    tie-break comes from ``step.tiebreak``."""
    from repro_torch.core import baselines

    def select(step, state, pod):
        return baselines.kube_select(step, state, pod, cfg)

    return select
