"""SDQN scheduling (PyTorch port): the scoring dispatch and the selector.

All policies apply the k8s *filtering* phase first (paper §3.2) and only
score feasible nodes; SDQN scores afterstates with the Table-4 Q-net, and
a registered policy class (``core.policy``) through its ``score_set``.
Custom scorers (the LSTM / Transformer baselines) wait for their slice.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import dqn, env as kenv, policy as pol
from repro_torch.core.types import NO_PLACEMENT, ClusterState, EnvConfig, PodSpec

# At and above this node count SDQN scoring goes through the fused
# afterstate kernel (``kernels.ops.sdqn_score_afterstate``); below it the
# plain O(N) path.  The reference's threshold, not yet re-tuned for the card.
FUSED_SCORE_MIN_NODES = 4096

FUSED_CHOICES = ("auto", True, False, "plain")
SCORE_FN_QUEUE_ITEM = ("a custom score_fn (the LSTM / Transformer "
                       "baselines) is not ported yet: see ROADMAP.md, queue "
                       "1, 'Paper baselines'")


def masked_argmax(gen: torch.Generator | None, scores: torch.Tensor,
                  ok: torch.Tensor, epsilon: float = 0.0) -> torch.Tensor:
    """Greedy over feasible nodes (first occurrence among equal maxima),
    with epsilon-greedy exploration drawn from ``gen``.

    Returns ``NO_PLACEMENT`` (-1) as an int32 0-d tensor when no node is
    feasible: an argmax over all ``-inf`` would silently pick node 0."""
    masked = torch.where(ok, scores, torch.full_like(scores, -torch.inf))
    choice = torch.argmax(masked).to(torch.int32)
    if epsilon > 0.0:
        draw_dev = gen.device if gen is not None else scores.device
        explore = bool(torch.rand((), generator=gen, device=draw_dev) < epsilon)
        if explore:
            noise = torch.rand(scores.shape, generator=gen, device=draw_dev)
            noise = torch.where(ok, noise.to(scores.device),
                                torch.full_like(scores, -torch.inf))
            choice = torch.argmax(noise).to(torch.int32)
    return torch.where(torch.any(ok), choice,
                       torch.tensor(NO_PLACEMENT, dtype=torch.int32,
                                    device=scores.device))


def check_scorer(fused, score_fn=None, policy=None, embed=None):
    """Validate a scoring request; returns the policy to score through, or
    ``None`` for the Table-4 kernels (no policy, or a fused-capable spec
    such as ``"mlp"``).

    A custom ``score_fn`` raises ``NotImplementedError``; an unregistered
    policy raises; ``embed`` goes with a sequence policy and nothing else,
    and a sequence policy needs it."""
    if score_fn is not None:
        raise NotImplementedError(SCORE_FN_QUEUE_ITEM)
    if fused not in FUSED_CHOICES:
        raise ValueError(f"fused must be one of {FUSED_CHOICES}, got {fused!r}")
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
    policy's kernels through their plain versions.
    """
    spec = check_scorer(fused, score_fn, policy, embed)
    use_fused = spec is None and (fused in (True, "plain") or (
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


def make_sdqn_selector(qparams: dict, cfg: EnvConfig,
                       epsilon: float = 0.0) -> Callable:
    """``select(gen, state, pod) -> node`` (int32 0-d, ``NO_PLACEMENT`` if
    nothing fits)."""

    def select(gen, state, pod):
        ok = kenv.feasible(state, pod, cfg)
        q = score_afterstates(qparams, state, pod, cfg)
        return masked_argmax(gen, q, ok, epsilon)

    return select
