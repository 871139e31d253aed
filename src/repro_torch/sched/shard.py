"""Two-stage sharded fleet scoring on one card (port of ``repro.sched.shard``).

  1. **Shard** — the fleet's node columns split into ``layout.shards``
     contiguous slices of ``layout.shard_size`` (``launch.mesh.FleetLayout``).
     The port runs every shard on one card, so the columns are not copied
     or padded: the kernels mask the ragged last shard by index.
  2. **Per-shard top-k, in-kernel** — ONE launch scores every (request,
     node) pair with the filtering phase and reduces each shard to its best
     ``k`` (``ops.sdqn_topk_afterstate`` / ``ops.sdqn_topk_delta``); the
     heuristic and unfused arms reduce their masked scores with the same
     stable-sort contract (``sdqn_score.shard_topk``).
  3. **Global merge** — one stable sort over the ``shards × k``
     candidates.  Ties break to the lowest global index at every stage, so
     the merged winner is exactly the flat masked argmax.

``env.pull_cost_now`` is a GLOBAL reduction over in-flight startup
transients: it is reduced once from the whole fleet and passed to every
shard, never per shard, which keeps the shard-local scores identical to the
unsharded program.

Candidates are sorted descending (NaN above every number, so a diverged
net shows among them); slots that are not finite carry index ``-1``.

Registered policy classes (``core.policy``) other than the fused-capable
"mlp" score each shard's rows with ``score_set`` (one call for every pod
and shard: one kernel-7 launch for "attention") and reduce them with the
same stable-sort contract.  Their shards ARE padded, with the reference's
infeasible filler (``_pad_cluster`` / ``_pad_fleet``): the "attention" class
mixes context over each shard's node set, block-local by construction as
in the reference, and the filler rows of the last shard are among its
keys there too.  A custom ``score_fn`` (the paper's LSTM / Transformer
baselines) scores the unfused rows of a ClusterState fleet with the same
contract; the FleetState arms reject it, as the reference's do.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import env as kenv, schedulers
from repro_torch.core.types import NO_PLACEMENT, ClusterState, PodSpec
from repro_torch.kernels import ops, sdqn_score as _ss
from repro_torch.launch.mesh import FleetLayout, plan_fleet_layout
from repro_torch.sched import placement as _pl

__all__ = [
    "FleetLayout", "candidates_valid", "cluster_topk", "fleet_topk",
    "plan_fleet_layout", "resolve_layout", "select_candidates",
    "sharded_scores", "topk",
]

# |Q| beyond this is a diverged net, not a preference (sched.api's limit)
_DIVERGENCE_LIMIT = 1e6

# the reference's filler for ClusterState columns past N: unit capacities
# keep the filler's afterstate finite, healthy = False makes it infeasible
_CLUSTER_PAD = {"cpu_capacity": 1, "mem_capacity": 1, "max_pods": 1}


def _pad_cluster(state: ClusterState, layout: FleetLayout) -> ClusterState:
    """Each (N,) column padded to ``layout.padded`` with the reference's
    infeasible filler (``time_s`` passes through)."""
    pad = layout.padded - state.n_nodes
    if pad == 0:
        return state
    return ClusterState(*(
        torch.cat([c, c.new_full((pad,), _CLUSTER_PAD.get(name, 0))])
        if c.dim() == 1 else c for name, c in zip(state._fields, state)))


def _pad_fleet(fleet: _pl.FleetState, layout: FleetLayout) -> _pl.FleetState:
    """FleetState analogue of :func:`_pad_cluster`: zero filler, so
    ``healthy == 0`` makes the padded hosts infeasible."""
    pad = layout.padded - fleet.cpu_pct.shape[0]
    return _pl.FleetState(*(torch.cat([c, c.new_zeros((pad,))])
                            for c in fleet)) if pad else fleet


def _shard_score_set(params, feats, layout: FleetLayout, spec, embed, fused):
    """(B, padded, F) normalized rows of a padded fleet -> (B, padded)
    scores: ``spec.score_set`` over every shard's rows as one (B, shards,
    shard_size, F) call, so set attention mixes context within a shard."""
    feats = schedulers.with_embed(feats, embed)
    b = feats.shape[0]
    q = spec.score_set(params, feats.reshape(b, layout.shards,
                                             layout.shard_size, -1),
                       mode=schedulers.policy_mode(fused))
    return q.reshape(b, layout.padded)


def _cluster_rows(st: ClusterState, rows: PodSpec, cfg, pull_cost):
    """(B, padded, 6) normalized afterstate rows of the padded cluster
    ``st`` for (B, 1) pod columns ``rows``."""
    return kenv.normalize_features(
        kenv.hypothetical_place(st, rows, cfg, pull_cost=pull_cost))


def resolve_layout(shard, n_nodes: int) -> Optional[FleetLayout]:
    """Map the public ``shard=`` knob onto a :class:`FleetLayout`.

    ``"auto"`` is ``None`` — the port runs on one card, where the reference
    also resolves it to the unsharded program; ``False``/``None`` disables
    sharding; an ``int`` forces that shard count (two-stage execution on
    the card); a ``FleetLayout`` passes through."""
    if shard is None or shard is False or shard == "auto":
        return None
    if isinstance(shard, FleetLayout):
        return shard if shard.shards > 1 else None
    if isinstance(shard, int) and not isinstance(shard, bool):
        return plan_fleet_layout(n_nodes, shards=shard)
    raise ValueError(f"shard must be 'auto', False, an int shard count or a "
                     f"FleetLayout; got {shard!r}")


def _batch(pod, device) -> tuple:
    """(PodSpec of (B,) float32 columns, single?)."""
    single = torch.as_tensor(pod.cpu_request).dim() == 0
    return PodSpec(*(torch.as_tensor(x, dtype=torch.float32, device=device)
                     .reshape(-1) for x in pod)), single


def _merge(vals, gidx):
    """The (..., S, k) shard candidates as one descending (..., S·k) list:
    a stable sort of the flattened candidates, so ties stay in ascending
    flat position == ascending global index (shards cover ascending index
    ranges and list their ties lowest index first)."""
    return _ss.merge_topk(vals, gidx, vals.shape[-2] * vals.shape[-1])


def _finish(vals, idx, single):
    vals, idx = _merge(vals, idx)
    return (vals[0], idx[0]) if single else (vals, idx)


def cluster_topk(params: dict, state: ClusterState, pod, cfg,
                 layout: FleetLayout, *, k: int = 4, fused="auto",
                 score_fn=None, policy=None, embed=None,
                 heuristic: bool = False, pull_cost=None):
    """Two-stage feasible top-k over a ClusterState fleet.

    ``pod`` holds scalars (result ``(shards·k,)``) or (B,) columns (result
    ``(B, shards·k)``: the whole batch in one kernel launch).  Values are
    sorted descending (ties by ascending node index), so element 0 is
    exactly the flat masked argmax; infeasible or exhausted slots carry
    ``-inf`` / ``-1``.  ``heuristic=True`` scores with the kube formula
    instead of the Q-net (the degraded-mode arm, same two-stage shape).
    ``policy`` / ``embed``: a registered policy class ((E,) or (B, E)
    embeds for sequence specs), scored per shard (module docstring)."""
    spec = schedulers.check_scorer(fused, score_fn, policy, embed)
    k = max(1, min(_ss.check_k(k), layout.shard_size))
    if pull_cost is None:
        pull_cost = kenv.pull_cost_now(state, cfg)
    use_fused = not heuristic and spec is None and score_fn is None and (
        fused in (True, "plain")
        or (fused == "auto"
            and layout.shard_size >= schedulers.FUSED_SCORE_MIN_NODES))
    device = state.base_cpu.device
    pods, single = _batch(pod, device)
    if spec is not None and not heuristic:
        st, rows = _pad_cluster(state, layout), PodSpec(*(x[:, None]
                                                          for x in pods))
        q = _shard_score_set(params, _cluster_rows(st, rows, cfg, pull_cost),
                             layout, spec, embed, fused)
        vals, idx = _ss.shard_topk(
            torch.where(kenv.feasible(st, rows, cfg), q, -torch.inf),
            layout.shards, layout.shard_size, k)
    elif use_fused:
        mode = "plain" if fused == "plain" else None
        vals, idx = ops.sdqn_topk_afterstate(
            state, pods, cfg, params, k=k, mode=mode, pull_cost=pull_cost,
            layout=layout)
    else:
        rows = PodSpec(*(x[:, None] for x in pods))      # (B, 1) -> (B, N)
        if heuristic:
            from repro_torch.sched.api import heuristic_score

            q = heuristic_score(state, rows, cfg=cfg)
        else:
            q = schedulers.score_afterstates_batch(
                params, state, pods, cfg, fused=fused, pull_cost=pull_cost,
                score_fn=score_fn)
        ok = kenv.feasible(state, rows, cfg)
        vals, idx = _ss.shard_topk(torch.where(ok, q, -torch.inf),
                                   layout.shards, layout.shard_size, k)
    return _finish(vals, idx, single)


def _delta_rows(job, delta, device):
    if delta is not None:
        return delta.to(device=device, dtype=torch.float32)
    if isinstance(job, _pl.JobSpec):
        return _pl.job_delta(job, device)
    return _pl.job_deltas(job, device)


def fleet_topk(params: dict, fleet: _pl.FleetState, job, layout: FleetLayout,
               *, k: int = 4, fused="auto", policy=None, embed=None,
               heuristic: bool = False, max_host_cpu_pct: float = 88.0,
               delta=None):
    """Two-stage feasible top-k over a FleetState fleet (job->host).

    Same contract as :func:`cluster_topk`; feasibility is
    ``PlacementEngine.feasible`` (healthy + post-delta cpu / mem / job-util
    ceilings), in-kernel on the fused path.  ``job`` is a ``JobSpec`` or a
    sequence of them; ``delta`` overrides it with pre-packed (6,) or
    (B, 6) afterstate delta rows (the daemon's batched path)."""
    spec = schedulers.check_scorer(fused, None, policy, embed)
    from repro_torch.sched.api import _fleet_mode, heuristic_delta_scores

    k = max(1, min(_ss.check_k(k), layout.shard_size))
    device = fleet.cpu_pct.device
    d = _delta_rows(job, delta, device)
    single = d.dim() == 1
    d = d.reshape(-1, 6)
    ceilings = (max_host_cpu_pct, _pl.MEM_CEILING_PCT,
                _pl.JOB_UTIL_CEILING_PCT)
    if spec is not None and not heuristic:
        ft = _pad_fleet(fleet, layout)
        q = _shard_score_set(params, _pl.afterstate_rows(ft, d), layout,
                             spec, embed, fused)
        ok = _pl.feasible_deltas(ft, d, max_host_cpu_pct)
        vals, idx = _ss.shard_topk(torch.where(ok, q, -torch.inf),
                                   layout.shards, layout.shard_size, k)
    elif not heuristic:
        vals, idx = ops.sdqn_topk_delta(_pl.fleet_cols(fleet), d, params, k=k,
                                        mode=_fleet_mode(fused),
                                        ceilings=ceilings, layout=layout)
    else:
        q = heuristic_delta_scores(fleet, d)
        ok = _pl.feasible_deltas(fleet, d, max_host_cpu_pct)
        vals, idx = _ss.shard_topk(torch.where(ok, q, -torch.inf),
                                   layout.shards, layout.shard_size, k)
    return _finish(vals, idx, single)


def topk(fleet, pod, *, params: dict, cfg=None, layout: FleetLayout,
         k: int = 4, fused="auto", score_fn=None, policy=None, embed=None,
         heuristic: bool = False):
    """Substrate-dispatching wrapper (``sched.api.score``'s rules)."""
    if isinstance(fleet, ClusterState):
        if cfg is None:
            raise ValueError("cfg (EnvConfig) is required to score a "
                             "ClusterState fleet")
        return cluster_topk(params, fleet, pod, cfg, layout, k=k, fused=fused,
                            score_fn=score_fn, policy=policy, embed=embed,
                            heuristic=heuristic)
    if isinstance(fleet, _pl.FleetState):
        if score_fn is not None:
            raise ValueError("score_fn is not supported on the FleetState "
                             "column-kernel path")
        return fleet_topk(params, fleet, pod, layout, k=k, fused=fused,
                          policy=policy, embed=embed, heuristic=heuristic)
    raise TypeError(f"unsupported fleet type: {type(fleet).__name__}")


def candidates_valid(vals: torch.Tensor) -> torch.Tensor:
    """0-d bool: no NaN and every *finite* candidate inside the divergence
    limit (``-inf`` marks infeasible slots and is legitimate here)."""
    finite = torch.isfinite(vals)
    bounded = torch.where(finite, vals.abs(), 0.0) <= _DIVERGENCE_LIMIT
    return bounded.all() & ~torch.isnan(vals).any()


def select_candidates(fleet, pod, *, params: dict, cfg=None,
                      layout: FleetLayout, k: int = 4, fused="auto",
                      score_fn=None, policy=None, embed=None,
                      guard: bool = False) -> torch.Tensor:
    """The merged candidate winner (0-d int32 on the fleet's device), or
    ``NO_PLACEMENT`` when every candidate is infeasible.  ``guard=True``
    swaps NaN/diverged candidates for the kube-heuristic list, computed
    through the same two-stage shape."""
    vals, idx = topk(fleet, pod, params=params, cfg=cfg, layout=layout, k=k,
                     fused=fused, score_fn=score_fn, policy=policy,
                     embed=embed)
    if guard:
        hvals, hidx = topk(fleet, pod, params=params, cfg=cfg, layout=layout,
                           k=k, fused=fused, heuristic=True)
        valid = candidates_valid(vals)
        vals = torch.where(valid, vals, hvals)
        idx = torch.where(valid, idx, hidx)
    none = torch.tensor(NO_PLACEMENT, dtype=torch.int32, device=idx.device)
    return torch.where(torch.isfinite(vals[..., 0]), idx[..., 0], none)


def sharded_scores(fleet, pod, *, params: dict, cfg=None,
                   layout: FleetLayout, fused="auto", score_fn=None,
                   policy=None, embed=None) -> torch.Tensor:
    """The (N,) score vector computed shard by shard (chunked evaluation
    on the card: the same scores as the flat program for pointwise
    scorers; block-local attention for the "attention" class)."""
    size = layout.shard_size
    if isinstance(fleet, ClusterState):
        if cfg is None:
            raise ValueError("cfg (EnvConfig) is required to score a "
                             "ClusterState fleet")
        spec = schedulers.check_scorer(fused, score_fn, policy, embed)
        pull = kenv.pull_cost_now(fleet, cfg)
        if spec is not None:
            pods, _ = _batch(pod, fleet.base_cpu.device)
            rows = PodSpec(*(x[:, None] for x in pods))
            feats = _cluster_rows(_pad_cluster(fleet, layout), rows, cfg, pull)
            return _shard_score_set(params, feats, layout, spec, embed,
                                    fused)[0, :fleet.n_nodes]

        def one(lo):
            sub = ClusterState(*(c[lo:lo + size] if c.dim() == 1 else c
                                 for c in fleet))
            return schedulers.score_afterstates(params, sub, pod, cfg,
                                                fused=fused, pull_cost=pull,
                                                score_fn=score_fn)
        n = fleet.n_nodes
    elif isinstance(fleet, _pl.FleetState):
        from repro_torch.sched import api as _api

        if score_fn is not None:
            raise ValueError("score_fn is not supported on the FleetState "
                             "column-kernel path")
        spec = schedulers.check_scorer(fused, None, policy, embed)
        if spec is not None:
            d = _pl.job_delta(pod, fleet.cpu_pct.device)[None]
            feats = _pl.afterstate_rows(_pad_fleet(fleet, layout), d)
            return _shard_score_set(params, feats, layout, spec, embed,
                                    fused)[0, :fleet.cpu_pct.shape[0]]

        def one(lo):
            sub = _pl.FleetState(*(c[lo:lo + size] for c in fleet))
            return _api._score_raw(sub, pod, params=params, fused=fused)
        n = fleet.cpu_pct.shape[0]
    else:
        raise TypeError(f"unsupported fleet type: {type(fleet).__name__}")
    return torch.cat([one(lo) for lo in range(0, n, size)])
