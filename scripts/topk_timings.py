"""Time the sharded top-k kernels (4 and 5) on one CUDA card, beside the
scoring kernels 1 and 3 whose arithmetic they share.

    python3 scripts/topk_timings.py [--src DIR] [--label NAME] [--variants]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so that one run on a card can time another checkout's
package beside this one's, in turns.  Prints one JSON object a line:

* ``time``: device time per call from a CUDA graph of 100 calls (median
  of 5 replays; ``chip_smoke.graph_time_ms``) of each wrapper, and the
  device kernels one call runs (``chip_smoke.device_kernels``): kernels 4
  and 5 at N = 131,072, 8 shards, k = 8 and B = 1 and 32; kernel 3 at
  N = 131,072, B = 1 and 32; kernel 1 at the flat cluster path's
  N = 5,000, B = 1 and 32, and at N = 131,072, B = 32;
* ``floor``: one empty kernel's device time in the same kind of graph
  (``torch.cuda._sleep(0)``), the launch floor;
* ``bitwise``: kernel 4's (5's) finite candidates that differ from kernel
  1's (3's) score of the same (pod, node) pair, at B = 1 and 32;
* with ``--variants`` (a checkout that has the plans): every (P, C) of the
  top-k launch at B = 1 and 32, and every R of the scoring kernels'
  launch (``sdqn_score.score_plan``) at the timed shapes, each held to
  the default plan's output exactly.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import device_kernels, graph_time_ms  # noqa: E402

N, SHARDS, K, FLAT_N = 131072, 8, 8, 5000
SEED = 7


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("topk_timings: no CUDA device is visible")
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch import convert
    from repro_torch.core import dqn, env
    from repro_torch.core.types import fleet_cluster
    from repro_torch.kernels import _build, ops, sdqn_score as ss
    from repro_torch.sched import placement as pl

    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]

    def emit(kind, **kw):
        print(json.dumps(dict(kind=kind, label=args.label, card=smi, **kw)),
              flush=True)

    _build.build(["sdqn_score_afterstate", "sdqn_score_cols",
                  "sdqn_score_afterstate_topk"])
    for src, log in _build.BUILD_LOG.items():
        for line in log["ptxas"].splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                emit("ptxas", source=src, line=line.strip())

    def cluster_case(n, b, seed):
        cfg = dataclasses.replace(fleet_cluster(n), unhealthy_prob=0.2,
                                  randomize_workload=True)
        gen = torch.Generator().manual_seed(seed)
        state = env.reset(gen, cfg, device=device)
        params = dqn.init_qnet(gen, device=device)
        rng = np.random.default_rng(seed)
        pods = convert.pods_from_numpy(rng.uniform(50, 900, b),
                                       rng.uniform(5, 700, b),
                                       rng.uniform(64, 2048, b),
                                       rng.uniform(32, 1800, b),
                                       device=device)
        return cfg, state, params, pods

    def job_deltas(b, seed):
        rng = np.random.default_rng(seed)
        return pl.job_deltas([pl.JobSpec(c, m) for c, m in zip(
            rng.uniform(1, 10, b).tolist(), rng.uniform(0.5, 5, b).tolist())],
            device)

    shard_size = -(-N // SHARDS)
    geo = dict(k=K, shards=SHARDS, shard_size=shard_size)
    fleet = pl.fresh_fleet(N, torch.Generator().manual_seed(SEED + 1),
                           device=device)
    cols = pl.fleet_cols(fleet)
    calls = {}
    for b in (1, 32):
        cfg, state, params, pods = cluster_case(N, b, SEED + b)
        a_in = ops._afterstate_inputs(state, pods, cfg, params)
        t_cols = a_in[0] + (state.cpu_requested, state.mem_requested)
        creq = ops._pod_column(pods.cpu_request, device)
        mreq = ops._pod_column(pods.mem_request, device)
        deltas = job_deltas(b, SEED + 2 + b)
        w = a_in[4:]
        calls[("sdqn_score_afterstate_topk", b, N)] = (
            lambda t_cols=t_cols, a_in=a_in, creq=creq, mreq=mreq:
            ss.sdqn_score_afterstate_topk(t_cols, a_in[1], a_in[2], creq,
                                          mreq, *a_in[3:], **geo))
        calls[("sdqn_score_cols_topk", b, N)] = (
            lambda deltas=deltas, w=w: ss.sdqn_score_cols_topk(
                cols, deltas, ops.FEATURE_SCALE, *w, ops.DEFAULT_CEILINGS,
                **geo))
        calls[("sdqn_score_cols", b, N)] = (
            lambda deltas=deltas, w=w: ss.sdqn_score_cols(
                cols, deltas, ops.FEATURE_SCALE, *w))
        if b == 32:
            calls[("sdqn_score_afterstate", b, N)] = (
                lambda a_in=a_in: ss.sdqn_score_afterstate(*a_in))
        # bit for bit: the top-k values against the scoring kernels
        q1 = ops.sdqn_score_afterstate(state, pods, cfg, params)
        q3 = ops.sdqn_score_delta(cols, deltas, params)
        for key, q in (("sdqn_score_afterstate_topk", q1),
                       ("sdqn_score_cols_topk", q3)):
            v, i = calls[(key, b, N)]()
            real = i >= 0
            at = torch.gather(q, 1, i.clamp(min=0).flatten(1)).view_as(v)
            emit("bitwise", name=key, b=b, candidates=int(real.sum()),
                 differ=int((v[real] != at[real]).sum()),
                 max_abs_diff=float((v[real] - at[real]).abs().max()))
    for b in (1, 32):
        cfg, state, params, pods = cluster_case(FLAT_N, b, SEED)
        a_flat = ops._afterstate_inputs(state, pods, cfg, params)
        calls[("sdqn_score_afterstate", b, FLAT_N)] = (
            lambda a_flat=a_flat: ss.sdqn_score_afterstate(*a_flat))

    emit("floor", ms=graph_time_ms(lambda: torch.cuda._sleep(0), 100))
    for (name, b, n), fn in calls.items():
        emit("time", name=name, n=n, b=b, ms=graph_time_ms(fn, 100),
             device_kernels=device_kernels(fn))

    if args.variants and hasattr(ss, "score_plan"):
        score_plan = ss.score_plan
        for (name, b, n), fn in calls.items():
            if name not in ("sdqn_score_afterstate", "sdqn_score_cols"):
                continue
            want = fn().clone()
            emit("score_plan", name=name, n=n, b=b,
                 plan=dataclasses.asdict(score_plan(n, b)))
            for rows in ss.SCORE_ROWS:
                plan = ss.ScorePlan.of(n, b, rows)
                ss.score_plan = lambda n_, b_, plan=plan: plan
                try:
                    same = torch.equal(fn(), want)
                    emit("score_variant", name=name, n=n, b=b, rows=rows,
                         pod_rows=plan.pod_rows, blocks=plan.blocks,
                         ms=graph_time_ms(fn, 100), same=same)
                except RuntimeError as e:
                    emit("score_variant", name=name, n=n, b=b, rows=rows,
                         error=str(e)[:200])
                finally:
                    ss.score_plan = score_plan
    if args.variants:
        plan_fn = ss.topk_plan
        for b in (1, 32):
            for name in ("sdqn_score_afterstate_topk", "sdqn_score_cols_topk"):
                fn = calls[(name, b, N)]
                want = [t.clone() for t in fn()]
                emit("plan", name=name, b=b, plan=dataclasses.asdict(
                    plan_fn(N, b, SHARDS, shard_size)))
                for pods_ in (1, 2):
                    if pods_ > b:
                        continue
                    for c in (1, 2, 4, 8):
                        def plan(n, b_, shards, size, pods_=pods_, c=c):
                            p = plan_fn(n, b_, shards, size)
                            return dataclasses.replace(
                                p, pods=pods_, cluster=c, chunk=-(-size // c),
                                grid=(shards * c, -(-b_ // pods_), 1))
                        ss.topk_plan = plan
                        try:
                            got = fn()
                            same = all(torch.equal(g, w_)
                                       for g, w_ in zip(got, want))
                            emit("variant", name=name, b=b, pods=pods_,
                                 cluster=c, ms=graph_time_ms(fn, 100), same=same)
                        except RuntimeError as e:
                            emit("variant", name=name, b=b, pods=pods_,
                                 cluster=c, error=str(e)[:200])
                        finally:
                            ss.topk_plan = plan_fn
    return 0


if __name__ == "__main__":
    sys.exit(main())
