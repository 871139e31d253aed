"""Time the selective scan (kernel 6) and the row Q-net (kernel 2) on one
CUDA card, beside the launch floor.

    python3 scripts/scan_timings.py [--src DIR] [--label NAME] [--variants]
                                    [--bwd-variants]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default:
this checkout's), so that one run on a card can time another checkout's
package beside this one's, in turns.  Prints one JSON object a line:

* ``floor``: one empty kernel's device time in a CUDA graph
  (``torch.cuda._sleep(0)``), the launch floor;
* ``time``: device time per call from a CUDA graph of many calls (median
  of 5 replays; ``chip_smoke.graph_time_ms``), the device kernels one
  call runs (``chip_smoke.device_kernels``) and the largest difference to
  the plain version: kernel 6 at the mamba class's (1, 32, 8, 4) and at (2, 256,
  1024, 16), kernel 2 at N = 131,072 and 5,000;
* with ``--variants`` (a checkout that has ``mamba_scan.scan_plan``):
  kernel 6 at every built (SPL, L) of the shape's N and 4, 8 and 16 warps
  a block, at the two shapes above and at both with the other state
  sizes, each held to the plain version within 4e-5; and kernel 2 at
  every R of its launch plan (``sdqn_score.score_plan(n, 1)``);
* with ``--bwd-variants`` (a checkout that has ``mamba_scan.ScanBwdPlan``):
  kernel 6's backward at ``chip_smoke.SCAN_BWD_TIMED``, at every K its
  (N, SPL, L) is built for (``SCAN_BWD_BUILT``) and 4 and 8 warps a
  block: device time per call (CUDA graph of 10 calls), blocks an SM
  (``scan_bwd_occupancy``), the partials' bytes, and the largest error
  relative to each gradient's largest element against
  ``mamba_scan_bwd_plain`` (``chip_smoke.SCAN_BWD_TOL``).  Only these
  rows run under ``--bwd-variants`` alone.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import (SCAN_BWD_TIMED, SCAN_BWD_TOL,  # noqa: E402
                        SCAN_PATH, SCAN_TOL, SCAN_WIDE, _rel_err, _scan_args,
                        device_kernels, graph_time_ms)

ROWS_N = (131072, 5000)
# the path's and the wide shape at the other state sizes, for their plans
OTHER_N = ((1, 32, 8, 8), (1, 32, 8, 16), (2, 256, 1024, 8),
           (2, 256, 1024, 4))
SEED = 13


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--bwd-variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("scan_timings: no CUDA device is visible")
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.core import dqn, env
    from repro_torch.kernels import _build, mamba_scan as ms, sdqn_score as ss
    from repro_torch.sched import placement as pl

    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]

    def emit(kind, **kw):
        print(json.dumps(dict(kind=kind, label=args.label, card=smi, **kw)),
              flush=True)

    if args.bwd_variants and not args.variants:
        _build.build(["mamba_scan", "mamba_scan_bwd"])
        bwd_variants(ms, device, emit)
        return 0
    _build.build(["mamba_scan", "sdqn_score"])
    for src, log in _build.BUILD_LOG.items():
        for line in log["ptxas"].splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                emit("ptxas", source=src, line=line.strip())

    def err(got, want):
        return max(float((g - w).abs().max()) for g, w in zip(got, want))

    calls = {}
    for shape in (SCAN_PATH, SCAN_WIDE):
        a = _scan_args(shape, device, SEED)
        calls[("mamba_scan", shape)] = (
            lambda a=a: ms.mamba_scan(*a), lambda a=a: ms.mamba_scan_plain(*a))
    for n in ROWS_N:
        gen = torch.Generator().manual_seed(SEED + n)
        feats = env.normalize_features(pl.fresh_fleet(n, gen, device=device)
                                       .features()).contiguous()
        p = dqn.init_qnet(gen, device=device)
        w = (p["w1"], p["b1"], p["w2"], p["b2"])
        calls[("sdqn_score", n)] = (
            lambda f=feats, w=w: ss.sdqn_score(f, *w),
            lambda f=feats, w=w: ss.sdqn_score_plain(f, *w))

    emit("floor", ms=graph_time_ms(lambda: torch.cuda._sleep(0), 200))
    for (name, shape), (fn, plain) in calls.items():
        got, want = fn(), plain()
        if name == "sdqn_score":
            got, want = (got,), (want,)
        emit("time", name=name, shape=shape, ms=graph_time_ms(fn, 100),
             device_kernels=device_kernels(fn), max_abs_err=err(got, want))

    if args.variants and hasattr(ms, "scan_plan"):
        scan_plan = ms.scan_plan
        for shape in (SCAN_PATH, SCAN_WIDE) + OTHER_N:
            a = _scan_args(shape, device, SEED)

            def fn(a=a):
                return ms.mamba_scan(*a)
            want = ms.mamba_scan_plain(*a)
            b, _, di, n = shape
            emit("scan_plan", shape=shape, plan=str(scan_plan(b, di, n)))
            for n_, spl, seg in ms.SCAN_BUILT:
                if n_ != n:
                    continue
                for warps in (4, 8, 16):
                    plan = ms.ScanPlan.of(b, di, n, spl, seg, warps)
                    ms.scan_plan = lambda b_, di_, n__, plan=plan: plan
                    try:
                        e = err(fn(), want)
                        emit("scan_variant", shape=shape, states=spl,
                             seg_len=seg, warps=warps, chunk=plan.chunk,
                             blocks=plan.blocks, ms=graph_time_ms(fn, 100),
                             max_abs_err=e, ok=e <= SCAN_TOL)
                    except RuntimeError as ex:
                        emit("scan_variant", shape=shape, states=spl,
                             seg_len=seg, warps=warps, error=str(ex)[:200])
                    finally:
                        ms.scan_plan = scan_plan
    if args.variants:
        score_plan = ss.score_plan
        for n in ROWS_N:
            fn, plain = calls[("sdqn_score", n)]
            want = plain()
            emit("row_plan", n=n, plan=str(score_plan(n, 1)))
            for rows in ss.SCORE_ROWS:
                plan = ss.ScorePlan.of(n, 1, rows)
                ss.score_plan = lambda n_, b_, plan=plan: plan
                try:
                    emit("row_variant", n=n, rows=rows,
                         pod_rows=plan.pod_rows, blocks=plan.blocks,
                         ms=graph_time_ms(fn, 100),
                         max_abs_err=err((fn(),), (want,)))
                finally:
                    ss.score_plan = score_plan
    if args.bwd_variants:
        bwd_variants(ms, device, emit)
    return 0


def bwd_variants(ms, device, emit):
    """Kernel 6's backward at every built K and 4 and 8 warps a block, at
    ``SCAN_BWD_TIMED`` (see the module docstring)."""
    plan_of = ms.scan_bwd_plan
    for shape in SCAN_BWD_TIMED:
        b, s, di, n = shape
        a = _scan_args(shape, device, SEED)
        _, _, states = ms.mamba_scan_fwd(*a)
        dy = torch.randn((b, s, di), device=device,
                         generator=torch.Generator(device).manual_seed(SEED))

        def call(a=a, states=states, dy=dy):
            return ms.mamba_scan_bwd(*a[:6], states, dy, None, need_dh0=False)
        want = ms.mamba_scan_bwd_plain(*a[:6], states, dy, None,
                                       need_dh0=False)
        chosen = plan_of(b, di, n)
        emit("scan_bwd_plan", shape=shape, plan=str(chosen))
        for k in ms.SCAN_BWD_BUILT[(n, chosen.states, chosen.seg_len)]:
            for warps in (4, 8):
                plan = ms.ScanBwdPlan.of(b, di, n, chosen.states,
                                         chosen.seg_len, warps, k)
                ms.scan_bwd_plan = lambda b_, di_, n_, plan=plan: plan
                try:
                    got = call()
                    rel = max(_rel_err(g, w) for g, w in zip(got[:6],
                                                              want[:6]))
                    emit("scan_bwd_variant", shape=shape, per_warp=k,
                         warps=warps, blocks=plan.blocks,
                         blocks_per_sm=ms.scan_bwd_occupancy(plan),
                         shared_bytes=plan.shared_bytes,
                         partial_bytes=8 * b * plan.grid[0] * s * n,
                         ms=graph_time_ms(call, 10), max_rel_err=rel,
                         ok=rel <= SCAN_BWD_TOL)
                except RuntimeError as ex:
                    emit("scan_bwd_variant", shape=shape, per_warp=k,
                         warps=warps, error=str(ex)[:300])
                finally:
                    ms.scan_bwd_plan = plan_of
        del a, states, dy, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
