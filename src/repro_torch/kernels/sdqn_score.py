"""Fused SDQN scoring kernels (port of ``repro.kernels.sdqn_score``).

Five kernels, each in two versions of one function:

* ``<name>_plain`` — plain PyTorch with the arithmetic of the reference's
  ``*_xla`` twin (broadcast multiply-accumulates, no GEMM) over an explicit
  batch of B pods or deltas.  The CPU tests use it and ``chip_smoke.py``
  holds the kernel to it.
* ``<name>`` — the wrapper: on CUDA tensors it launches the hand-written
  kernel under ``csrc/`` once for the whole batch and counts the launch in
  ``<name>.launches``; on CPU tensors it runs the plain version.  Any other
  device raises.

| wrapper                      | reference (``repro.kernels.sdqn_score``) | source |
| ---------------------------- | ---------------------------------------- | ------ |
| ``sdqn_score_afterstate``      | ``sdqn_score_afterstate``                | ``sdqn_score_afterstate.cu`` |
| ``sdqn_score``                 | ``sdqn_score``                           | ``sdqn_score.cu`` |
| ``sdqn_score_cols``            | ``sdqn_score_cols``                      | ``sdqn_score_cols.cu`` |
| ``sdqn_score_afterstate_topk`` | ``sdqn_score_afterstate_topk``           | ``sdqn_score_afterstate_topk.cu`` |
| ``sdqn_score_cols_topk``       | ``sdqn_score_cols_topk``                 | ``sdqn_score_cols.cu`` |

The top-k kernels take a shard geometry (``shards`` slices of
``shard_size`` nodes, the last one ragged) and return each shard's top-k
as ``(B, shards, k)`` values and GLOBAL node indices: sorted descending
with NaN above every number, ties by ascending index, and ``-1`` for
every slot that is not finite (``-inf`` = infeasible or exhausted).  One
launch computes all of it; ``topk_plan`` sets the launch's geometry, and
``score_plan`` that of the scoring kernels 1, 2 (at B = 1) and 3.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels import _build, ref

# scalar-pack layout (the reference's ``_S_*``).  On the card the per-pod
# demands and requests ride as (B,) columns instead of slots 0/1/12/13,
# and b2 is read from the params tensor on the device, so slots 0, 1, 11,
# 12 and 13 of the host pack are unused by the CUDA path.
_S_CPU_DEMAND, _S_MEM_DEMAND, _S_PULL, _S_WARM, _S_OVERHEAD = 0, 1, 2, 3, 4
_S_CROWD_KNEE, _S_CROWD_COEFF, _S_CONT_KNEE, _S_CONT_COEFF = 5, 6, 7, 8
_S_UPTIME_SCALE, _S_EXP_SCALE, _S_B2 = 9, 10, 11
_S_CPU_REQ, _S_MEM_REQ = 12, 13
_N_SCALARS = 16

# the 12 raw node columns, in kernel argument order, with their dtypes; the
# top-k kernel adds the two filtering-phase columns
COLUMNS = ("base_cpu", "pods_cpu", "startup_cpu", "num_pods", "exp_pods",
           "mem_used", "image_cached", "healthy", "uptime_hours",
           "cpu_capacity", "mem_capacity", "max_pods")
COLUMN_DTYPES = (torch.float32, torch.float32, torch.float32, torch.int32,
                 torch.int32, torch.float32, torch.bool, torch.bool,
                 torch.float32, torch.float32, torch.float32, torch.int32)
TOPK_COLUMNS = COLUMNS + ("cpu_requested", "mem_requested")
TOPK_COLUMN_DTYPES = COLUMN_DTYPES + (torch.float32, torch.float32)
KERNEL_SOURCE = "sdqn_score_afterstate"
SCORE_SOURCE = "sdqn_score"
COLS_SOURCE = "sdqn_score_cols"
TOPK_SOURCE = "sdqn_score_afterstate_topk"
HIDDEN = 32
TOPK_MAX = 8        # candidates per shard the top-k kernels keep, at most

_F32 = torch.float32


# ---------------------------------------------------------------------------
# shared plumbing (checks and the launch live in ``_build``), top-k merges
# ---------------------------------------------------------------------------


_check, _on_card, _launch = _build.check, _build.on_card, _build.launch
_refuse_grad = _build.refuse_grad
_P, _F, _I = _build.P, _build.F, _build.I


def _check_weights(w1, b1, w2, b2, device):
    _check("w1", w1, _F32, (6, HIDDEN), device)
    _check("b1", b1, _F32, (HIDDEN,), device)
    _check("w2", w2, _F32, (HIDDEN, 1), device)
    _check("b2", b2, _F32, (1,), device)


def merge_topk(vals, idx, k: int):
    """Merge ``(..., G, k')`` candidate sets into ``(..., k)``: descending
    value (NaN above every number), ties in ascending flat position.

    A stable sort, not ``torch.topk``, which promises no order among ties:
    groups cover ascending index ranges and list their ties lowest index
    first, so ascending flat position is ascending node index and the
    merged winner is the flat first-occurrence argmax."""
    v = vals.flatten(-2)
    v, pos = torch.sort(v, dim=-1, descending=True, stable=True)
    return v[..., :k], torch.gather(idx.flatten(-2), -1, pos[..., :k])


def shard_topk(masked, shards: int, shard_size: int, k: int):
    """Each shard's top-k of masked (B, N) scores: ``(B, shards, k)``
    values and global indices (``-1`` where not finite).  The ragged end
    of the last shard fills with ``-inf``, so it never outranks a node."""
    b, n = masked.shape
    pad = shards * shard_size - n
    if pad:
        masked = torch.cat([masked, masked.new_full((b, pad), -torch.inf)],
                           dim=1)
    v, pos = torch.sort(masked.view(b, shards, shard_size), dim=-1,
                        descending=True, stable=True)
    v, pos = v[..., :k], pos[..., :k].to(torch.int32)
    offs = (torch.arange(shards, dtype=torch.int32, device=masked.device)
            * shard_size)[:, None]
    return v, torch.where(torch.isfinite(v), pos + offs, -1)


def check_k(k: int) -> int:
    """``k`` candidates per shard, at most ``TOPK_MAX`` (the lists the
    top-k kernels keep in registers).  Held on every device, so a ``k``
    the card would refuse fails on the CPU as well."""
    if k > TOPK_MAX:
        raise ValueError(f"k={k} candidates per shard: the top-k kernels "
                         f"keep at most TOPK_MAX={TOPK_MAX}")
    return k


def _check_topk(name, n, k, shards, shard_size):
    if not 1 <= k <= min(TOPK_MAX, shard_size):
        raise ValueError(f"{name}: k={k} outside [1, min({TOPK_MAX}, "
                         f"shard_size={shard_size})]")
    if shards < 1 or shards > 65535 or shards * shard_size < n:
        raise ValueError(f"{name}: {shards} shards of {shard_size} do not "
                         f"cover N={n}")
    if shards * shard_size + shard_size >= 2 ** 31:
        raise ValueError(f"{name}: {shards} shards of {shard_size} overflow "
                         f"the kernels' int32 node indices")


# Launch geometry of the top-k kernels (csrc/topk_cluster.cuh).  A cluster
# of C blocks takes one (shard, group of P pods); block rank r of it sweeps
# the shard's nodes [r * chunk, (r + 1) * chunk).  P and the number of
# blocks that fill the card were measured on an H100 SXM
# (scripts/topk_timings.py, PERF.md section 6).
TOPK_THREADS = 256           # threads per block: SDQN_BLOCK
TOPK_PODS = 2                # pods (or jobs) a thread scores per node
TOPK_CLUSTER_MAX = 8         # the portable cluster size
TOPK_FILL_BLOCKS = 264       # blocks that fill the card: 2 on each of 132 SMs
TOPK_MIN_CHUNK = 1024        # nodes a block sweeps at least (4 per thread)


@dataclasses.dataclass(frozen=True)
class TopkPlan:
    grid: tuple          # (shards * cluster, ceil(B / pods), 1)
    cluster: int         # blocks per cluster, along x
    pods: int            # P: pods per thread, 1 or 2
    chunk: int           # nodes of the shard per block
    shared_bytes: int    # static shared memory per block

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def topk_plan(n: int, b: int, shards: int, shard_size: int) -> TopkPlan:
    """The top-k kernels' launch for B pods over ``shards`` slices of
    ``shard_size`` of N nodes: P = ``TOPK_PODS`` (1 at B = 1), and C the
    largest cluster that keeps the grid within ``TOPK_FILL_BLOCKS`` (one
    wave), at most ``TOPK_CLUSTER_MAX`` and with at least
    ``TOPK_MIN_CHUNK`` nodes a block."""
    del n                               # the last shard is masked by index
    pods = min(TOPK_PODS, b)
    groups = -(-b // pods)
    cluster = max(1, min(TOPK_CLUSTER_MAX,
                         TOPK_FILL_BLOCKS // (shards * groups),
                         -(-shard_size // TOPK_MIN_CHUNK)))
    # s_w (32 float4 pairs), s_b2 (4, padded to 8), each warp's and the
    # block's lists of 8-byte candidates per pod
    shared = (HIDDEN * 32 + 8
              + pods * (TOPK_THREADS // 32 + 1) * TOPK_MAX * 8)
    return TopkPlan(grid=(shards * cluster, groups, 1), cluster=cluster,
                    pods=pods, chunk=-(-shard_size // cluster),
                    shared_bytes=shared)


# Launch geometry of the scoring kernels 1 and 3 (csrc/sdqn_common.cuh,
# ``ScoreRows``).  A thread scores R rows, (pod, node) pairs, reading each
# hidden unit's weights once for them: a node's R pods where B >= R, else
# R nodes for one pod.  R and the block count that fills the card were
# measured on an H100 SXM (scripts/topk_timings.py --variants, PERF.md
# section 6): the fastest R at every timed shape is the largest whose grid
# keeps 256 blocks, about 2 on each of the 132 SMs.  Splitting a row's
# hidden units over lanes, to fill the card at N = 5000 and B = 1, was
# slower at every split and is not built.
SCORE_THREADS = TOPK_THREADS   # threads per block: SDQN_BLOCK
SCORE_ROWS = (8, 4, 2, 1)    # R the kernels are built for, largest first
SCORE_FILL_BLOCKS = 256      # blocks the largest R must still give


@dataclasses.dataclass(frozen=True)
class ScorePlan:
    grid: tuple          # (x, y, 1)
    rows: int            # R: rows a thread scores
    pod_rows: bool       # a thread's R rows are one node's pods (B >= R)

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @classmethod
    def of(cls, n: int, b: int, rows: int) -> "ScorePlan":
        """The grid for R = ``rows`` over N nodes and B pods: pod rows
        where B >= R, else node rows."""
        if b >= rows:
            return cls((-(-n // SCORE_THREADS), -(-b // rows), 1), rows, True)
        return cls((-(-n // (SCORE_THREADS * rows)), b, 1), rows, False)

    def args(self) -> tuple:
        """The launch functions' (rows, pod_rows, grid_x, grid_y)."""
        return self.rows, int(self.pod_rows), self.grid[0], self.grid[1]


@functools.lru_cache(maxsize=256)
def score_plan(n: int, b: int) -> ScorePlan:
    """The scoring kernels' launch for B pods over N nodes: the largest R
    of ``SCORE_ROWS`` whose grid keeps ``SCORE_FILL_BLOCKS`` blocks, else
    R = 1."""
    for rows in SCORE_ROWS:
        plan = ScorePlan.of(n, b, rows)
        if plan.blocks >= SCORE_FILL_BLOCKS:
            return plan
    return plan


def _check_score_shape(name, n, b):
    if n < 1 or not 1 <= b <= 65535 or n * b >= 2 ** 31:   # grid.y <= B
        raise ValueError(f"{name}: unsupported shape N={n}, B={b}")


# ---------------------------------------------------------------------------
# kernel 1: afterstate scoring from raw ClusterState columns
# ---------------------------------------------------------------------------


def _afterstate_norm_features(base_cpu, pods_cpu, startup_cpu, num_pods,
                              exp_pods, mem_used, cached, healthy, uptime,
                              cap, mem_cap, max_pods, cpu_demand, mem_demand,
                              s):
    """Normalized Table-2 afterstate features, elementwise.

    Columns are (N,) float32; ``cpu_demand`` / ``mem_demand`` are (B, 1), so
    the two pod-dependent features come out (B, N) and the other four (N,).
    ``s(i)`` reads scalar ``i`` of the pack as a Python float."""
    start_cost = torch.where(cached > 0.5, s(_S_WARM), s(_S_PULL))
    num_pods1 = num_pods + 1.0
    exp_pods1 = exp_pods + 1.0
    crowd = torch.clamp(num_pods1 - s(_S_CROWD_KNEE), min=0.0)
    # the placed node is always active, so the overhead term is unconditional
    raw = (base_cpu + s(_S_OVERHEAD) + pods_cpu + cpu_demand
           + startup_cpu + start_cost + s(_S_CROWD_COEFF) * crowd * crowd)
    util = raw / cap
    over = torch.clamp(util - s(_S_CONT_KNEE), min=0.0)
    used = torch.minimum(raw + s(_S_CONT_COEFF) * over * over * cap, cap)
    return (
        used / cap,                                  # 100 * used/cap, /100
        (mem_used + mem_demand) / mem_cap,           # 100 * mem/cap, /100
        num_pods1 / max_pods,                        # 100 * pods/max, /100
        healthy,
        uptime / s(_S_UPTIME_SCALE),
        exp_pods1 / s(_S_EXP_SCALE),
    )


def sdqn_score_afterstate_plain(cols, cpu_demand, mem_demand, scalars,
                                w1, b1, w2, b2) -> torch.Tensor:
    """Q-values (B, N) of every (pod, node) afterstate, plain PyTorch."""
    cols = [c.to(_F32) for c in cols]

    def s(i):
        return float(scalars[i])

    feats = _afterstate_norm_features(*cols, cpu_demand[:, None],
                                      mem_demand[:, None], s)
    hid = b1                                         # (H,)
    for f in range(6):
        hid = hid + feats[f][..., None] * w1[f]      # -> (B, N, H)
    return torch.sum(torch.clamp(hid, min=0.0) * w2[:, 0], dim=-1) + b2[0]


def _check_afterstate(names, dtypes, cols, pod_cols, w1, b1, w2, b2):
    """Check the columns, the (B,) pod columns and the weights; (N, B)."""
    device = cols[0].device
    n = cols[0].shape[0]
    b = pod_cols[0].shape[0]
    if len(cols) != len(names):
        raise ValueError(f"want {len(names)} columns, got {len(cols)}")
    for name, col, dtype in zip(names, cols, dtypes):
        _check(name, col, dtype, (n,), device)
    for i, col in enumerate(pod_cols):
        _check(f"pod column {i}", col, _F32, (b,), device)
    _check_weights(w1, b1, w2, b2, device)
    return n, b


def _scalar_args(scalars):
    scalars = np.asarray(scalars, np.float32)
    return [float(scalars[i]) for i in range(_S_PULL, _S_EXP_SCALE + 1)]


def sdqn_score_afterstate(cols, cpu_demand, mem_demand, scalars, w1, b1, w2,
                          b2) -> torch.Tensor:
    """Q-values (B, N): one kernel launch on CUDA, the plain version on CPU.

    ``cols``: the 12 raw (N,) columns of ``COLUMNS`` in their native dtypes;
    ``cpu_demand`` / ``mem_demand``: (B,) float32; ``scalars``: the (16,)
    float32 host pack (numpy); ``w1 (6, 32)``, ``b1 (32,)``, ``w2 (32, 1)``,
    ``b2 (1,)`` float32 on the columns' device."""
    device = cols[0].device
    if not _on_card("sdqn_score_afterstate", device):
        return sdqn_score_afterstate_plain(cols, cpu_demand, mem_demand,
                                           scalars, w1, b1, w2, b2)
    _refuse_grad("sdqn_score_afterstate",
                 (cols, cpu_demand, mem_demand, w1, b1, w2, b2))
    n, b = _check_afterstate(COLUMNS, COLUMN_DTYPES, cols,
                             (cpu_demand, mem_demand), w1, b1, w2, b2)
    _check_score_shape("sdqn_score_afterstate", n, b)
    q = torch.empty((b, n), dtype=_F32, device=device)
    _launch("sdqn_score_afterstate", KERNEL_SOURCE,
            [_P] * 14 + [_F] * 9 + [_P] * 5 + [_I] * 6, device,
            *cols, cpu_demand, mem_demand, *_scalar_args(scalars),
            w1, b1, w2, b2, q, n, b, *score_plan(n, b).args())
    sdqn_score_afterstate.launches += 1
    return q


sdqn_score_afterstate.launches = 0


# ---------------------------------------------------------------------------
# kernel 2: the Q-net on built, normalized (N, 6) feature rows
# ---------------------------------------------------------------------------


# the plain version is the reference's unfused oracle itself
sdqn_score_plain = ref.sdqn_score_ref


def sdqn_score(feats, w1, b1, w2, b2) -> torch.Tensor:
    """Q (N,) of normalized (N, 6) float32 rows: one launch on CUDA, at
    ``score_plan(n, 1)`` (``feats`` 8-byte aligned there: the kernel reads
    a row's features in pairs)."""
    device = feats.device
    if not _on_card("sdqn_score", device):
        return sdqn_score_plain(feats, w1, b1, w2, b2)
    _refuse_grad("sdqn_score", (feats, w1, b1, w2, b2))
    n = feats.shape[0]
    _check("feats", feats, _F32, (n, 6), device)
    _check_weights(w1, b1, w2, b2, device)
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"unsupported shape: N={n}")
    if feats.data_ptr() % 8:
        raise ValueError("sdqn_score: feats is not 8-byte aligned")
    q = torch.empty((n,), dtype=_F32, device=device)
    _launch("sdqn_score", SCORE_SOURCE, [_P] * 6 + [_I] * 4, device,
            feats, w1, b1, w2, b2, q, n, *score_plan(n, 1).args()[:3])
    sdqn_score.launches += 1
    return q


sdqn_score.launches = 0


# ---------------------------------------------------------------------------
# kernel 3: Q((cols + delta) / scale) for job->host fleets, B deltas
# ---------------------------------------------------------------------------


def sdqn_score_cols_plain(cols, deltas, scale, w1, b1, w2, b2) -> torch.Tensor:
    """Q (B, N) for six raw (N,) columns and (B, 6) deltas; ``scale`` the
    six normalizers (host floats), folded into ``w1`` as the reference
    does.  No host->device copy, so a CUDA graph can capture it."""
    w1n = torch.stack([w1[f] / float(scale[f]) for f in range(6)])
    hid = b1                                         # (H,)
    for f in range(6):
        x = cols[f].to(_F32) + deltas[:, f:f + 1]    # (B, N)
        hid = hid + x[..., None] * w1n[f]            # -> (B, N, H)
    return torch.sum(torch.clamp(hid, min=0.0) * w2[:, 0], dim=-1) + b2[0]


def _check_cols(name, cols, deltas, w1, b1, w2, b2):
    device = cols[0].device
    n = cols[0].shape[0]
    b = deltas.shape[0]
    if len(cols) != 6:
        raise ValueError(f"{name}: want 6 columns, got {len(cols)}")
    for i, col in enumerate(cols):
        _check(f"column {i}", col, _F32, (n,), device)
    _check("deltas", deltas, _F32, (b, 6), device)
    _check_weights(w1, b1, w2, b2, device)
    _check_score_shape(name, n, b)
    return n, b


def sdqn_score_cols(cols, deltas, scale, w1, b1, w2, b2) -> torch.Tensor:
    """Q (B, N): one launch on CUDA for all B deltas.  ``cols`` six (N,)
    float32 columns, ``deltas`` (B, 6) float32, ``scale`` six host
    floats."""
    device = cols[0].device
    if not _on_card("sdqn_score_cols", device):
        return sdqn_score_cols_plain(cols, deltas, scale, w1, b1, w2, b2)
    _refuse_grad("sdqn_score_cols", (cols, deltas, w1, b1, w2, b2))
    n, b = _check_cols("sdqn_score_cols", cols, deltas, w1, b1, w2, b2)
    q = torch.empty((b, n), dtype=_F32, device=device)
    _launch("sdqn_score_cols", COLS_SOURCE,
            [_P] * 7 + [_F] * 6 + [_P] * 5 + [_I] * 6, device,
            *cols, deltas, *(float(x) for x in scale), w1, b1, w2, b2, q,
            n, b, *score_plan(n, b).args())
    sdqn_score_cols.launches += 1
    return q


sdqn_score_cols.launches = 0


# ---------------------------------------------------------------------------
# kernel 4: afterstate scoring + k8s filter + per-shard top-k
# ---------------------------------------------------------------------------


def sdqn_score_afterstate_topk_plain(cols, cpu_demand, mem_demand,
                                     cpu_request, mem_request, scalars, w1,
                                     b1, w2, b2, *, k, shards, shard_size):
    """((B, shards, k) values, indices): kernel 1's scores, masked by the
    filtering phase (``env.feasible``), reduced per shard."""
    q = sdqn_score_afterstate_plain(cols[:12], cpu_demand, mem_demand,
                                    scalars, w1, b1, w2, b2)
    c = [x.to(_F32) for x in cols]
    ok = ((c[7] > 0.5)
          & (c[12] + cpu_request[:, None] <= c[9])
          & (c[13] + mem_request[:, None] <= c[10])
          & (c[3] < c[11]))
    return shard_topk(torch.where(ok, q, -torch.inf), shards, shard_size, k)


def _launch_topk(name, source, argtypes, device, args, n, b, k, shards,
                 shard_size):
    """One launch of a top-k kernel: ``(B, shards, k)`` values, indices."""
    plan = topk_plan(n, b, shards, shard_size)
    if n < 1 or b < 1 or plan.grid[1] > 65535:
        raise ValueError(f"{name}: unsupported shape N={n}, B={b}")
    vals = torch.empty((b, shards, k), dtype=_F32, device=device)
    idx = torch.empty((b, shards, k), dtype=torch.int32, device=device)
    _launch(name, source, argtypes, device, *args, vals, idx, n, b, k,
            shards, shard_size, plan.cluster, plan.pods, plan.chunk)
    return vals, idx


def sdqn_score_afterstate_topk(cols, cpu_demand, mem_demand, cpu_request,
                               mem_request, scalars, w1, b1, w2, b2, *, k,
                               shards, shard_size):
    """Per-shard feasible top-k: one kernel launch on CUDA, the plain
    version on CPU.

    ``cols``: the 14 (N,) columns of ``TOPK_COLUMNS`` in their native
    dtypes; the four pod columns (B,) float32; the rest as for
    ``sdqn_score_afterstate``.  ``k <= TOPK_MAX`` on every device."""
    check_k(k)
    device = cols[0].device
    if not _on_card("sdqn_score_afterstate_topk", device):
        return sdqn_score_afterstate_topk_plain(
            cols, cpu_demand, mem_demand, cpu_request, mem_request, scalars,
            w1, b1, w2, b2, k=k, shards=shards, shard_size=shard_size)
    _refuse_grad("sdqn_score_afterstate_topk",
                 (cols, cpu_demand, mem_demand, cpu_request, mem_request, w1,
                  b1, w2, b2))
    n, b = _check_afterstate(TOPK_COLUMNS, TOPK_COLUMN_DTYPES, cols,
                             (cpu_demand, mem_demand, cpu_request,
                              mem_request), w1, b1, w2, b2)
    _check_topk("sdqn_score_afterstate_topk", n, k, shards, shard_size)
    out = _launch_topk(
        "sdqn_score_afterstate_topk", TOPK_SOURCE,
        [_P] * 18 + [_F] * 9 + [_P] * 6 + [_I] * 8, device,
        [*cols, cpu_demand, mem_demand, cpu_request, mem_request,
         *_scalar_args(scalars), w1, b1, w2, b2], n, b, k, shards,
        shard_size)
    sdqn_score_afterstate_topk.launches += 1
    return out


sdqn_score_afterstate_topk.launches = 0


# ---------------------------------------------------------------------------
# kernel 5: kernel 3 + PlacementEngine.feasible + per-shard top-k
# ---------------------------------------------------------------------------


def sdqn_score_cols_topk_plain(cols, deltas, scale, w1, b1, w2, b2,
                               ceilings, *, k, shards, shard_size):
    """((B, shards, k) values, indices) of kernel 3's scores masked by
    healthy + the post-delta cpu / mem / job-util ceilings, each rounded
    to float32 as the kernel receives it."""
    q = sdqn_score_cols_plain(cols, deltas, scale, w1, b1, w2, b2)
    cl = [float(np.float32(x)) for x in ceilings]
    c = [x.to(_F32) for x in cols]
    ok = ((c[3] > 0.5)
          & (c[0] + deltas[:, 0:1] <= cl[0])
          & (c[1] + deltas[:, 1:2] <= cl[1])
          & (c[2] + deltas[:, 2:3] <= cl[2]))
    return shard_topk(torch.where(ok, q, -torch.inf), shards, shard_size, k)


def sdqn_score_cols_topk(cols, deltas, scale, w1, b1, w2, b2, ceilings, *,
                         k, shards, shard_size):
    """Per-shard feasible top-k of ``sdqn_score_cols``: one kernel launch
    on CUDA for all B deltas, the plain version on CPU.  ``ceilings``:
    three host floats (max cpu %, mem %, job-util %); ``k <= TOPK_MAX``."""
    check_k(k)
    device = cols[0].device
    if not _on_card("sdqn_score_cols_topk", device):
        return sdqn_score_cols_topk_plain(cols, deltas, scale, w1, b1, w2,
                                          b2, ceilings, k=k, shards=shards,
                                          shard_size=shard_size)
    _refuse_grad("sdqn_score_cols_topk", (cols, deltas, w1, b1, w2, b2))
    n, b = _check_cols("sdqn_score_cols_topk", cols, deltas, w1, b1, w2, b2)
    _check_topk("sdqn_score_cols_topk", n, k, shards, shard_size)
    out = _launch_topk(
        "sdqn_score_cols_topk", COLS_SOURCE,
        [_P] * 7 + [_F] * 9 + [_P] * 6 + [_I] * 8, device,
        [*cols, deltas, *(float(x) for x in scale),
         *(float(x) for x in ceilings), w1, b1, w2, b2], n, b, k, shards,
        shard_size)
    sdqn_score_cols_topk.launches += 1
    return out


sdqn_score_cols_topk.launches = 0
