#!/usr/bin/env python3
"""Run the PyTorch port's serving and training paths on one NVIDIA GPU and
check them.

    python3 chip_smoke.py

Phases (any failed check raises and the run exits nonzero):

1. Device: the card's name and power limit (nvidia-smi), then the build of
   every CUDA kernel of the path from ``src/repro_torch/kernels/csrc``,
   ptxas's registers and spills per kernel, and the SASS of kernel 7's
   fourteen instances: the four bfloat16 ones at D in {64, 128} (with and
   without the lse store) on wgmma (HGMMA) fed by TMA loads (UTMALDG), no
   HMMA, no spill; the other ten (float32, bfloat16 at D <= 32)
   tensor-core products (HMMA) and cp.async copies (LDGSTS), the bfloat16
   ones ldmatrix loads (LDSM).  The backward's ten
   instances: 0 spill bytes in every one; the bfloat16 main pass (D = 64
   and 128) runs on wgmma (HGMMA) fed by TMA loads (UTMALDG) and adds dQ
   with bulk reduce-adds (UBLKRED), beside its preprocess and postprocess;
   the float32 dQ and dK/dV kernels as before.  Kernel 8's
   sixteen instances (q float32 or bfloat16 x cache in q's dtype or
   float8_e4m3fn x D in {16, 32, 64, 128}): cp.async (LDGSTS) in all, HMMA
   and LDSM in the bfloat16-q ones, and 0 spill bytes in every one.
   Kernel 6's six training instances (the chunk states written) and its
   backward's seven kernels: 0 spill bytes in every one.
2. Kernels against their plain PyTorch versions on the card, at
   N in {1, 37, 1000, 5000, 131072} nodes x B in {1, 32} pods, on resets
   with unhealthy nodes and randomized workloads (rtol = atol = 1e-5), and
   up to N = 1000 also against the unfused oracle (``mode="ref"``).  Then
   kernels 1 and 3 at every branch of their launch plan
   (``sdqn_score.score_plan``, printed per shape): the same N at B in
   ``PLAN_B`` and ``PLAN_EXTRA``.
3. Main path: ``PlacementDaemon`` over ``ClusterSubstrate(fleet_cluster(5000))``
   with ``DaemonConfig(batch_size=32, max_wait_s=0.005)`` replays 2,000
   requests from ``arrival_trace`` at 500/s and 4000/s offered.  Kernel
   launch counters are zeroed just before and read just after; every batch
   must be exactly one kernel launch, and the launches are counted by
   (N, B) (the daemon pads each batch to 32 rows).  Then the same trace,
   on a deterministic clock, through the kernel and through
   ``fused="plain"``: the decisions must agree up to the first batch with
   a row whose two best feasible scores lie within the tolerance.
4. Timings: kernel and plain-version device time (CUDA events around a
   CUDA graph of many calls) and eager per-call time, beside the least
   time the card could take (``bound_ms``), at N = 5000 and 131072, B = 32,
   and at N = 5000 with B = 1 and with the main path's requests per batch,
   each with the launch plan that ran and one device kernel per call (the
   kernel nodes of a CUDA graph of one call), beside one empty kernel's
   device time in a CUDA graph (the launch floor).
5. Breakdown: a 500-request replay at 4000/s with host-clock spans around
   each layer of a batch and torch.profiler's device time (busy share).

The sharded and job->host paths (kernels 2-5), at N = 131,072 nodes or
hosts in 8 shards with 8 candidates each:

2b. Kernels 2-5 against their plain versions at the shapes of phase 2 and
    k in {1, 4, 8}, unsharded and in 8 shards, on clusters with unhealthy
    nodes and fleets with infeasible hosts; kernel 4 also against the
    unfused oracle up to N = 1000; NaN weights must come out as NaN
    candidates.  Top-k indices must agree wherever neighbouring candidate
    values differ by more than the tolerance.
6. Sharded cluster: ``PlacementDaemon`` over ``ClusterSubstrate(
   fleet_cluster(131072), layout=plan_fleet_layout(131072, shards=8),
   topk=8)`` replays 2,000 requests at 500/s and 4000/s; every batch is one
   launch of kernel 4.  A deterministic replay with ``layout=None`` (flat,
   kernel 1) must give the same decisions up to the first batch in which
   a request's two best candidates lie within the tolerance.
7. Job->host: ``FleetSubstrate(fresh_fleet(131072))``, flat (kernel 3) and
   sharded (kernel 5), 2,000 jobs (cpu U(1, 10) %, mem U(0.5, 5) %) on the
   trace's arrival times at 500/s; one launch per batch, no host past its
   ceilings, flat and sharded deterministic replays agreeing likewise.
   Then ``PlacementEngine.place_batch`` of 64 jobs (kernel 3 at B = 1)
   and ``engine._score`` (kernel 2) against the delta scorer at zero delta.
8. Timings of kernels 2-5 at N = 131,072, B = 32, k = 8 (as phase 4),
   kernels 3-5 also at B = 1 (``PlacementEngine``'s batch, under
   ``other_shapes``, beside the launch floor) and kernel 2 also at N =
   5,000 (likewise), each with the launch plan
   that ran (``sdqn_score.score_plan``, ``sdqn_score.topk_plan``: cluster
   size, pods per thread, nodes per block); one call of each must be
   exactly one device kernel (a CUDA graph of one call), and at B = 1 and 32
   kernels 4's and 5's candidates' values must be kernels 1's and 3's
   scores of the same pairs bit for bit.  Then the breakdown of a
   sharded-cluster batch (as phase 5).

The attention and Mamba policy classes (kernels 7 and 6):

2c. Kernel 7 (``flash_attention``) against its plain version at the
    reference's fp32 sweep shapes, S in {1, 37, 1000}, two shapes across
    the 64-row tile edges ((63, 65) at D = 16, (17, 130) GQA 4:1 at
    D = 128) and the attention class's main-path shape (32, 5000, 2
    heads, D = 8), causal and not
    (tolerance 3e-5); kernel 6 (``mamba_scan``) at the sweep shapes, the
    mamba class's (1, 32, 8, 4) and (2, 256, 1024, 16), and at S in
    {1, 31, 33, 257, 2048} x di in {200, 1024} x every N in
    ``STATE_SIZES`` (tolerance 4e-5), with the launch plan
    (``mamba_scan.scan_plan``); dt = 0 pad rows must leave hT bit for bit
    that of the sequence cut before them.
9.  ``PlacementDaemon`` over ``ClusterSubstrate(fleet_cluster(5000),
    policy=...)`` for "attention" and for "mamba", 2,000 requests at 500/s:
    every batch is one launch of kernel 7, resp. kernel 6, and no other.
10. Both classes on a deterministic clock (the 4000/s trace), through the
    kernels and through their plain versions (``fused="plain"``): the
    decisions agree up to the first batch with a near tie.  The same for
    their FleetSubstrate (flat and 8 shards) and sharded cluster arms at
    N = 16,384 (96 requests), each arm one launch of its class's kernel
    per batch, its scores held to the plain run's.
11. Timings of kernels 7 and 6 (as phase 4), kernel 7 beside
    ``scaled_dot_product_attention`` on the same tensors (``library_ms``,
    device time from a CUDA graph like the kernels': eager calls measure
    the host's dispatch at the small shapes); kernel 6 at the mamba
    class's (1, 32, 8, 4) and at (2, 256, 1024, 16) (under
    ``other_shapes``), each beside the launch floor, with the plan that
    ran and one device kernel a call (a CUDA graph of one call).
    An attention kernel's bound is the largest of four times: bytes at the
    memory rate, its products at the tensor-core rate of the precision
    that holds the tolerance (bf16, or float32 as 3xTF32), one
    exponential a visible pair at the SFU rate (16 a clock an SM at
    ``clocks.max.sm``) and the softmax's other operations at the float32
    rate; each is printed.
12. Breakdown of an attention and a mamba batch (as phase 5, 400 requests
    at 500/s), the scorer split into encoder, afterstate rows, score_set,
    the kernel's wrapper and the feasibility mask.

The LM serving path (kernels 8 and 7 in bfloat16 at head width 128, and
kernel 3 for the routing):

2d. Kernel 8 (``decode_attention``) against its plain version at the
    reference's sweep shapes, kv_len in {1, 17, full} and a ragged (B,)
    kv_len, float32 and bfloat16, each also with a float8_e4m3fn cache; at
    the serving path's cache seen as a (B, S, Hkv, D) view; at OLMo-1B's
    (8, 16, 16, 32768, 128) and granite-8b's GQA (8, 32, 8, 32768, 128) in
    bfloat16 (granite's also with a float8 cache); at every GQA group of
    ``DECODE_GROUPS`` (1 to 16 and 24) on a 4,096-key cache view, both q
    dtypes, both caches; and all 256 float8 codes as the one visible V row
    (the output is each code's value, NaN at 0x7f and 0xff).  Kernel 7 in
    bfloat16 at the sweep shapes and OLMo-1B's prefill (8, 512, 16, 128),
    causal; its wgmma instances (D in {64, 128}) at every row of
    ``FA_FWD_TIMED`` and at ragged shapes (``check_wgmma_forward``: output
    and lse, per row too, both instances equal, bit for bit twice, one
    device kernel a call, NaN rows, a planted shifted tile caught).
    Tolerances the reference's: 3e-5 float32 q, 2e-2 bfloat16 q.
13. ``repro_torch.launch.serve.main`` with full-width, full-depth OLMo-1B
    (random bf16 weights from seed 0), 4 replicas, 32 requests in waves of
    8, prompts of 512 tokens, 32 generated: every wave routed and served,
    kernel 8 launched 16 layers x 31 steps x 4 waves = 1,984 times,
    kernel 7 16 x 4 = 64, kernel 3 once per daemon batch and once for the
    warm-up, no plain attention call; tok/s, prefill ms per wave, decode
    ms per step.  Then wave 0 again through the plain versions, same
    weights and prompts: prefill logits within ``LOGIT_TOL``, tokens
    identical up to the first step with a near tie.  The decode-step
    breakdown (host ms per step, device busy share, kernel 8's and the
    matrix products' shares, device operations per step).
14. Timings of kernel 8 at the path's shape, the two 32k caches,
    granite-8b's decode shape and granite's 32k and decode shapes with a
    float8 cache (``DECODE_TIMED``), and of kernel 7 at the prefill shape
    (as phase 4), each beside its bound (the cache's own bytes an element)
    and ``scaled_dot_product_attention`` on the same tensors
    (``library_ms``; for a float8 cache, which it does not take, on the
    cache cast to bfloat16, beside it), with kernel 8's launch plan.  With
    ``--parent-src DIR`` the kernel 8 of another checkout (the parent's
    tree) is timed at every row before and after this one's
    (``scripts/decode_timings.py``), as ``parent_ms``; phase 22 likewise
    times the parent's kernel 7 and kernel 6 backwards and its kernel 7
    forward at every row of ``FA_FWD_TIMED`` (``scripts/bwd_timings.py``,
    one build of the parent's tree a run), and each row of kernel 7's
    bfloat16 forward timed here (phases 14, 20, 22 and 23) carries the
    parent's as ``parent_ms``.

The paper's main path (kernels 7 and 1 on the DQN learner's path):

15. The learner (``train.engine.train_seeds``, ``core.train_rl``) with
    every draw made on the CPU and replayed from ``core.draws.ArrayDraws``:
    the SDQN preset (E = 16, batch 256) cut to 2 seeds x 2 episodes on
    ``training_cluster()`` on the card and on the CPU port (identical
    actions up to the first near tie, then params within 1e-5); the
    attention class through kernel 7 and through ``fused="plain"`` (the
    same, and exactly 2 kernel-7 launches a pod step); the MLP at
    ``fleet_cluster(5000)`` with E = 2 through kernel 1 and plain (exactly
    2·E launches a pod step); kernels 7 and 1 against their plain versions
    at the learner's shapes; ms per pod step at the SDQN preset's (S = 10,
    E = 16, batch 256), and under torch.profiler the device operations per
    step and the busy share.
16. Tables 8-10 through ``scripts/paper_tables.py``'s functions at a cut
    budget (20 episodes, 2 seeds, 5 trials): every trial places or drops
    its 50 pods; then kube, SDQN and SDQN-n on recorded trial draws on the
    card and on the CPU port: identical experiment pods, metrics within
    1e-5 relative; and SDQN's and SDQN-n's whole ``train_and_select`` at
    that cut (12 validation bursts) on draws recorded from CPU
    ``TorchDraws``, on the card and on the CPU port: learner actions
    identical up to the first near tie (printed with its gap), and with
    none the same selected seed, validation metrics and Table 9/10 trials
    (experiment pods identical, metrics within 1e-5 relative).

The paper's baselines and SDQN-n over time (kernels 7 and 1):

17. Tables 11/12 (the LSTM and Transformer scorers, 2 seeds x 3
    episodes each), Figure 6's three claims (printed, not asserted at
    the cut budget), the literal ablation and the policy-class table
    through ``scripts/paper_tables.py``'s ``run_baselines`` on phase 16's
    Tables 8-10: every trial places or drops its 50 pods, kernel 7's
    launches in the attention arm; then the supervised trainer on
    recorded draws on the card and on the CPU port: identical kube
    actions, params within 1e-5.
18. ``scripts/scenario_tables.py``'s ``run`` cut to 6 training episodes
    and 3 trials: every scenario but the scoring-only ones under kube and
    a mixture-trained SDQN (the chaos ones with their pods evicted,
    rescheduled and lost, balanced), the four churn scenarios under kube,
    SDQN and SDQN-n with the consolidator (active nodes, energy, average
    CPU, retired, moved) and their green Pareto rows (kube, TOPSIS and
    the SDQN-n of energy weight 15).  Then the lifecycle SDQN-n's
    ``train_mixture`` cut to 4 episodes (one a churn scenario) on draws
    recorded from a CPU generator, card against CPU port: actions
    identical or stopped at a printed near tie
    (``paired_train_mixture``).  Then a
    cluster-of-clusters-4k episode
    (4,096 nodes, 32 pods, 2 trials) under SDQN-n with the consolidator
    every 30 s, through kernel 1 and through ``fused="plain"`` on the
    same recorded draws: exactly trials x (32 + 4 x 52) launches, every
    call held to the plain version on its inputs, the selector's actions
    identical up to the first near tie.

The chaos episodes and the rest of the scheduler (kernels 1 and 3):

19. The three flaky scenarios under kube and SDQN, 3 trials each, traces
    and draws from ``TorchDraws``: pods evicted, rescheduled and lost,
    ``evicted == rescheduled + lost`` in every cluster.  A
    cluster-of-clusters-4k chaos episode (32 pods, 2 trials; 5% of the
    nodes down for 20 s from the middle arrival) through kernel 1 and
    ``fused="plain"``: exactly trials x 2 x 32 launches (the arrival and
    the re-placement selections), every call held to plain, actions
    identical up to the first near tie.  The flat 5,000-node daemon with a
    ``TransitionRecorder`` on its ``decision_hook``: the decisions of the
    daemon without one, kernel-1 launches equal to batches; then 4
    ``OnlineRefresher`` steps, each published, and a replay scored on the
    new params; ``serve.main --online`` (kernel 3 routing).  Checkpoints:
    the daemon's decisions with restored params, ``--qnet-path``, the
    fallback on a damaged shard.  ``consolidation_plan`` on a 5,000-host
    fleet and a straggler evacuation (kernel 3 at B = 1 a job, every call
    held to plain, the plain path's plan up to near ties).

The remaining LM families (kernels 6, 7 and 8):

20. ``serve.main`` with falcon-mamba-7b (ssm) and qwen2-moe-a2.7b (moe)
    at full width and depth, random bf16 weights from seed 0, 4
    replicas, 16 requests in waves of 8, prompts of 512, 32 tokens:
    exactly 64 kernel-6 launches a falcon wave and no attention launch;
    24 kernel-7 launches a qwen wave and 24 x 31 of kernel 8, with what
    the MoE capacity dropped in each prefill and the rows where the
    reference's last-slot rule fired.  whisper-medium (audio) through
    ``serve_wave`` with 1,500 frames of ``0.02 N(0, 1)``: 2 waves of 8,
    prompts of 384 plus 32 tokens, 72 kernel-7 launches a wave (encoder,
    self, cross) and 48 kernel-8 launches a decode step.  dbrx-132b at
    full width cut to 4 of its 40 layers and jamba at its smoke widths,
    one wave each.  No plain call on the kernel runs; each model's wave 0
    again through the plain versions (prefill logits within
    ``LOGIT_TOL``, tokens up to the first near tie); tok/s, prefill ms
    per wave, decode ms per step and a profiled decode step; each model
    freed before the next.  Then kernels 6-8 against their plain versions
    at the new shapes and timed beside their bounds and SDPA (kernel 8 as
    phase 14, with the parent's beside it under ``--parent-src``).

Kernel 8's 4:1 GQA path and the float8 cache:

21. granite-8b at full width and depth (36 layers, 8.25 B random bf16
    parameters) through ``serve.main``, 4 replicas, one wave of 8 x 512
    prompts and 32 tokens (the wave asks for all of a replica's CPU, so
    the daemon drops it and ``serve.main`` serves it all the same), then
    the same weights and prompts through ``serve_wave`` with
    ``cache_dtype="float8_e4m3fn"``: exactly 36 kernel-7 and 36 x 31
    kernel-8 launches each, no plain call, a profiled decode step each;
    the float8 wave again through the plain versions (tokens identical up
    to the first near tie) and the bf16 wave held as phase 20 holds its
    models.

LM training (kernel 7 with its row log-sum-exp and kernel 6 with its
chunk states, and their hand-written backwards,
``csrc/flash_attention_bwd.cu`` and ``csrc/mamba_scan_bwd.cu``):

22. The backward's dQ, dK, dV (and the forward's lse) against
    ``flash_attention_bwd_plain`` on the same CUDA tensors and against
    autograd of ``flash_attention_plain`` in float32, at OLMo-1B's
    (8, 512, 16, 128) causal, granite's 32 / 8 and dbrx's 48 / 8 GQA,
    whisper's encoder (8, 1500, 16, 64) and cross-attention (8, 448
    against 1,500 keys) non-causal, and a ragged causal shape, in float32
    (1e-4) and bfloat16 (2e-2) relative to the largest gradient; each
    bfloat16 shape run twice more: dQ (its pieces added in ascending
    key-block order), dK and dV of the three calls bit for bit.
    Kernels 1-5 and 8 under grad with an input that requires grad raise;
    kernel 6 under grad runs its training forward and its backward once
    each, dx held to autograd of the plain version.  Kernel 6's training
    forward (y, hT bit for bit the serving launch's; the chunk states) and
    its backward's seven gradients, with dhT and without, against
    ``mamba_scan_plain(..., return_states=True)`` and
    ``mamba_scan_bwd_plain`` at each state size, ragged S, one batch row
    and several, (2, 256, 1024, 16) and falcon-mamba-7b's (8, 512, 8192,
    16), 1e-4 of each gradient's largest element, each backward twice: bit
    for bit.  Then
    ``repro_torch.launch.train.main`` with OLMo-1B at full width and depth
    (bf16 weights, ``default_adam``: float32 master and moments), 40 steps
    of 8 x 512 tokens, a checkpoint under ``build/``, at the config's
    ``remat="full"`` (each block run again inside the backward): exactly
    2 x 16 x 40 launches of kernel 7 and 16 x 40 of its backward, no
    plain call, finite losses
    whose last-10 mean is below the first-10's; ms a step (median of steps
    5-39, synchronized), tokens/s, MFU (``roofline.cell_flops``' model
    FLOPs over the step and 989 TFLOP/s), peak memory, and torch.profiler
    over steps 2-4 (busy share, top device operations).  A crash with
    ``--fail-at 12`` (exit 17) and the rerun's resume (smoke OLMo at head
    width 64, losses within 1e-3 of the uninterrupted run's); OLMo-1B's
    width cut to 2 layers in float32, one step and its gradients through
    the kernels and through ``attn_mode="plain"`` at "full" (loss within
    1e-5, gradients within 1e-4 of a leaf's largest element);
    whisper-medium at full width with 2 encoder and 2 decoder layers, 3
    steps at "full" (exactly 36 launches of kernel 7, 18 of its
    backward).  falcon-mamba-7b at its published widths cut to 8 of its
    64 layers through ``launch.train.main``, 30 steps of 8 x 512 at
    "full": exactly 2 x 8 x 30 launches of kernel 6 and 8 x 30 of its
    backward and no other,
    no plain call, finite and falling losses, ms a step, tokens/s, MFU,
    peak memory and a profile of steps 2-4; its width cut to 2 layers in
    float32, one step through the kernels and through the plain versions
    (loss within 1e-5, gradients within 1e-4 of a leaf's largest
    element); jamba at its smoke widths with head width 64, 3 steps:
    kernels 6 and 7 and both backwards as often as ``block_spec`` says
    (the smoke config's "none").  Rematerialization, for OLMo-1B and
    falcon-mamba-7b (8 layers) at 8 x 512: the aten products a training
    forward reaches (every projection one ``aten.mm``, nothing else);
    ``value_and_grad`` at one batch under "none" twice, "full" and
    "dots", each call's own peak within 5% of the dry run's plan of it on
    fake tensors (``scripts/remat_plans.py --backward``, run beside the
    card's work in a process of its own), the gradients of every call bit
    for bit the first "none" call's; then "full" once more with every
    recomputed launch of kernel 7 or 6 on autograd's device thread, its
    outputs bit for bit the first launch's;
    then 9 steps of ``make_train_step`` a turn, one turn a setting
    (full, none, dots): exact launches, ms a step, tokens/s, MFU, the
    share of ``cell_flops``' hlo FLOPs, peak memory and the busy share of
    two profiled steps.
    Timings of the backward at OLMo's shape and
    whisper's two (device time from a CUDA graph, 3 device kernels a call,
    each an ``fa_bwd`` one) beside its bound and SDPA's backward alone
    from a CUDA graph (``library_ms``), and of kernel 7's training forward
    with the lse stored against the serving launch without it, in turns.
    With ``--parent-src DIR`` the backward of another checkout is timed at
    the same rows before and after this one's (``scripts/bwd_timings.py``),
    as ``parent_ms``.  Kernel 6's backward at falcon-mamba-7b's training
    shape, (1, 32, 8, 4) and (2, 256, 1024, 16) (CUDA graph, two device
    kernels a call, their split), beside its plain twin and its bound,
    with its plan, blocks an SM (the runtime's occupancy calculator: at
    least 2 at falcon's shape) and dB / dC partial bytes (at most
    ``SCAN_BWD_MAX_PARTIALS`` there), the parent's backward before and
    after under ``--parent-src``, and its training forward against the
    serving launch in turns.  Phase 1 checks that every instance of both
    backwards spills nothing (ptxas).

The dry run for one card (kernel 7 and its backward at 4,096 tokens):

23. ``repro_torch.launch.dryrun.plan_cells`` plans every (arch, shape)
    cell of the 10 archs x 4 shapes for one card on fake tensors (the
    CPU; 32 planned, the 8 ``long_500k`` cells of full-attention archs
    skipped, none failed), one line a cell and its JSON under
    ``dryrun_out``.  Then ``check_cell`` runs two cells the plan
    says fit on the card, every launch counted: OLMo-1B ``train_4k`` at
    ``--micro 256`` (one 4,096-token sequence a microbatch, cut to 2
    microbatches), 3 steps: exactly 16 x 2 x 3 launches of kernel 7 and of
    its backward at (1, 4096, 16, 128) causal, no plain call, the loss
    finite; and falcon-mamba-7b ``long_500k`` at full width and depth, one
    decode step at index 524,287 (no kernel: the mixer's decode is plain).
    For both the arguments allocated on the card equal the plan's to the
    byte, and the measured peak is printed beside the plan's
    ``hbm_bytes_per_chip`` with their ratio; OLMo-1B's at its config's
    "full", 2 x 16 x 2 x 3 launches of kernel 7 and 16 x 2 x 3 of its
    backward.  OLMo-1B ``train_4k --micro 256`` planned under "none",
    "dots" and "full" (the three peaks); the smallest microbatch count at
    which "full" fits 80 GB and "none" does not, and ``check_cell`` there
    under "full": arguments to the byte, the peak within 2% of the
    plan's, the launches the plan's.  Kernel 7's forward with its
    lse and its backward at (1, 4096, 16, 128) against their plain twins
    (``LM_TOL``, ``FA_BWD_TOL``; the backward twice more, as phase 22),
    then timed in CUDA graphs beside their bounds and SDPA's forward and
    backward.

Each path zeroes every kernel's launch count just before it runs and
reads the counts just after.  Every phase prints its wall seconds
(``phase <name> seconds=``).  The line before last is the JSON kernel
table; the last line is
``{"ok": true, "device": {...}}``.  No CUDA device: exit 1, no result.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
RTOL = ATOL = 1e-5
SHAPES_N = (1, 37, 1000, 5000, 131072)
SHAPES_B = (1, 32)
MAIN_N, MAIN_B = 5000, 32
# kernels 1 and 3 at every branch of their launch plan (sdqn_score.
# score_plan): the sweep's N at these B, and a shape for pod rows at R = 4
PLAN_B = (1, 2, 3, 5, 32, 33)
PLAN_EXTRA = ((40000, 5),)
RATES_PER_S = (500.0, 4000.0)
N_REQUESTS = 2000

# H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the tensor cores
# and HBM3 bandwidth.  The PCIe and NVL parts are slower; see peaks().
PEAKS = {"sxm": (67e12, 3.35e12), "pcie": (51e12, 2.0e12),
         "nvl": (60e12, 3.9e12)}

# Operation count of the afterstate kernel, from its source: per (pod,
# node) 19 for the two pod-dependent features, 6 x 32 multiply-adds (384),
# 32 ReLUs, 32 multiply-adds into the output (64) and the b2 add; per node
# 8 for the pod-independent features.
OPS_PER_POD_NODE = 19 + 384 + 32 + 64 + 1
OPS_PER_NODE = 8
# bytes per node read once: 10 four-byte columns + 2 bool columns
BYTES_PER_NODE = 10 * 4 + 2 * 1
WEIGHT_BYTES = (6 * 32 + 32 + 32 + 1) * 4

# the sharded and job->host paths: 32 federated 4,096-node clusters (the
# reference's fleet_scale top size), 8 shards, 8 candidates per shard
SHARDED_N, SHARDS, TOPK = 131072, 8, 8
K_SHAPES = (1, 4, 8)

# Operation and byte counts of kernels 2-5, from their sources
# (csrc/sdqn_score.cu, sdqn_score_cols.cu, sdqn_score_afterstate_topk.cu).
# The Q-net on one row: 6 x 32 multiply-adds (384), 32 ReLUs, 32
# multiply-adds into the output (64) and the b2 add.
QNET_OPS = 384 + 32 + 64 + 1
# kernel 2: the Q-net per row; 24 bytes read and 4 written per row
SCORE_OPS_PER_ROW, SCORE_BYTES_PER_ROW = QNET_OPS, 6 * 4 + 4
# kernel 3: 6 column + delta adds and the Q-net per (job, host); 24 bytes
# read per host and per delta row, 4 written per (job, host); folding the
# scale into w1 takes 6 x 32 divisions
COLS_OPS_PER_PAIR = 6 + QNET_OPS
COLS_BYTES_PER_HOST = DELTA_BYTES = 6 * 4
# kernel 4: the k8s filter's request tests per (pod, node) (2 adds, 2
# compares); per node the health test, the pod-slot compare and kernel 1's
# pod-independent features (OPS_PER_NODE), counted once as for kernel 1;
# per FEASIBLE pair kernel 1's pod-dependent work and one compare into the
# list.  The filter's two request columns add 8 bytes per node.
TOPK_FILTER_OPS_PER_PAIR = 4
TOPK_OPS_PER_NODE = 2 + OPS_PER_NODE
TOPK_OPS_PER_FEASIBLE = OPS_PER_POD_NODE + 1
TOPK_BYTES_PER_NODE = BYTES_PER_NODE + 2 * 4
# kernel 5: the ceilings per (job, host) (3 adds, 3 compares); the health
# compare once per host; per feasible pair 3 more adds, the Q-net and one
# compare into the list
COLS_TOPK_FILTER_OPS_PER_PAIR = 6
COLS_TOPK_OPS_PER_HOST = 1
COLS_TOPK_OPS_PER_FEASIBLE = 3 + QNET_OPS + 1
# one candidate written: a float32 value and an int32 index
CAND_BYTES = 8

# kernels 6 and 7: the Mamba and attention policy classes.  Kernel 7 at the
# reference's fp32 sweep shapes (tests/test_kernels.py), ragged lengths, and
# the attention class's main-path shape: a batch of 32 pods as 32 sets of
# 5,000 nodes, 2 heads of width 8 (ATTN_DMODEL = 16, ATTN_HEADS = 2).
FA_SHAPES = ((1, 64, 64, 4, 4, 32), (2, 128, 128, 4, 2, 32),
             (2, 64, 128, 8, 1, 16), (1, 256, 256, 2, 2, 64),
             (3, 1, 1, 2, 2, 8), (3, 37, 37, 2, 2, 8),
             (3, 1000, 1000, 2, 2, 8), (2, 63, 65, 4, 2, 16),
             (1, 17, 130, 8, 2, 128))
FA_PATH = (MAIN_B, MAIN_N, MAIN_N, 2, 2, 8)
FA_TOL = 3e-5                       # the reference's (tests/test_kernels.py)
# kernel 6 at the sweep shapes, the mamba class's main-path shape (one
# batch of 32 workloads, MAMBA_DI = 8, MAMBA_STATE = 4) and a wide shape
# where the roofline bound means something
SCAN_SHAPES = ((1, 32, 8, 4), (2, 64, 16, 8), (1, 128, 32, 16))
SCAN_PATH = (1, MAIN_B, 8, 4)
SCAN_WIDE = (2, 256, 1024, 16)
SCAN_TOL = 4e-5
# kernel 6 across its chunk edges and long (S), with di a multiple of the
# block's warps and not, at every state size; and dt = 0 pad rows after
# each SCAN_PAD_REAL against the cut sequence (hT bit for bit)
SCAN_EDGE_S = (1, 31, 33, 257, 2048)
SCAN_EDGE_DI = (200, 1024)
SCAN_PAD_REAL = (1, 9, 20, 31, 37, 95)
# the policy classes' FleetSubstrate and sharded arms, held cuda vs plain
# at a reduced N: block-local attention over 131,072 nodes in 8 shards
# would cost ~4 TFLOP per batch in the plain version
POLICY_ARMS_N, POLICY_ARM_REQUESTS = 16384, 96
# Operation counts, from the sources.  Kernel 6 per (batch, step,
# channel, state): dt·a, exp, ·h, (dt·x)·B, +, ·C, + (7); per (batch,
# step, channel): dt·x, x·D, + (3).  Kernels 7 and 8: attention_bound.
SCAN_OPS_PER_STATE, SCAN_OPS_PER_CHANNEL = 7, 3
# Attention per visible (query, key) pair and query head: the QK and PV
# products (2·2·D operations) on the tensor cores, at the bf16 peak
# (NVIDIA data sheets, dense) in bfloat16 and as 3xTF32 (three products,
# TF32 at half the bf16 peak) in float32, the precision that holds the
# reference's 3e-5; one exponential on the special-function units, 16 a
# clock on each SM; and the scale, max, subtraction and sum (4) at the
# float32 peak.
BF16_PEAK = {"sxm": 989e12, "pcie": 756e12, "nvl": 835e12}
TF32_PRODUCTS = 3
SFU_PER_CLOCK_PER_SM = 16
SOFTMAX_OPS_PER_PAIR = 4


def peaks(name: str):
    key = "pcie" if "PCIe" in name else "nvl" if "NVL" in name else "sxm"
    return key, PEAKS[key]


def roofline(nbytes, ops, name):
    """(ms, "bytes" | "operations"): the least time for the work."""
    _, (flops, bw) = peaks(name)
    t_bytes, t_ops = nbytes / bw, ops / flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bound_ms(n: int, b: int, name: str):
    """(ms, "bytes" | "operations"): the least time for one launch of the
    afterstate kernel."""
    return roofline(n * BYTES_PER_NODE + b * 8 + WEIGHT_BYTES + b * n * 4,
                    b * n * OPS_PER_POD_NODE + n * OPS_PER_NODE, name)


def cuda_time_ms(fn, iters: int, reps: int = 5) -> float:
    """Median over ``reps`` of (CUDA-event time of ``iters`` calls) / iters."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_time_ms(fn, iters: int, reps: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    replayed ``reps`` times between CUDA events (median / iters).  Unlike
    ``cuda_time_ms`` this leaves out the host's per-call cost, which at
    small N is larger than the kernel itself."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return replay_ms(graph, iters, reps)


def replay_ms(graph, iters: int, reps: int = 5) -> float:
    """Median over ``reps`` replays of a captured graph of ``iters`` calls,
    between CUDA events, per call."""
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def cold_time_ms(fn, iters: int, reps: int = 5) -> float:
    """Device time per call with the L2 cache cold, as a call inside a
    model step finds it: a CUDA graph of ``iters`` (write 128 MB, call)
    pairs less one of ``iters`` writes alone (``graph_time_ms`` each)."""
    junk = torch.empty(32 << 20, dtype=torch.float32, device="cuda")

    def flush():
        junk.fill_(1.0)

    def both():
        flush()
        fn()

    return graph_time_ms(both, iters, reps) - graph_time_ms(flush, iters, reps)


def launch_floor_ms() -> float:
    """One empty kernel's device time in a CUDA graph (as graph_time_ms):
    the least a launch costs on this card."""
    return graph_time_ms(lambda: torch.cuda._sleep(0), 200)


def plan_text(n, b) -> str:
    from repro_torch.kernels import sdqn_score as ss

    plan = ss.score_plan(n, b)
    return (f"score_plan(N={n}, B={b}): rows={plan.rows} "
            f"pod_rows={plan.pod_rows} grid={plan.grid} blocks={plan.blocks}")


@contextlib.contextmanager
def launch_shapes(log):
    """Count kernel 1's and kernel 3's calls by (name, N, B) of their
    output into ``log`` while the block runs.  The wrappers run underneath;
    they count their launches on the module's name, so the spy in its place
    carries the count, handed back when the block ends."""
    from repro_torch.kernels import sdqn_score as ss

    saved = {k: getattr(ss, k)
             for k in ("sdqn_score_afterstate", "sdqn_score_cols")}

    def spy(name, fn):
        def call(*args, **kw):
            q = fn(*args, **kw)
            key = (name, q.shape[1], q.shape[0])
            log[key] = log.get(key, 0) + 1
            return q
        call.__name__, call.launches = fn.__name__, fn.launches
        return call

    for k, fn in saved.items():
        setattr(ss, k, spy(k, fn))
    try:
        yield log
    finally:
        for k, fn in saved.items():
            fn.launches = getattr(ss, k).launches
            setattr(ss, k, fn)


def make_case(n, b, device, seed):
    from repro_torch import convert
    from repro_torch.core import dqn, env
    from repro_torch.core.types import fleet_cluster

    cfg = dataclasses.replace(fleet_cluster(n), unhealthy_prob=0.2,
                              randomize_workload=True)
    gen = torch.Generator().manual_seed(seed)
    state = env.reset(gen, cfg, device=device)
    params = dqn.init_qnet(gen, device=device)
    rng = np.random.default_rng(seed)
    pods = convert.pods_from_numpy(rng.uniform(50, 900, b),
                                   rng.uniform(5, 700, b),
                                   rng.uniform(64, 2048, b),
                                   rng.uniform(32, 1800, b), device=device)
    return cfg, state, params, pods


def phase_kernels(device):
    from repro_torch.kernels import ops

    worst = 0.0
    for n in SHAPES_N:
        for b in SHAPES_B:
            cfg, state, params, pods = make_case(n, b, device, SEED + n + b)
            got = ops.sdqn_score_afterstate(state, pods, cfg, params,
                                            mode="cuda")
            torch.cuda.synchronize()
            want = ops.sdqn_score_afterstate(state, pods, cfg, params,
                                             mode="plain")
            assert got.shape == (b, n) and bool(torch.isfinite(got).all())
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
            err = float((got - want).abs().max())
            worst = max(worst, err)
            print(f"kernel vs plain N={n} B={b}: max_abs_err={err}")
            if n <= 1000:
                # and against the unfused oracle (hypothetical_place + Q-net)
                oracle = ops.sdqn_score_afterstate(state, pods, cfg, params,
                                                   mode="ref")
                torch.testing.assert_close(got, oracle, rtol=RTOL, atol=ATOL)
    return worst


class StepClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _serving_setup(device):
    from repro_torch.core import dqn, env
    from repro_torch.core.types import fleet_cluster

    cfg = fleet_cluster(MAIN_N)
    gen = torch.Generator().manual_seed(SEED)
    state = env.reset(gen, cfg, device=device)
    params = dqn.init_qnet(gen, device=device)
    return cfg, state, params


def check_outcome(daemon, cfg):
    """The repo's own invariants on a finished run."""
    from repro_torch.core.types import NO_PLACEMENT

    m = daemon.metrics
    assert m.bound + m.dropped + m.shed == m.submitted, m
    assert len(daemon.decisions) == m.submitted
    lv = daemon._sub.live
    for d in daemon.decisions:
        assert d.node == NO_PLACEMENT or 0 <= d.node < cfg.n_nodes
    assert np.all(lv.cpu_requested <= lv.cpu_capacity)
    assert np.all(lv.mem_requested <= lv.mem_capacity)
    assert np.all(lv.num_pods <= lv.max_pods)
    for col in lv:
        assert np.all(np.isfinite(np.asarray(col, np.float64)))


def phase_main_path(device):
    from repro_torch.kernels import sdqn_score as ss
    from repro_torch.scenarios import arrival_trace
    from repro_torch.sched.daemon import (ClusterSubstrate, DaemonConfig,
                                          PlacementDaemon, replay_trace)

    cfg, state, params = _serving_setup(device)
    runs = []
    for rate in RATES_PER_S:
        d = PlacementDaemon(ClusterSubstrate(state, cfg, device=device), params,
                            DaemonConfig(batch_size=32, max_wait_s=0.005))
        d.warmup()
        trace = arrival_trace(torch.Generator().manual_seed(SEED + 2), cfg,
                              N_REQUESTS, rate_per_s=rate)
        runs.append((rate, d, trace))

    shapes = {}
    zero_counts()                                  # the main path starts here
    per_rate = []
    for rate, d, trace in runs:
        before = ss.sdqn_score_afterstate.launches
        with launch_shapes(shapes):
            dur = replay_trace(d, trace.t_s, trace.pods)
        per_rate.append((rate, d, dur, ss.sdqn_score_afterstate.launches - before))
    launches = ss.sdqn_score_afterstate.launches   # ... and ends here

    for rate, d, dur, n_launch in per_rate:
        m = d.metrics
        assert m.bound + m.dropped == m.submitted == N_REQUESTS, m
        assert m.device_launches == m.batches, m
        assert n_launch == m.device_launches, (n_launch, m.device_launches)
        assert n_launch > 0
        check_outcome(d, cfg)
        lat = np.asarray(m.bind_latencies_s)
        print(f"serve rate={int(rate)}/s: decisions/s={N_REQUESTS / dur} "
              f"p50_ms={np.percentile(lat, 50) * 1e3} "
              f"p99_ms={np.percentile(lat, 99) * 1e3} batches={m.batches} "
              f"kernel_launches={n_launch} bound={m.bound} "
              f"dropped={m.dropped} conflicts={m.conflicts}")
    # every batch is padded to batch_size rows: the kernel's B is 32
    # whatever the batch's fill
    fill = len(RATES_PER_S) * N_REQUESTS / launches
    print(f"flat cluster launches by (kernel, N, B): {shapes}; requests per "
          f"batch {fill}")
    assert sum(shapes.values()) == launches
    return launches, fill


def _deterministic_run(device, fused):
    from repro_torch.scenarios import arrival_trace
    from repro_torch.sched.daemon import (ClusterSubstrate, DaemonConfig,
                                          PlacementDaemon)

    cfg, state, params = _serving_setup(device)
    clock = StepClock()
    d = PlacementDaemon(ClusterSubstrate(state, cfg, device=device), params,
                        DaemonConfig(batch_size=32, max_wait_s=0.005,
                                     fused=fused), clock=clock, timer=clock)
    log = []
    _spy_scores(d, log)
    trace = arrival_trace(torch.Generator().manual_seed(SEED + 2), cfg,
                          N_REQUESTS, rate_per_s=RATES_PER_S[0])
    _replay_deterministic(d, clock, trace.t_s, trace.pods)
    check_outcome(d, cfg)
    return d, log


def scores_agree(k_log, p_log, label):
    """The batches two runs cut alike (same decisions before them, same
    feasibility or candidate indices) score within the tolerance."""
    worst = 0.0
    for (kd, kq, kok), (pd, pq, pok) in zip(k_log, p_log):
        if kd != pd or kq.shape != pq.shape or not np.array_equal(kok, pok):
            break
        np.testing.assert_allclose(kq, pq, rtol=RTOL, atol=ATOL)
        fin = np.isfinite(pq)
        worst = max(worst, float(np.max(np.abs(kq[fin] - pq[fin]),
                                        initial=0.0)))
    print(f"{label} scores, cuda vs plain, batches cut alike: "
          f"max_abs_err={worst}")


def phase_decision_parity(device):
    kern, k_log = _deterministic_run(device, "auto")
    plain, p_log = _deterministic_run(device, "plain")
    compare_runs(kern, plain, k_log, False, "flat cluster cuda vs plain")
    scores_agree(k_log, p_log, "flat cluster")


def phase_timings(device, name, fill):
    """Kernel 1 at the flat cluster path's shape (N = 5000, B = 32: the
    daemon pads every batch to 32 rows), at N = 131,072, B = 32, and at
    N = 5000 with B = 1 and B = the path's requests per batch (``fill``,
    rounded), with the launch plan that ran and the launch floor."""
    from repro_torch.kernels import ops, sdqn_score as ss

    floor = launch_floor_ms()
    print(f"launch floor: empty kernel in a CUDA graph {floor} ms")
    rows = {}
    shapes = [(MAIN_N, MAIN_B), (SHARDED_N, MAIN_B), (MAIN_N, 1)]
    mean_b = max(1, round(fill))
    if mean_b not in (1, MAIN_B):
        shapes.append((MAIN_N, mean_b))
    for n, b in shapes:
        cfg, state, params, pods = make_case(n, b, device, SEED + 7)
        inputs = ops._afterstate_inputs(state, pods, cfg, params)
        saved = ss.sdqn_score_afterstate.launches
        ms = graph_time_ms(lambda: ss.sdqn_score_afterstate(*inputs), 200)
        call_ms = cuda_time_ms(lambda: ss.sdqn_score_afterstate(*inputs), 200)
        names = device_kernels(lambda: ss.sdqn_score_afterstate(*inputs))
        assert len(names) == 1 and "sdqn_score_afterstate_kernel" in names[0]
        ss.sdqn_score_afterstate.launches = saved   # timing launches don't count
        plain_iters = 10 if n > 5000 else 50
        plain_ms = graph_time_ms(
            lambda: ss.sdqn_score_afterstate_plain(*inputs), plain_iters)
        plain_call_ms = cuda_time_ms(
            lambda: ss.sdqn_score_afterstate_plain(*inputs), plain_iters)
        b_ms, b_by = bound_ms(n, b, name)
        rows[n, b] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, n=n, b=b,
                          launch_floor_ms=floor)
        print(f"timing N={n} B={b}: kernel_ms={ms} plain_ms={plain_ms} "
              f"(device time, CUDA graph) kernel_call_ms={call_ms} "
              f"plain_call_ms={plain_call_ms} (eager calls, host included) "
              f"bound_ms={b_ms} ({b_by}, {peaks(name)[0]} peaks) "
              f"kernel/bound={ms / b_ms} kernel/launch_floor={ms / floor} "
              f"{plan_text(n, b)}; device kernels per call: {len(names)}")
    main = dict(rows.pop((MAIN_N, MAIN_B)))
    main["other_shapes"] = list(rows.values())
    return main


class Spans:
    """Host-clock totals of named spans (seconds) and their counts."""

    def __init__(self):
        self.total = {}
        self.count = {}

    def wrap(self, name, fn, sync=False):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            self.total[name] = self.total.get(name, 0.0) + time.perf_counter() - t0
            self.count[name] = self.count.get(name, 0) + 1
            return out
        return timed


def profiled_replay(d, trace, spans, label):
    """Replay ``trace`` through ``d`` under torch.profiler, then print each
    span's total and per-batch time, the device's busy share and the top
    device operations.  Busy time sums the device's own events (kernels
    and copies) only: a PyTorch op's device time is the time of the
    kernels it launched, which are listed as events of their own."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.sched.daemon import replay_trace

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        replay_trace(d, trace.t_s, trace.pods)
        wall = time.perf_counter() - t0
    batches = d.metrics.batches
    for key in sorted(spans.total, key=spans.total.get, reverse=True):
        print(f"{label} span {key}: total_ms={spans.total[key] * 1e3} "
              f"per_batch_ms={spans.total[key] * 1e3 / batches} "
              f"calls={spans.count[key]}")
    dev = {evt.key: (evt.self_device_time_total, evt.count)
           for evt in prof.key_averages()
           if evt.device_type != torch.autograd.DeviceType.CPU
           and evt.self_device_time_total > 0}
    busy = sum(t for t, _ in dev.values()) / 1e6
    ops = sum(c for _, c in dev.values())
    print(f"{label} profiled replay: batches={batches} wall_s={wall} "
          f"device_busy_s={busy} device_busy_share={busy / wall} "
          f"device_ops_per_batch={ops / batches}")
    for key in sorted(dev, key=lambda x: dev[x][0], reverse=True)[:10]:
        t, c = dev[key]
        print(f"{label} device time {key[:120]}: total_us={t} "
              f"per_batch_us={t / batches} calls={c}")


def phase_breakdown(device):
    """Where a batch's time goes at 4000/s offered: host spans around each
    layer (the scorer span synchronizes, so it holds the device work), and
    the device's busy share from torch.profiler over the same run."""
    from repro_torch.scenarios import arrival_trace
    from repro_torch.sched.daemon import (ClusterSubstrate, DaemonConfig,
                                          PlacementDaemon)

    cfg, state, params = _serving_setup(device)
    sub = ClusterSubstrate(state, cfg, device=device)
    d = PlacementDaemon(sub, params, DaemonConfig(batch_size=32,
                                                  max_wait_s=0.005))
    d.warmup()
    spans = Spans()
    sub.snapshot = spans.wrap("snapshot_publish", sub.snapshot, sync=True)
    sub.pack = spans.wrap("pack_pods", sub.pack, sync=True)
    d._scorer = spans.wrap("score_kernel_feasible", d._scorer, sync=True)
    sub.feasible_one = spans.wrap("bind_revalidate", sub.feasible_one)
    sub.bind = spans.wrap("bind_commit", sub.bind)
    d._process_batch = spans.wrap("batch_total", d._process_batch)
    trace = arrival_trace(torch.Generator().manual_seed(SEED + 3), cfg, 500,
                          rate_per_s=RATES_PER_S[1])
    profiled_replay(d, trace, spans, "flat")


# ---------------------------------------------------------------------------
# kernels 2-5: the sharded cluster path and the job->host path
# ---------------------------------------------------------------------------


def wrappers():
    """{name: wrapper} of every kernel of the port, in table order."""
    from repro_torch.kernels import (decode_attention as da,
                                     flash_attention as fa, mamba_scan as ms,
                                     sdqn_score as ss)

    return {fn.__name__: fn for fn in (
        ss.sdqn_score_afterstate, ss.sdqn_score, ss.sdqn_score_cols,
        ss.sdqn_score_afterstate_topk, ss.sdqn_score_cols_topk,
        ms.mamba_scan, fa.flash_attention, da.decode_attention,
        fa.flash_attention_bwd, ms.mamba_scan_bwd)}


def zero_counts():
    for fn in wrappers().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in wrappers().items()}


def make_fleet(n, device, seed):
    """A job fleet with infeasible hosts: unhealthy ones, cpu / mem near
    their ceilings, job slots nearly full."""
    from repro_torch import convert
    from repro_torch.sched import placement as pl

    rng = np.random.default_rng(seed)
    jobs = rng.integers(0, 26, n)
    return convert.fleet_from_numpy(dict(
        cpu_pct=rng.uniform(2, 92, n), mem_pct=rng.uniform(2, 96, n),
        job_util_pct=jobs * pl.JOB_UTIL_DELTA_PCT,
        healthy=(rng.random(n) > 0.15).astype(np.float32),
        uptime_hours=rng.uniform(1, 200, n), num_jobs=jobs), device=device)


def make_jobs(n, seed):
    """Job demands from a numpy seed: cpu U(1, 10) %, mem U(0.5, 5) %."""
    from repro_torch.sched import placement as pl

    rng = np.random.default_rng(seed)
    return [pl.JobSpec(c, m) for c, m in zip(rng.uniform(1, 10, n).tolist(),
                                             rng.uniform(0.5, 5, n).tolist())]


def topk_err(got, want):
    """Hold top-k candidates to the plain version's: finite values within
    the tolerance, NaN where it has NaN, indices equal wherever neighbouring
    candidate values differ by more than the tolerance, identical -inf / -1
    tails.  Returns (max abs error, index slots that differ at near ties)."""
    (gv, gi), (wv, wi) = ((v.cpu().numpy(), i.cpu().numpy())
                          for v, i in (got, want))
    assert gv.shape == wv.shape and gi.shape == wi.shape
    fin = np.isfinite(wv)
    assert np.array_equal(np.isfinite(gv), fin)
    assert np.array_equal(np.isnan(gv), np.isnan(wv))
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=RTOL, atol=ATOL)
    assert np.array_equal(gi[~fin], wi[~fin]) and bool((wi[~fin] == -1).all())
    with np.errstate(invalid="ignore"):        # -inf - -inf in the tails
        gap = (np.abs(np.diff(wv, axis=-1))
               <= ATOL + RTOL * np.abs(wv[..., :-1]))
    close = np.zeros_like(fin)
    close[..., 1:] |= gap
    close[..., :-1] |= gap
    assert np.array_equal(gi[fin & ~close], wi[fin & ~close])
    err = float(np.max(np.abs(gv[fin] - wv[fin]), initial=0.0))
    return err, int((gi != wi).sum())


def phase_new_kernels(device):
    """Kernels 2-5 against their plain versions (and kernel 4 against the
    unfused oracle up to N = 1000), then NaN weights into candidates."""
    from repro_torch.core import env
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import plan_fleet_layout
    from repro_torch.sched import placement as pl

    errs = dict.fromkeys(("sdqn_score", "sdqn_score_cols",
                          "sdqn_score_afterstate_topk",
                          "sdqn_score_cols_topk"), 0.0)
    near_tie_slots = 0
    for n in SHAPES_N:
        fleet = make_fleet(n, device, SEED + n)
        cols = pl.fleet_cols(fleet)
        for b in SHAPES_B:
            cfg, state, params, pods = make_case(n, b, device, SEED + n + b)
            if b == SHAPES_B[0]:
                feats = env.normalize_features(fleet.features())
                got = ops.sdqn_score(feats, params, mode="cuda")
                want = ops.sdqn_score(feats, params, mode="plain")
                torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
                errs["sdqn_score"] = max(errs["sdqn_score"],
                                         float((got - want).abs().max()))
            deltas = pl.job_deltas(make_jobs(b, SEED + n), device)
            got = ops.sdqn_score_delta(cols, deltas, params, mode="cuda")
            want = ops.sdqn_score_delta(cols, deltas, params, mode="plain")
            assert got.shape == (b, n)
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
            errs["sdqn_score_cols"] = max(errs["sdqn_score_cols"],
                                          float((got - want).abs().max()))
            for shards in (1, SHARDS):
                lay = plan_fleet_layout(n, shards=shards)
                size = n if lay is None else lay.shard_size
                for k in sorted({min(k, size) for k in K_SHAPES}):
                    cases = (
                        ("sdqn_score_afterstate_topk",
                         lambda m: ops.sdqn_topk_afterstate(
                             state, pods, cfg, params, k=k, layout=lay,
                             mode=m)),
                        ("sdqn_score_cols_topk",
                         lambda m: ops.sdqn_topk_delta(
                             cols, deltas, params, k=k, layout=lay, mode=m)))
                    for key, run in cases:
                        got = run("cuda")
                        err, swaps = topk_err(got, run("plain"))
                        errs[key] = max(errs[key], err)
                        near_tie_slots += swaps
                        if n <= 1000 and key == "sdqn_score_afterstate_topk":
                            topk_err(got, run("ref"))
            torch.cuda.synchronize()
        print(f"kernels 2-5 vs plain N={n}: B={SHAPES_B} k={K_SHAPES} "
              f"shards=(1, {SHARDS}) ok; max_abs_err so far {errs}")
    # a diverged net reaches the candidates as NaN (the daemon's guard)
    cfg, state, params, pods = make_case(5000, 4, device, SEED)
    bad = dict(params, b1=torch.full_like(params["b1"], float("nan")))
    lay = plan_fleet_layout(5000, shards=SHARDS)
    vals, idx = ops.sdqn_topk_afterstate(state, pods, cfg, bad, k=TOPK,
                                         layout=lay, mode="cuda")
    assert bool(torch.isnan(vals).all()) and bool((idx == -1).all())
    vals, _ = ops.sdqn_topk_delta(pl.fleet_cols(make_fleet(5000, device, 1)),
                                  pl.job_deltas(make_jobs(4, 1), device), bad,
                                  k=TOPK, layout=lay, mode="cuda")
    assert bool(torch.isnan(vals).all())
    print(f"NaN weights -> NaN candidates: ok; index slots that differ at "
          f"near ties: {near_tie_slots}")
    return errs


def phase_plan_kernels(device):
    """Kernels 1 and 3 against their plain versions at every branch of
    their launch plan (``sdqn_score.score_plan``): the sweep's N at
    ``PLAN_B`` pods and ``PLAN_EXTRA``."""
    from repro_torch.kernels import ops, sdqn_score as ss
    from repro_torch.sched import placement as pl

    errs = dict.fromkeys(("sdqn_score_afterstate", "sdqn_score_cols"), 0.0)
    branches = set()
    for n, b in [(n, b) for n in SHAPES_N for b in PLAN_B] + list(PLAN_EXTRA):
        plan = ss.score_plan(n, b)
        branches.add((plan.rows, plan.pod_rows))
        cfg, state, params, pods = make_case(n, b, device, SEED + n + b)
        deltas = pl.job_deltas(make_jobs(b, SEED + b), device)
        cols = pl.fleet_cols(make_fleet(n, device, SEED + n))
        for key, run in (
                ("sdqn_score_afterstate",
                 lambda m: ops.sdqn_score_afterstate(state, pods, cfg, params,
                                                     mode=m)),
                ("sdqn_score_cols",
                 lambda m: ops.sdqn_score_delta(cols, deltas, params,
                                                mode=m))):
            got = run("cuda")
            torch.cuda.synchronize()
            want = run("plain")
            assert got.shape == (b, n) and bool(torch.isfinite(got).all())
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
            errs[key] = max(errs[key], float((got - want).abs().max()))
        print(f"kernels 1 and 3 vs plain N={n} B={b}: ok; "
              f"{plan_text(n, b)}")
    assert branches == {(r, p) for r in ss.SCORE_ROWS
                        for p in (True, False) if p or r > 1}, branches
    print(f"kernels 1 and 3 at every plan branch {sorted(branches)}: "
          f"max_abs_err {errs}")
    return errs


def _sharded_setup(device):
    from repro_torch.core import dqn, env
    from repro_torch.core.types import fleet_cluster

    cfg = fleet_cluster(SHARDED_N)
    gen = torch.Generator().manual_seed(SEED)
    state = env.reset(gen, cfg, device=device)
    params = dqn.init_qnet(gen, device=device)
    return cfg, state, params


def _layout():
    from repro_torch.launch.mesh import plan_fleet_layout

    return plan_fleet_layout(SHARDED_N, shards=SHARDS)


def phase_sharded_cluster(device):
    """The sharded cluster path at 500/s and 4000/s: every batch is one
    launch of kernel 4."""
    from repro_torch.scenarios import arrival_trace
    from repro_torch.sched.daemon import (ClusterSubstrate, DaemonConfig,
                                          PlacementDaemon, replay_trace)

    cfg, state, params = _sharded_setup(device)
    runs = []
    for rate in RATES_PER_S:
        d = PlacementDaemon(ClusterSubstrate(state, cfg, device=device,
                                             layout=_layout(), topk=TOPK),
                            params, DaemonConfig(batch_size=32,
                                                 max_wait_s=0.005))
        d.warmup()
        trace = arrival_trace(torch.Generator().manual_seed(SEED + 2), cfg,
                              N_REQUESTS, rate_per_s=rate)
        runs.append((rate, d, trace))

    zero_counts()                                   # the path starts here
    per_rate = []
    for rate, d, trace in runs:
        before = read_counts()["sdqn_score_afterstate_topk"]
        dur = replay_trace(d, trace.t_s, trace.pods)
        per_rate.append((rate, d, dur, read_counts()[
            "sdqn_score_afterstate_topk"] - before))
    counts = read_counts()                          # ... and ends here

    for rate, d, dur, n_launch in per_rate:
        m = d.metrics
        assert m.bound + m.dropped == m.submitted == N_REQUESTS, m
        assert m.device_launches == m.batches == n_launch > 0, m
        check_outcome(d, cfg)
        lat = np.asarray(m.bind_latencies_s)
        print(f"sharded serve N={SHARDED_N} shards={SHARDS} topk={TOPK} "
              f"rate={int(rate)}/s: decisions/s={N_REQUESTS / dur} "
              f"p50_ms={np.percentile(lat, 50) * 1e3} "
              f"p99_ms={np.percentile(lat, 99) * 1e3} batches={m.batches} "
              f"kernel_launches={n_launch} bound={m.bound} "
              f"dropped={m.dropped} conflicts={m.conflicts}")
    print(f"sharded cluster path launches: {counts}")
    return counts["sdqn_score_afterstate_topk"]


def _replay_deterministic(d, clock, t_s, reqs):
    for t, req in zip(t_s, reqs):
        clock.t = float(t)
        d.submit(req, now=float(t))
        d.poll()
    clock.t = float(t_s[-1]) + 1.0
    d.drain()


def _spy_scores(d, log):
    """Log (decisions so far, scores or candidate values, feasibility or
    candidate indices) of every scored batch's real rows."""
    inner = d._scorer

    def spy(p, snap, pods, carry, n_real):
        a, b, carry = inner(p, snap, pods, carry, n_real)
        log.append((len(d.decisions), a[:n_real].cpu().numpy(),
                    b[:n_real].cpu().numpy()))
        return a, b, carry

    d._scorer = spy


def _near_tie(row, other, candidates):
    """True if the two best (feasible) values of a row lie within the
    tolerance."""
    top = row[np.isfinite(row)] if candidates else row[other]
    top = np.sort(top)[::-1][:2]
    return top.size == 2 and top[0] - top[1] <= ATOL + RTOL * abs(top[0])


def compare_runs(first, second, log, candidates, label):
    """Two runs' decisions must agree, except from the first batch (of
    ``log``, the scored batches of one run) where a request's two best
    candidates lie within the tolerance."""
    near, first_near = 0, None
    for done, a, b in log:
        ties = sum(_near_tie(r, o, candidates) for r, o in zip(a, b))
        near += ties
        if ties and first_near is None:
            first_near = done
    f_dec = [(x.req_id, x.node) for x in first.decisions]
    s_dec = [(x.req_id, x.node) for x in second.decisions]
    first_diff = next((i for i, (a, b) in enumerate(zip(f_dec, s_dec))
                       if a != b), None)
    if first_diff is None:
        assert len(f_dec) == len(s_dec)
    else:
        assert first_near is not None and first_diff >= first_near, (
            f"{label}: decision {first_diff} differs before any near tie")
    print(f"{label} deterministic replay: decisions={len(s_dec)} identical="
          f"{first_diff is None} first_difference={first_diff} "
          f"near_tie_rows={near} batches={len(log)}")


def phase_sharded_parity(device):
    from repro_torch.scenarios import arrival_trace
    from repro_torch.sched.daemon import (ClusterSubstrate, DaemonConfig,
                                          PlacementDaemon)

    runs = {}
    for layout in (None, _layout()):
        cfg, state, params = _sharded_setup(device)
        clock = StepClock()
        d = PlacementDaemon(ClusterSubstrate(state, cfg, device=device,
                                             layout=layout, topk=TOPK),
                            params, DaemonConfig(batch_size=32,
                                                 max_wait_s=0.005),
                            clock=clock, timer=clock)
        log = []
        if layout is not None:
            _spy_scores(d, log)
        trace = arrival_trace(torch.Generator().manual_seed(SEED + 2), cfg,
                              N_REQUESTS, rate_per_s=RATES_PER_S[0])
        _replay_deterministic(d, clock, trace.t_s, trace.pods)
        check_outcome(d, cfg)
        runs[layout is not None] = (d, log)
    compare_runs(runs[False][0], runs[True][0], runs[True][1], True,
                 "cluster flat vs sharded")


def check_fleet_outcome(d, n):
    from repro_torch.core.types import NO_PLACEMENT
    from repro_torch.sched import placement as pl

    m = d.metrics
    assert m.bound + m.dropped + m.shed == m.submitted, m
    assert len(d.decisions) == m.submitted
    for x in d.decisions:
        assert x.node == NO_PLACEMENT or 0 <= x.node < n
    lv = d._sub.live
    assert np.all(lv.cpu_pct <= d._sub.max_host_cpu_pct)
    assert np.all(lv.mem_pct <= pl.MEM_CEILING_PCT)
    assert np.all(lv.job_util_pct <= pl.JOB_UTIL_CEILING_PCT)
    assert int(lv.num_jobs.sum()) == m.bound
    for col in lv:
        assert np.all(np.isfinite(col))


def _fleet_daemon(device, layout, clock=None):
    from repro_torch.core import dqn
    from repro_torch.sched import placement as pl
    from repro_torch.sched.daemon import (DaemonConfig, FleetSubstrate,
                                          PlacementDaemon)

    gen = torch.Generator().manual_seed(SEED + 4)
    fleet = pl.fresh_fleet(SHARDED_N, gen, device=device)
    params = dqn.init_qnet(gen, device=device)
    kw = {} if clock is None else dict(clock=clock, timer=clock)
    return PlacementDaemon(FleetSubstrate(fleet, layout=layout, topk=TOPK,
                                          device=device), params,
                           DaemonConfig(batch_size=32, max_wait_s=0.005), **kw)


def _job_trace():
    from repro_torch.core.types import fleet_cluster
    from repro_torch.scenarios import arrival_trace

    t_s = arrival_trace(torch.Generator().manual_seed(SEED + 2),
                        fleet_cluster(8), N_REQUESTS,
                        rate_per_s=RATES_PER_S[0]).t_s
    return t_s, make_jobs(N_REQUESTS, SEED + 5)


def phase_fleet(device):
    """The job->host path on fresh_fleet(131072) at 500/s: flat (kernel 3)
    and sharded (kernel 5), one launch per batch; then both on a
    deterministic clock, whose decisions must agree."""
    from repro_torch.sched.daemon import replay_trace

    t_s, jobs = _job_trace()
    launches = {}
    for label, layout, key in (("flat", None, "sdqn_score_cols"),
                               ("sharded", _layout(),
                                "sdqn_score_cols_topk")):
        d = _fleet_daemon(device, layout)
        d.warmup()
        shapes = {}
        zero_counts()                               # the path starts here
        with launch_shapes(shapes):
            dur = replay_trace(d, t_s, jobs)
        counts = read_counts()                      # ... and ends here
        m = d.metrics
        assert m.bound + m.dropped == m.submitted == N_REQUESTS, m
        assert m.device_launches == m.batches == counts[key] > 0, (m, counts)
        check_fleet_outcome(d, SHARDED_N)
        lat = np.asarray(m.bind_latencies_s)
        print(f"job->host serve {label} N={SHARDED_N} rate=500/s: "
              f"decisions/s={N_REQUESTS / dur} "
              f"p50_ms={np.percentile(lat, 50) * 1e3} "
              f"p99_ms={np.percentile(lat, 99) * 1e3} batches={m.batches} "
              f"kernel_launches={counts[key]} bound={m.bound} "
              f"dropped={m.dropped} conflicts={m.conflicts} counts={counts} "
              f"launches by (kernel, N, B): {shapes} requests per batch "
              f"{N_REQUESTS / m.batches}")
        launches[key] = counts[key]
    runs = {}
    for layout in (None, _layout()):
        clock = StepClock()
        d = _fleet_daemon(device, layout, clock)
        log = []
        if layout is not None:
            _spy_scores(d, log)
        _replay_deterministic(d, clock, t_s, jobs)
        check_fleet_outcome(d, SHARDED_N)
        runs[layout is not None] = (d, log)
    compare_runs(runs[False][0], runs[True][0], runs[True][1], True,
                 "job->host flat vs sharded")
    return launches


def phase_engine(device):
    """PlacementEngine on the card: place_batch of 64 jobs (kernel 3 per
    select), and ``_score`` of built rows through kernel 2."""
    from repro_torch.core import dqn
    from repro_torch.core.types import NO_PLACEMENT
    from repro_torch.kernels import ops
    from repro_torch.sched import placement as pl

    gen = torch.Generator().manual_seed(SEED + 6)
    fleet = pl.fresh_fleet(SHARDED_N, gen, device=device)
    params = dqn.init_qnet(gen, device=device)
    eng = pl.PlacementEngine(params)
    shapes = {}
    zero_counts()                                   # the path starts here
    with launch_shapes(shapes):
        placed, hosts = eng.place_batch(fleet, 64, pl.JobSpec())
    q = eng._score(fleet.features())
    counts = read_counts()                          # ... and ends here
    assert shapes == {("sdqn_score_cols", SHARDED_N, 1): 64}, shapes
    assert counts["sdqn_score_cols"] == 64 and counts["sdqn_score"] == 1, (
        counts)
    zero = ops.sdqn_score_delta(pl.fleet_cols(fleet),
                                torch.zeros(6, device=device), params)
    torch.testing.assert_close(q, zero, rtol=RTOL, atol=ATOL)
    assert np.all((hosts != NO_PLACEMENT) & (hosts < SHARDED_N))
    assert int(placed.num_jobs.sum()) == 64
    assert float(placed.job_util_pct.max()) <= pl.JOB_UTIL_CEILING_PCT
    print(f"PlacementEngine: place_batch(64) distinct_hosts="
          f"{len(set(hosts.tolist()))} _score vs delta scorer at zero delta "
          f"max_abs_err={float((q - zero).abs().max())} counts={counts} "
          f"launches by (kernel, N, B): {shapes}")
    return counts["sdqn_score"]


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` of the CUDA driver API (cuda.h)."""
    _fields_ = [("func", ctypes.c_void_p)] + [
        (f, ctypes.c_uint) for f in ("grid_x", "grid_y", "grid_z", "block_x",
                                     "block_y", "block_z", "shared_bytes")] + [
        (f, ctypes.c_void_p) for f in ("kernel_params", "extra", "kern",
                                       "ctx")]


def device_kernels(fn) -> list:
    """Names (mangled) of the device kernels one call of ``fn`` runs: the
    kernel nodes of a CUDA graph that captures it, read with the driver
    API through ctypes (``cuGraphGetNodes``, ``cuGraphNodeGetType``,
    ``cuGraphKernelNodeGetParams_v2``, ``cuFuncGetName``); any other node
    (a copy, a memset) is listed by its type.  torch.profiler on the
    card's machine now and then delivers no event for a short session, for
    minutes on end; the graph does not depend on it.  Launches made here
    are restored by the caller."""
    cu = ctypes.CDLL("libcuda.so.1")

    def check(err):
        if err != 0:
            raise RuntimeError(f"CUDA driver error {err}")

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(count)))
    nodes = (ctypes.c_void_p * count.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)))
    names = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)))
        if kind.value != 0:                     # CU_GRAPH_NODE_TYPE_KERNEL
            names.append(f"graph node of type {kind.value}")
            continue
        params = _KernelNodeParams()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                               ctypes.byref(params)))
        name = ctypes.c_char_p()
        if params.func:
            check(cu.cuFuncGetName(ctypes.byref(name),
                                   ctypes.c_void_p(params.func)))
        else:
            check(cu.cuKernelGetName(ctypes.byref(name),
                                     ctypes.c_void_p(params.kern)))
        names.append(name.value.decode())
    graph.reset()
    return names


def phase_new_timings(device, name):
    """Kernels 2-5 at the main paths' shape (N = 131,072, B = 32, k = 8,
    8 shards), kernels 3-5 also at B = 1 (``PlacementEngine.select``'s
    batch; the daemons pad theirs to 32): device time from a CUDA graph,
    eager per-call time, the plain version's device time and the bound
    from this run's inputs, at B = 1 beside the launch floor.  For kernels
    3-5 also the launch plan that ran and the device kernels of one call
    (exactly one), and at both B kernels 4's and 5's candidates' values
    against kernels 1's and 3's scores of the same pairs (bit for bit)."""
    from repro_torch.core import env
    from repro_torch.kernels import ops, sdqn_score as ss
    from repro_torch.sched import placement as pl

    n, lay = SHARDED_N, _layout()
    fleet = pl.fresh_fleet(n, torch.Generator().manual_seed(SEED + 8),
                           device=device)
    cols = pl.fleet_cols(fleet)
    feats = env.normalize_features(fleet.features())
    geo = dict(k=TOPK, shards=lay.shards, shard_size=lay.shard_size)
    ceil = ops.DEFAULT_CEILINGS
    floor = launch_floor_ms()
    rows = {}
    for b in (MAIN_B, 1):
        cfg, state, params, pods = make_case(n, b, device, SEED + 7)
        deltas = pl.job_deltas(make_jobs(b, SEED + 9), device)
        w = (params["w1"], params["b1"], params["w2"], params["b2"])
        a_inputs = ops._afterstate_inputs(state, pods, cfg, params)
        t_cols = a_inputs[0] + (state.cpu_requested, state.mem_requested)
        creq = ops._pod_column(pods.cpu_request, device)
        mreq = ops._pod_column(pods.mem_request, device)
        batch = type(pods)(*(x[:, None] for x in pods))
        feasible_pods = int(env.feasible(state, batch, cfg).sum())
        feasible_jobs = int(pl.feasible_deltas(fleet, deltas).sum())
        cand = b * lay.shards * TOPK * CAND_BYTES
        cases = {
            "sdqn_score_afterstate_topk": (
                lambda: ss.sdqn_score_afterstate_topk(
                    t_cols, a_inputs[1], a_inputs[2], creq, mreq,
                    *a_inputs[3:], **geo),
                lambda: ss.sdqn_score_afterstate_topk_plain(
                    t_cols, a_inputs[1], a_inputs[2], creq, mreq,
                    *a_inputs[3:], **geo),
                n * TOPK_BYTES_PER_NODE + b * 16 + WEIGHT_BYTES + cand,
                b * n * TOPK_FILTER_OPS_PER_PAIR + n * TOPK_OPS_PER_NODE
                + feasible_pods * TOPK_OPS_PER_FEASIBLE),
            "sdqn_score_cols_topk": (
                lambda: ss.sdqn_score_cols_topk(cols, deltas,
                                                ops.FEATURE_SCALE, *w, ceil,
                                                **geo),
                lambda: ss.sdqn_score_cols_topk_plain(
                    cols, deltas, ops.FEATURE_SCALE, *w, ceil, **geo),
                n * COLS_BYTES_PER_HOST + b * DELTA_BYTES + WEIGHT_BYTES
                + cand,
                b * n * COLS_TOPK_FILTER_OPS_PER_PAIR
                + n * COLS_TOPK_OPS_PER_HOST
                + feasible_jobs * COLS_TOPK_OPS_PER_FEASIBLE + 6 * 32),
        }
        cases["sdqn_score_cols"] = (
            lambda: ss.sdqn_score_cols(cols, deltas, ops.FEATURE_SCALE, *w),
            lambda: ss.sdqn_score_cols_plain(cols, deltas, ops.FEATURE_SCALE,
                                             *w),
            n * COLS_BYTES_PER_HOST + b * DELTA_BYTES + WEIGHT_BYTES
            + b * n * 4, b * n * COLS_OPS_PER_PAIR + 6 * 32)
        if b == MAIN_B:
            cases["sdqn_score"] = (
                lambda: ss.sdqn_score(feats, *w),
                lambda: ss.sdqn_score_plain(feats, *w),
                n * SCORE_BYTES_PER_ROW + WEIGHT_BYTES, n * SCORE_OPS_PER_ROW)
        # the scores kernels 4 and 5 select from: kernels 1 and 3
        scores = {"sdqn_score_afterstate_topk":
                  ss.sdqn_score_afterstate(*a_inputs),
                  "sdqn_score_cols_topk": cases["sdqn_score_cols"][0]()}
        for key, (fn, plain, nbytes, n_ops) in cases.items():
            saved = read_counts()
            ms = graph_time_ms(fn, 100)
            call_ms = cuda_time_ms(fn, 100)
            names = device_kernels(fn)
            assert len(names) == 1 and key in names[0], names
            extra = f"device kernels per call: {len(names)}; "
            if key.endswith("_topk"):
                plan = ss.topk_plan(n, b, lay.shards, lay.shard_size)
                extra += (f"plan: cluster={plan.cluster} pods={plan.pods} "
                          f"chunk={plan.chunk} grid={plan.grid} "
                          f"blocks={plan.blocks} ")
            elif key == "sdqn_score_cols":
                extra += plan_text(n, b) + " "
            elif key == "sdqn_score":
                extra += plan_text(n, 1) + " "
            if key in scores:
                v, i = fn()
                real = i >= 0
                at = torch.gather(scores[key], 1,
                                  i.clamp(min=0).flatten(1)).view_as(v)
                differ = int((v[real] != at[real]).sum())
                assert differ == 0 and int(real.sum()) > 0, (key, differ)
                extra += (f"values bit for bit the scoring kernel's: "
                          f"{int(real.sum())} candidates, {differ} differ ")
            for k, fnc in wrappers().items():     # timing launches don't count
                fnc.launches = saved[k]
            plain_ms = graph_time_ms(plain, 10)
            b_ms, b_by = roofline(nbytes, n_ops, name)
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            if b == MAIN_B:
                rows[key] = row
            else:
                rows[key]["other_shapes"] = [dict(row, b=b,
                                                  launch_floor_ms=floor)]
                extra += f"kernel/launch_floor={ms / floor} "
            print(f"timing {key} N={n} "
                  f"B={b if key != 'sdqn_score' else '-'} k={TOPK} "
                  f"shards={lay.shards}: kernel_ms={ms} plain_ms={plain_ms} "
                  f"(device time, CUDA graph) kernel_call_ms={call_ms} "
                  f"(eager call, host included) bound_ms={b_ms} ({b_by}; "
                  f"bytes={nbytes} ops={n_ops}, {peaks(name)[0]} peaks) "
                  f"kernel/bound={ms / b_ms} {extra}")
        print(f"feasible pairs in the timed inputs at B={b}: pods x nodes="
              f"{feasible_pods} of {b * n}, jobs x hosts={feasible_jobs} of "
              f"{b * n}")
    # kernel 2 also at the flat cluster's N = 5,000 (rows of a fresh fleet)
    n2 = MAIN_N
    f2 = env.normalize_features(pl.fresh_fleet(
        n2, torch.Generator().manual_seed(SEED + 8), device=device)
        .features()).contiguous()
    w = (params["w1"], params["b1"], params["w2"], params["b2"])
    saved = read_counts()
    k_ms = graph_time_ms(lambda: ss.sdqn_score(f2, *w), 100)
    names = device_kernels(lambda: ss.sdqn_score(f2, *w))
    assert len(names) == 1 and "sdqn_score" in names[0], names
    for k, fnc in wrappers().items():
        fnc.launches = saved[k]
    plain_ms = graph_time_ms(lambda: ss.sdqn_score_plain(f2, *w), 10)
    b_ms, b_by = roofline(n2 * SCORE_BYTES_PER_ROW + WEIGHT_BYTES,
                          n2 * SCORE_OPS_PER_ROW, name)
    rows["sdqn_score"]["other_shapes"] = [dict(
        ms=k_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, n=n2,
        launch_floor_ms=floor)]
    print(f"timing sdqn_score N={n2}: kernel_ms={k_ms} plain_ms={plain_ms} "
          f"(device time, CUDA graph) bound_ms={b_ms} ({b_by}) kernel/bound="
          f"{k_ms / b_ms} kernel/launch_floor={k_ms / floor} device kernels "
          f"per call: {len(names)}; {plan_text(n2, 1)}")
    return rows


def phase_sharded_breakdown(device):
    """Where one sharded-cluster batch's time goes at 4000/s offered: host
    spans (synchronizing) around snapshot publish, pack, the top-k
    kernel's wrapper (one launch), the merge of the shards' candidates,
    candidate read-back and commit; torch.profiler's device time by
    kernel."""
    from repro_torch.kernels import sdqn_score as ss
    from repro_torch.scenarios import arrival_trace
    from repro_torch.sched.daemon import (ClusterSubstrate, DaemonConfig,
                                          PlacementDaemon)

    cfg, state, params = _sharded_setup(device)
    sub = ClusterSubstrate(state, cfg, device=device, layout=_layout(),
                           topk=TOPK)
    d = PlacementDaemon(sub, params, DaemonConfig(batch_size=32,
                                                  max_wait_s=0.005))
    d.warmup()
    spans = Spans()
    kernel, merge = ss.sdqn_score_afterstate_topk, ss.merge_topk
    ss.sdqn_score_afterstate_topk = spans.wrap("topk_kernel", kernel,
                                               sync=True)
    # the wrapper counts its launches on whatever its module name holds
    ss.sdqn_score_afterstate_topk.launches = kernel.launches
    ss.merge_topk = spans.wrap("shard_merge", merge, sync=True)
    try:
        sub.snapshot = spans.wrap("snapshot_publish", sub.snapshot, sync=True)
        sub.pack = spans.wrap("pack_pods", sub.pack, sync=True)
        d._scorer = spans.wrap("score_total", d._scorer, sync=True)
        d._fetch = spans.wrap("candidate_readback", d._fetch)
        d._commit_candidates = spans.wrap("commit", d._commit_candidates)
        d._process_batch = spans.wrap("batch_total", d._process_batch)
        trace = arrival_trace(torch.Generator().manual_seed(SEED + 3), cfg,
                              500, rate_per_s=RATES_PER_S[1])
        profiled_replay(d, trace, spans, "sharded")
    finally:
        ss.sdqn_score_afterstate_topk, ss.merge_topk = kernel, merge


# ---------------------------------------------------------------------------
# kernels 6 and 7: the attention and Mamba policy classes
# ---------------------------------------------------------------------------


@functools.cache
def sfu_rate():
    """Exponentials a second: 16 a clock on each SM at the card's maximum
    SM clock (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = SFU_PER_CLOCK_PER_SM * sms * mhz * 1e6
    print(f"bound: exponentials at {SFU_PER_CLOCK_PER_SM} a clock x {sms} "
          f"SMs x {mhz} MHz (clocks.max.sm) = {rate}/s")
    return rate


def attention_bound(b, hq, hkv, sq, skv, d, pairs, itemsize, name,
                    cache_itemsize=None):
    """(ms, by, bytes, ops, terms) of one attention call with ``pairs``
    visible (query, key) pairs per (batch, query head): the largest of
    q, k, v read once and the output written once at the memory rate (q
    and the output ``itemsize`` bytes an element, k and v
    ``cache_itemsize``, by default the same), the products, the
    exponentials and the softmax's other operations, each at its rate
    (above).  ``terms`` holds the four times in ms."""
    cache_itemsize = cache_itemsize or itemsize
    nbytes = (itemsize * 2 * b * sq * hq * d
              + cache_itemsize * 2 * b * skv * hkv * d)
    n = b * hq * pairs
    key, (f32_peak, bw) = peaks(name)
    if itemsize == 2:
        products, mma_peak = 4 * d * n, BF16_PEAK[key]
    else:
        products, mma_peak = TF32_PRODUCTS * 4 * d * n, BF16_PEAK[key] / 2
    terms = {"bytes": nbytes / bw * 1e3,
             "products": products / mma_peak * 1e3,
             "exponentials": n / sfu_rate() * 1e3,
             "softmax": SOFTMAX_OPS_PER_PAIR * n / f32_peak * 1e3}
    by = max(terms, key=terms.get)
    return (terms[by], "bytes" if by == "bytes" else "operations", nbytes,
            products + (SOFTMAX_OPS_PER_PAIR + 1) * n, terms)


def causal_pairs(sq, skv):
    """Visible (query, key) pairs of one head under causal."""
    return int(np.minimum(skv, np.arange(sq) + skv - sq + 1).sum())


def scan_bound_terms(shape, name):
    """{bytes, operations, exponentials: ms} of one selective scan: every
    input read once (x, dt, A, B, C, D, h0) and y and hT written once at
    the memory rate; the float32 operations at the float32 peak; one
    exponential a (batch, step, channel, state) at ``sfu_rate``."""
    b, s, di, n = shape
    nbytes = 4 * (3 * b * s * di + di * n + 2 * b * s * n + di
                  + 2 * b * di * n)
    ops = b * s * di * (n * SCAN_OPS_PER_STATE + SCAN_OPS_PER_CHANNEL)
    _, (flops, bw) = peaks(name)
    return {"bytes": nbytes / bw * 1e3, "operations": ops / flops * 1e3,
            "exponentials": b * s * di * n / sfu_rate() * 1e3}


def scan_bound(shape, name):
    """(ms, by, bytes, ops) of one selective scan: the largest of
    ``scan_bound_terms``."""
    b, s, di, n = shape
    terms = scan_bound_terms(shape, name)
    by = max(terms, key=terms.get)
    nbytes = 4 * (3 * b * s * di + di * n + 2 * b * s * n + di
                  + 2 * b * di * n)
    ops = b * s * di * (n * SCAN_OPS_PER_STATE + SCAN_OPS_PER_CHANNEL)
    return (terms[by], "bytes" if by == "bytes" else "operations", nbytes,
            ops)


def _qkv(shape, device, seed):
    b, sq, skv, hq, hkv, d = shape
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(x, generator=gen).to(device) for x in
                 ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))


def _scan_args(shape, device, seed):
    """The reference's sweep distributions (tests/test_kernels.py)."""
    b, s, di, n = shape
    gen = torch.Generator().manual_seed(seed)

    def r(*dims):
        return torch.randn(dims, generator=gen)

    args = (r(b, s, di) * 0.5,
            torch.nn.functional.softplus(r(b, s, di) * 0.3 - 1.0),
            -torch.exp(r(di, n) * 0.3), r(b, s, n) * 0.5, r(b, s, n) * 0.5,
            torch.ones(di), r(b, di, n) * 0.1)
    return tuple(a.to(device) for a in args)


def phase_seq_kernels(device):
    """Kernels 7 and 6 against their plain versions on the card; kernel 6
    also across its chunk edges and its pad rows' carry bit for bit."""
    from repro_torch.kernels import mamba_scan as ms, ops

    errs = {"flash_attention": 0.0, "mamba_scan": 0.0}
    for shape in FA_SHAPES + (FA_PATH,):
        for causal in (False, True):
            q, k, v = _qkv(shape, device, sum(shape))
            got = ops.flash_attention(q, k, v, causal=causal, mode="cuda")
            torch.cuda.synchronize()
            want = ops.flash_attention(q, k, v, causal=causal, mode="plain")
            assert got.shape == q.shape and bool(torch.isfinite(got).all())
            err = float((got - want).abs().max())
            print(f"flash_attention vs plain (B, Sq, Skv, Hq, Hkv, D)={shape} "
                  f"causal={causal}: max_abs_err={err} (tolerance {FA_TOL})")
            torch.testing.assert_close(got, want, rtol=FA_TOL, atol=FA_TOL)
            errs["flash_attention"] = max(errs["flash_attention"], err)
    for shape in SCAN_SHAPES + (SCAN_PATH, SCAN_WIDE):
        args = _scan_args(shape, device, sum(shape))
        y, h = ops.mamba_scan(*args, mode="cuda")
        torch.cuda.synchronize()
        wy, wh = ops.mamba_scan(*args, mode="plain")
        assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
        err = max(float((y - wy).abs().max()), float((h - wh).abs().max()))
        print(f"mamba_scan vs plain (B, S, di, N)={shape}: max_abs_err={err} "
              f"(tolerance {SCAN_TOL})")
        torch.testing.assert_close(y, wy, rtol=SCAN_TOL, atol=SCAN_TOL)
        torch.testing.assert_close(h, wh, rtol=SCAN_TOL, atol=SCAN_TOL)
        errs["mamba_scan"] = max(errs["mamba_scan"], err)
    edge = {}
    for s in SCAN_EDGE_S:
        for di in SCAN_EDGE_DI:
            for n in ms.STATE_SIZES:
                args = _scan_args((1, s, di, n), device, s + di + n)
                y, h = ops.mamba_scan(*args, mode="cuda")
                wy, wh = ops.mamba_scan(*args, mode="plain")
                torch.testing.assert_close(y, wy, rtol=SCAN_TOL, atol=SCAN_TOL)
                torch.testing.assert_close(h, wh, rtol=SCAN_TOL, atol=SCAN_TOL)
                edge[(s, di, n)] = max(float((y - wy).abs().max()),
                                       float((h - wh).abs().max()))
    errs["mamba_scan"] = max(errs["mamba_scan"], *edge.values())
    print(f"mamba_scan vs plain at S in {SCAN_EDGE_S}, di in {SCAN_EDGE_DI}, "
          f"N in {ms.STATE_SIZES} (B = 1, {len(edge)} shapes): max_abs_err="
          f"{max(edge.values())} at (S, di, N)={max(edge, key=edge.get)} "
          f"(tolerance {SCAN_TOL}); plans: " + "; ".join(
              f"N={n}: {ms.scan_plan(1, 1024, n)}" for n in ms.STATE_SIZES))
    for n in ms.STATE_SIZES:
        x, dt, a, bm, cm, d, h0 = _scan_args((2, 96, 8, n), device, n)
        for n_real in SCAN_PAD_REAL:
            dt_pad = dt.clone()
            dt_pad[:, n_real:] = 0.0
            _, h_pad = ms.mamba_scan(x, dt_pad, a, bm, cm, d, h0)
            cut = [t[:, :n_real].contiguous() for t in (x, dt, bm, cm)]
            _, h_cut = ms.mamba_scan(cut[0], cut[1], a, cut[2], cut[3], d, h0)
            assert torch.equal(h_pad, h_cut), (n, n_real)
    print(f"mamba_scan: dt = 0 pad rows after n_real in {SCAN_PAD_REAL} of "
          f"96 leave hT bit for bit the cut sequence's, N in "
          f"{ms.STATE_SIZES}")
    return errs


POLICY_KERNEL = {"attention": "flash_attention", "mamba": "mamba_scan"}


def _policy_daemon(device, name, fused="auto", clock=None):
    """``PlacementDaemon`` over ``ClusterSubstrate(fleet_cluster(5000),
    policy=name)``, params from the class's ``init`` and a seed."""
    from repro_torch.core import policy
    from repro_torch.sched.daemon import (ClusterSubstrate, DaemonConfig,
                                          PlacementDaemon)

    cfg, state, _ = _serving_setup(device)
    spec = policy.get(name)
    params = spec.init(torch.Generator().manual_seed(SEED + 1), device=device)
    kw = {} if clock is None else dict(clock=clock, timer=clock)
    return cfg, PlacementDaemon(
        ClusterSubstrate(state, cfg, device=device, policy=spec), params,
        DaemonConfig(batch_size=32, max_wait_s=0.005, fused=fused), **kw)


def phase_policy_paths(device):
    """The attention and mamba daemons at 5,000 nodes, 2,000 requests at
    500/s: every batch is ONE launch of kernel 7 (attention) or of kernel 6
    (mamba), and no other kernel runs."""
    from repro_torch.scenarios import arrival_trace
    from repro_torch.sched.daemon import replay_trace

    launches = {}
    for name, key in POLICY_KERNEL.items():
        cfg, d = _policy_daemon(device, name)
        d.warmup()
        trace = arrival_trace(torch.Generator().manual_seed(SEED + 2), cfg,
                              N_REQUESTS, rate_per_s=RATES_PER_S[0])
        zero_counts()                               # the path starts here
        dur = replay_trace(d, trace.t_s, trace.pods)
        counts = read_counts()                      # ... and ends here
        m = d.metrics
        assert m.bound + m.dropped == m.submitted == N_REQUESTS, m
        assert m.device_launches == m.batches == counts[key] > 0, (m, counts)
        assert sum(counts.values()) == counts[key], counts
        check_outcome(d, cfg)
        lat = np.asarray(m.bind_latencies_s)
        print(f"{name} serve N={MAIN_N} rate={int(RATES_PER_S[0])}/s: "
              f"decisions/s={N_REQUESTS / dur} "
              f"p50_ms={np.percentile(lat, 50) * 1e3} "
              f"p99_ms={np.percentile(lat, 99) * 1e3} batches={m.batches} "
              f"kernel_launches={counts[key]} bound={m.bound} "
              f"dropped={m.dropped} conflicts={m.conflicts} counts={counts}")
        launches[key] = counts[key]
    return launches


def phase_policy_parity(device):
    """Both classes on a deterministic clock, the 2,000 requests of the
    4000/s trace (batches of ~20), through the kernels and through their
    plain versions (``fused="plain"``): the decisions must agree up to the
    first batch with a near tie, and the scores of the batches both runs
    cut alike within the tolerance."""
    from repro_torch.scenarios import arrival_trace

    for name in POLICY_KERNEL:
        runs = {}
        for fused in ("auto", "plain"):
            clock = StepClock()
            cfg, d = _policy_daemon(device, name, fused=fused, clock=clock)
            log = []
            _spy_scores(d, log)
            trace = arrival_trace(torch.Generator().manual_seed(SEED + 2), cfg,
                                  N_REQUESTS, rate_per_s=RATES_PER_S[1])
            _replay_deterministic(d, clock, trace.t_s, trace.pods)
            check_outcome(d, cfg)
            runs[fused] = (d, log)
        (kern, k_log), (plain, p_log) = runs["auto"], runs["plain"]
        compare_runs(kern, plain, k_log, False, f"{name} cuda vs plain")
        scores_agree(k_log, p_log, name)


def phase_policy_arms(device):
    """The classes' FleetSubstrate (flat and 8 shards) and sharded cluster
    arms at N = 16,384, 96 requests on a deterministic clock, through the
    kernels and through their plain versions: decisions agree up to the
    first near tie, the scores of the batches both runs cut alike within
    the tolerance; the kernel run is one launch of its class's kernel per
    batch and of no other, the plain run launches none."""
    from repro_torch.core import env, policy
    from repro_torch.core.types import fleet_cluster
    from repro_torch.launch.mesh import plan_fleet_layout
    from repro_torch.scenarios import arrival_trace
    from repro_torch.sched import placement as pl
    from repro_torch.sched.daemon import (ClusterSubstrate, DaemonConfig,
                                          FleetSubstrate, PlacementDaemon)

    n = POLICY_ARMS_N
    lay = plan_fleet_layout(n, shards=SHARDS)
    cfg = fleet_cluster(n)
    state = env.reset(torch.Generator().manual_seed(SEED), cfg, device=device)
    fleet = pl.fresh_fleet(n, torch.Generator().manual_seed(SEED + 12),
                           device=device)
    trace = arrival_trace(torch.Generator().manual_seed(SEED + 2), cfg,
                          POLICY_ARM_REQUESTS, rate_per_s=RATES_PER_S[1])
    jobs = make_jobs(POLICY_ARM_REQUESTS, SEED + 5)
    for name, key in POLICY_KERNEL.items():
        spec = policy.get(name)
        params = spec.init(torch.Generator().manual_seed(SEED + 1),
                           device=device)
        arms = (
            ("job->host flat", lambda: FleetSubstrate(
                fleet, policy=spec, device=device), jobs, False),
            ("job->host sharded", lambda: FleetSubstrate(
                fleet, policy=spec, layout=lay, topk=TOPK, device=device),
             jobs, True),
            ("cluster sharded", lambda: ClusterSubstrate(
                state, cfg, device=device, policy=spec, layout=lay,
                topk=TOPK), trace.pods, True))
        for label, make, reqs, candidates in arms:
            runs = {}
            for fused in ("auto", "plain"):
                clock = StepClock()
                d = PlacementDaemon(make(), params, DaemonConfig(
                    batch_size=32, max_wait_s=0.005, fused=fused),
                    clock=clock, timer=clock)
                log = []
                _spy_scores(d, log)
                zero_counts()                       # the arm starts here
                _replay_deterministic(d, clock, trace.t_s, reqs)
                counts = read_counts()              # ... and ends here
                if isinstance(d._sub, FleetSubstrate):
                    check_fleet_outcome(d, n)
                else:
                    check_outcome(d, cfg)
                assert d.metrics.device_launches == len(log) > 0
                want = len(log) if fused == "auto" else 0
                assert counts[key] == want == sum(counts.values()), (
                    label, fused, counts)
                runs[fused] = (d, log)
            (kern, k_log), (plain, p_log) = runs["auto"], runs["plain"]
            arm = f"{name} {label} N={n}"
            compare_runs(kern, plain, k_log, candidates, f"{arm} cuda vs plain")
            scores_agree(k_log, p_log, arm)
            print(f"{arm}: {key} launches={len(k_log)} (one per batch, no "
                  f"other kernel)")


POLICY_BREAKDOWN_REQUESTS = 400


def phase_policy_breakdown(device):
    """Where an attention batch's and a mamba batch's time goes on their
    main path (5,000 nodes, 500/s offered, 400 requests): the spans of
    phase 5 (``score_total`` is the whole scorer) and inside the scorer
    the encoder (mamba: projections and kernel 6), the afterstate rows
    (``hypothetical_place``, ``normalize_features``), ``score_set``
    (attention: projections, kernel 7 and the head; mamba: the embed and
    the Q-head), the kernel's wrapper alone and the feasibility mask.
    Every span synchronizes, and spans nest."""
    from repro_torch.core import env as kenv, policy
    from repro_torch.kernels import ops
    from repro_torch.scenarios import arrival_trace

    for name, key in POLICY_KERNEL.items():
        spec = policy.get(name)
        spans = Spans()
        traced = dataclasses.replace(spec, score_set=spans.wrap(
            "score_set", spec.score_set, sync=True))
        if spec.encode_sequence is not None:
            traced = dataclasses.replace(traced, encode_sequence=spans.wrap(
                "encoder", spec.encode_sequence, sync=True))
        patched = [(kenv, "hypothetical_place"), (kenv, "normalize_features"),
                   (kenv, "feasible"), (ops, key)]
        saved = [getattr(m, a) for m, a in patched]
        policy.register(traced)               # the daemon serves the traced
        try:                                  # spec; restored below
            for m, a in patched:
                setattr(m, a, spans.wrap(
                    f"kernel_wrapper_{a}" if m is ops else a, getattr(m, a),
                    sync=True))
            cfg, d = _policy_daemon(device, name)
            d.warmup()
            sub = d._sub
            sub.snapshot = spans.wrap("snapshot_publish", sub.snapshot,
                                      sync=True)
            sub.pack = spans.wrap("pack_pods", sub.pack, sync=True)
            d._scorer = spans.wrap("score_total", d._scorer, sync=True)
            sub.feasible_one = spans.wrap("bind_revalidate", sub.feasible_one)
            sub.bind = spans.wrap("bind_commit", sub.bind)
            d._process_batch = spans.wrap("batch_total", d._process_batch)
            spans.total.clear()
            spans.count.clear()
            trace = arrival_trace(torch.Generator().manual_seed(SEED + 3),
                                  cfg, POLICY_BREAKDOWN_REQUESTS,
                                  rate_per_s=RATES_PER_S[0])
            profiled_replay(d, trace, spans, name)
        finally:
            policy.register(spec)
            for (m, a), fn in zip(patched, saved):
                setattr(m, a, fn)
        m = d.metrics
        assert m.bound + m.dropped == m.submitted == POLICY_BREAKDOWN_REQUESTS


def phase_seq_timings(device, name):
    """Kernels 7 and 6 at their main paths' shapes: device time from a CUDA
    graph, the plain versions' likewise, the bound from these inputs, and
    for kernel 7 ``torch.nn.functional.scaled_dot_product_attention`` on
    the same tensors in PyTorch's (B, H, S, D) layout (``library_ms``, a
    CUDA graph likewise; the port never calls it)."""
    from repro_torch.kernels import flash_attention as fa, mamba_scan as ms

    rows = {}
    saved = read_counts()
    q, k, v = _qkv(FA_PATH, device, SEED + 11)
    kernel_ms = graph_time_ms(lambda: fa.flash_attention(q, k, v,
                                                         causal=False), 20)
    call_ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v, causal=False),
                           20)
    plain_ms = graph_time_ms(lambda: fa.flash_attention_plain(
        q, k, v, causal=False), 3, reps=3)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = graph_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt),
        20)
    lib_err = float((torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt).transpose(1, 2) - fa.flash_attention(
            q, k, v, causal=False)).abs().max())
    b, sq, skv, hq, hkv, d = FA_PATH
    b_ms, b_by, nbytes, n_ops, terms = attention_bound(
        b, hq, hkv, sq, skv, d, sq * skv, 4, name)
    rows["flash_attention"] = dict(ms=kernel_ms, plain_ms=plain_ms,
                                   bound_ms=b_ms, bound_by=b_by,
                                   library_ms=library_ms,
                                   bound_terms_ms=terms)
    print(f"timing flash_attention (B, Sq, Skv, Hq, Hkv, D)={FA_PATH}: "
          f"kernel_ms={kernel_ms} plain_ms={plain_ms} (device time, CUDA "
          f"graph) kernel_call_ms={call_ms} library_ms={library_ms} (SDPA, "
          f"CUDA graph; max_abs_diff to the kernel {lib_err}) "
          f"bound_ms={b_ms} ({b_by}; bytes={nbytes} ops={n_ops}, "
          f"{peaks(name)[0]} peaks; terms_ms {terms}) "
          f"kernel/bound={kernel_ms / b_ms}")
    floor = launch_floor_ms()
    for shape, iters in ((SCAN_PATH, 200), (SCAN_WIDE, 50)):
        args = _scan_args(shape, device, SEED + 13)
        kernel_ms = graph_time_ms(lambda: ms.mamba_scan(*args), iters)
        call_ms = cuda_time_ms(lambda: ms.mamba_scan(*args), iters)
        names = device_kernels(lambda: ms.mamba_scan(*args))
        assert len(names) == 1 and "mamba_scan" in names[0], names
        plain_ms = graph_time_ms(lambda: ms.mamba_scan_plain(*args), 3,
                                 reps=3)
        b_ms, b_by, nbytes, n_ops = scan_bound(shape, name)
        plan = ms.scan_plan(shape[0], shape[2], shape[3])
        row = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, launch_floor_ms=floor,
                   plan=dataclasses.asdict(plan))
        if shape == SCAN_PATH:
            rows["mamba_scan"] = dict(row, library_ms=None)
        else:
            rows["mamba_scan"]["other_shapes"] = [dict(row, shape=shape)]
        print(f"timing mamba_scan (B, S, di, N)={shape}: kernel_ms="
              f"{kernel_ms} plain_ms={plain_ms} (device time, CUDA graph) "
              f"kernel_call_ms={call_ms} bound_ms={b_ms} ({b_by}; "
              f"bytes={nbytes} ops={n_ops}, {peaks(name)[0]} peaks) "
              f"kernel/bound={kernel_ms / b_ms} launch_floor_ms={floor} "
              f"kernel/launch_floor={kernel_ms / floor} device kernels per "
              f"call: {len(names)}; plan: {plan} chunk={plan.chunk} "
              f"blocks={plan.blocks}")
    for key, fn in wrappers().items():          # timing launches don't count
        fn.launches = saved[key]
    return rows


# ---------------------------------------------------------------------------
# kernels 8 and 7 (bfloat16, D = 128): the LM serving path
# ---------------------------------------------------------------------------

# kernel 8 at the reference's sweep (tests/test_kernels.py: (B, Hq, Hkv, S,
# D)) and at long context in bfloat16: OLMo-1B's (16 heads of 128, MHA,
# 2.1 GB of K/V) and granite-8b's GQA (32 query heads on 8 key/value heads)
DECODE_SWEEP = ((1, 4, 4, 128, 32), (2, 8, 2, 256, 64), (3, 4, 1, 512, 16))
DECODE_LONG = ((8, 16, 16, 32768, 128), (8, 32, 8, 32768, 128))
LM_TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py
# kernel 8 at the GQA groups of src/repro/configs and at 24 (two chunks of
# 16 query heads): (B, Hkv, S, D) of a (B, S, Hkv, D) cache view
DECODE_GROUPS = (1, 4, 6, 8, 12, 16, 24)
DECODE_GROUP_SHAPE = (4, 8, 4096, 128)
E4M3 = "float8_e4m3fn"       # the reference's float8 cache_dtype
# kernel 8's timed rows (phases 14 and 20, scripts/decode_timings.py): the
# LM paths' (B, Hq, Hkv, S, D), kv_len, cache dtype and graph calls
DECODE_TIMED = {
    "path": ((8, 16, 16, 544, 128), 543, "bfloat16", 200),
    "olmo_32k": ((8, 16, 16, 32768, 128), 32768, "bfloat16", 50),
    "granite_32k": ((8, 32, 8, 32768, 128), 32768, "bfloat16", 50),
    "granite_32k_e4m3": ((8, 32, 8, 32768, 128), 32768, E4M3, 50),
    "granite_path": ((8, 32, 8, 544, 128), 543, "bfloat16", 200),
    "granite_path_e4m3": ((8, 32, 8, 544, 128), 543, E4M3, 200),
    "whisper_cross": ((8, 16, 16, 1500, 64), 1500, "bfloat16", 200),
    "dbrx_decode": ((8, 48, 8, 544, 128), 543, "bfloat16", 200),
}
# kernel 7 at OLMo-1B's prefill: 8 prompts of 512 tokens, 16 heads of 128
FA_LM_PREFILL = (8, 512, 512, 16, 16, 128)
# the LM serving path: full-width, full-depth OLMo-1B, 4 waves of 8
# requests, prompts of 512 tokens, 32 generated tokens each
SERVE_ARGS = ["--arch", "olmo-1b", "--replicas", "4", "--requests", "32",
              "--wave-size", "8", "--prompt-len", "512", "--gen-tokens", "32",
              "--seed", "0"]
SERVE_WAVES, SERVE_PROMPT, SERVE_GEN = 4, 512, 32
# OLMo-1B's published widths: name, layers, d_model, heads, head width,
# d_ff, padded vocab
OLMO_1B = ("olmo-1b", 16, 2048, 16, 128, 8192, 50304)
# kernel vs plain run of one wave on the card.  In bfloat16 they differ in
# the attention kernels' order of float32 sums, so an output may round to
# a neighbouring bfloat16 value, and that carries through 16 layers of
# bfloat16 roundings: the prefill logits of both are held to a float32 run
# of the same weights, each within LOGIT_TOL plus the plain run's own
# distance from it.  In float32 the two differ by the order of sums alone:
# within F32_LOGIT_TOL (the CPU tests' float32 tolerance on logits).  Each
# row's tokens identical up to its first step whose two best logits lie
# within twice the tolerance.
LOGIT_TOL = 5e-2
F32_LOGIT_TOL = 1e-4
DECODE_PROFILE_STEPS = 8


def _decode_case(shape, dtype, device, seed, cache_layout=False):
    """q (B, Hq, D) and k, v (B, Hkv, S, D); with ``cache_layout`` the
    model's (B, S, Hkv, D) cache seen through ``permute`` (no copy)."""
    b, hq, hkv, s, d = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def r(*dims):
        return torch.randn(dims, generator=gen, device=device).to(dtype)

    q = r(b, hq, d)
    if cache_layout:
        return q, r(b, s, hkv, d).permute(0, 2, 1, 3), r(b, s, hkv, d).permute(
            0, 2, 1, 3)
    return q, r(b, hkv, s, d), r(b, hkv, s, d)


def _ragged(b, s, device, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(1, s + 1, (b,), generator=gen).to(torch.int32).to(
        device)


# kernel 7's wgmma instances (bfloat16, D in {64, 128}) beyond
# ``FA_FWD_TIMED``'s rows: ragged Sq and Skv across the 128-row work items
# and the 64- or 128-key tiles, GQA 3:1 and 4:1, a one-row query block
# (B, Sq, Skv, Hq, Hkv, D, causal)
FA_WGMMA_RAGGED = ((2, 77, 300, 6, 2, 64, True), (2, 77, 300, 6, 2, 128, False),
                   (1, 129, 257, 3, 1, 64, False), (2, 65, 130, 8, 2, 128, True),
                   (3, 1, 40, 4, 2, 128, True), (1, 300, 300, 2, 2, 128, True))


def check_wgmma_forward(device):
    """Kernel 7's wgmma instances against ``flash_attention_plain`` at every
    row of ``FA_FWD_TIMED`` and ``FA_WGMMA_RAGGED``, both instances (with
    and without the lse store): the output within ``LM_TOL`` and, per row,
    ``FA_ROW_TOL``; the lse within ``FA_FWD_LSE_TOL``; the two instances'
    outputs equal, and a second call equal bit for bit (no atomics); one
    call one device kernel, ``flash_attention_wgmma``.  NaN in two query
    rows gives the plain version's NaN rows.  A planted fault, V's last
    ``FA_FAULT_ROWS`` keys taken from the rows before them (a kernel that
    read the wrong tile there), is caught per row at the prefill and
    whisper's encoder.  Launches made here are not counted.  Returns the
    largest absolute error of the output."""
    from repro_torch.kernels import flash_attention as fa

    saved = fa.flash_attention.launches
    tol, dtype = FA_ROW_TOL[torch.bfloat16], torch.bfloat16
    cases = [(label, tuple(shape[:7])) for label, shape in
             FA_FWD_TIMED.items()] + [(f"ragged {shape}", shape)
                                      for shape in FA_WGMMA_RAGGED]
    worst = 0.0
    for label, (b, sq, skv, hq, hkv, d, causal) in cases:
        q, k, v = (t.to(dtype) for t in _qkv((b, sq, skv, hq, hkv, d),
                                             device, SEED + 30))
        want, want_lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                                  return_lse=True)
        out = fa.flash_attention(q, k, v, causal=causal)
        out_lse, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        again = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        rss = attention_rss(q, k, v, want, torch.zeros_like(q), want_lse,
                            causal)[0]
        err = float((out.float() - want.float()).abs().max())
        row = row_rel_err(out, want, rss)
        lse_err = float((lse - want_lse).abs().max())
        names = device_kernels(lambda: fa.flash_attention(q, k, v,
                                                          causal=causal))
        print(f"flash_attention wgmma {label} (B, Sq, Skv, Hq, Hkv, D)="
              f"{(b, sq, skv, hq, hkv, d)} causal={causal} bf16: max_abs_err="
              f"{err} (LM_TOL {LM_TOL[dtype]}) per row {row} (FA_ROW_TOL "
              f"{tol}) lse {lse_err} (FA_FWD_LSE_TOL {FA_FWD_LSE_TOL}); "
              f"lse instance equal {torch.equal(out, out_lse)}, second call "
              f"equal {torch.equal(out, again)}; device kernels {names}")
        assert err <= LM_TOL[dtype] and row <= tol, (label, err, row)
        assert lse_err <= FA_FWD_LSE_TOL, (label, lse_err)
        assert torch.equal(out, out_lse) and torch.equal(out, again), label
        assert len(names) == 1 and "flash_attention_wgmma" in names[0], names
        worst = max(worst, err)
        if label in ("prefill", "whisper_encoder"):
            bad = fa.flash_attention(q, k, shifted_tile(v), causal=causal)
            bad_row = row_rel_err(bad, want, rss)
            print(f"planted fault {label}: V's last {FA_FAULT_ROWS} keys "
                  f"shifted, the kernel's output per row {bad_row} "
                  f"(FA_ROW_TOL {tol}: caught {bad_row > tol})")
            assert bad_row > tol, (label, bad_row)
        del q, k, v, want, want_lse, out, out_lse, lse, again, rss
    for shape in ((2, 100, 130, 4, 2, 128), (2, 300, 300, 2, 2, 64)):
        for causal in (False, True):
            q, k, v = (t.to(dtype) for t in _qkv(shape, device, 5))
            q[0, 5, 1, 3] = float("nan")
            q[1, -1, 0, 0] = float("nan")
            out = fa.flash_attention(q, k, v, causal=causal)
            want = fa.flash_attention_plain(q, k, v, causal=causal)
            assert torch.equal(torch.isnan(out), torch.isnan(want)), shape
            assert int(torch.isnan(out).sum()) == 2 * shape[-1], shape
    print("flash_attention wgmma: NaN in two query rows gives the plain "
          "version's NaN rows, and only those")
    fa.flash_attention.launches = saved
    torch.cuda.empty_cache()
    return worst


def phase_lm_kernels(device):
    """Kernel 8 against its plain version (sweep x kv_len in {1, 17, full,
    ragged (B,)} x {float32, bfloat16}, a strided (B, S, Hkv, D) cache
    view, OLMo-1B's and granite-8b's 32k-token caches in bfloat16; every
    GQA group of ``DECODE_GROUPS``; a float8_e4m3fn cache with bfloat16
    and float32 q at the sweep, the groups and granite's 32k cache;
    granite-8b's and dbrx-132b's decode shapes with a bfloat16 and a
    float8 cache at ragged lengths 512-543; all 256 float8 codes
    converted exactly), and kernel 7 in bfloat16 at the sweep shapes and
    OLMo-1B's prefill.  Returns {kernel: {case kind:
    max_abs_err}}."""
    from repro_torch.kernels import ops

    errs = {"decode_attention": {}, "flash_attention": {}}

    def check(key, label, got, want, dtype, kind=None):
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == dtype
        assert bool(torch.isfinite(got.float()).all())
        err = float((got.float() - want.float()).abs().max())
        print(f"{key} vs plain {label} {str(dtype)[6:]}: max_abs_err={err} "
              f"(tolerance {LM_TOL[dtype]})")
        torch.testing.assert_close(got, want, rtol=LM_TOL[dtype],
                                   atol=LM_TOL[dtype])
        kind = kind or str(dtype)[6:]
        errs[key][kind] = max(errs[key].get(kind, 0.0), err)

    b, hkv, s, d = DECODE_GROUP_SHAPE
    cases = [(shape, dtype, n, False, cache) for shape in DECODE_SWEEP
             for dtype in (torch.float32, torch.bfloat16)
             for n in (1, 17, shape[3], "ragged") for cache in (None, E4M3)]
    cases += [((8, 16, 16, SERVE_PROMPT + SERVE_GEN, 128), torch.bfloat16,
               SERVE_PROMPT + 9, True, None)]
    cases += [(shape, torch.bfloat16, n, False, None) for shape in DECODE_LONG
              for n in (shape[3], "ragged")]
    cases += [(DECODE_LONG[1], torch.bfloat16, "ragged", True, E4M3)]
    cases += [(DECODE_TIMED[label][0], torch.bfloat16, "near", True, cache)
              for label in ("granite_path", "dbrx_decode")
              for cache in (None, E4M3)]
    cases += [((b, g * hkv, hkv, s, d), dtype, "ragged", True, cache)
              for g in DECODE_GROUPS for dtype in (torch.float32,
                                                   torch.bfloat16)
              for cache in (None, E4M3)]
    for shape, dtype, n, view, cache in cases:
        q, k, v = _decode_case(shape, dtype, device, sum(shape), view)
        if cache:
            k, v = k.to(getattr(torch, cache)), v.to(getattr(torch, cache))
        if n == "ragged":
            n = _ragged(shape[0], shape[3], device, sum(shape))
        elif n == "near":               # a decode step's lengths, ragged
            n = shape[3] - _ragged(shape[0], SERVE_GEN, device, sum(shape))
        got = ops.decode_attention(q, k, v, n, mode="cuda")
        want = ops.decode_attention(q, k, v, n, mode="plain")
        label = (f"(B, Hq, Hkv, S, D)={shape} kv_len="
                 f"{n.tolist() if torch.is_tensor(n) else n}"
                 f"{' (B, S, Hkv, D) cache view' if view else ''}"
                 f"{' ' + cache + ' cache' if cache else ''}")
        check("decode_attention", label, got, want, dtype,
              f"{str(dtype)[6:]} q, {cache} cache" if cache else None)
        del q, k, v
    # every float8 code as the one visible V row: the output is its value
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8).view(
        torch.float8_e4m3fn).reshape(2, 1, 1, 128).to(device)
    v = torch.zeros((2, 1, 64, 128), dtype=torch.float8_e4m3fn, device=device)
    v[:, :, :1] = codes
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((2, 4, 128), dtype=dtype, device=device)
        got = ops.decode_attention(q, torch.zeros_like(v), v, 1, mode="cuda")
        want = codes.reshape(2, 1, 128).float().expand(2, 4, 128)
        torch.testing.assert_close(got.float(), want, rtol=0, atol=0,
                                   equal_nan=True)
        print(f"decode_attention float8_e4m3fn codes 0..255 with "
              f"{str(dtype)[6:]} q: every value exact (NaN at 0x7f, 0xff)")
    for shape in FA_SHAPES + (FA_LM_PREFILL,):
        for causal in ((True,) if shape == FA_LM_PREFILL else (False, True)):
            q, k, v = (t.to(torch.bfloat16)
                       for t in _qkv(shape, device, sum(shape)))
            got = ops.flash_attention(q, k, v, causal=causal, mode="cuda")
            want = ops.flash_attention(q, k, v, causal=causal, mode="plain")
            check("flash_attention", f"(B, Sq, Skv, Hq, Hkv, D)={shape} "
                  f"causal={causal}", got, want, torch.bfloat16)
    errs["flash_attention"]["bfloat16"] = max(
        errs["flash_attention"]["bfloat16"], check_wgmma_forward(device))
    torch.cuda.empty_cache()
    return errs


class _PlainSpy:
    """Counts calls of the plain attention and scan versions while in
    place."""

    def __init__(self):
        from repro_torch.kernels import decode_attention as da
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import mamba_scan as ms

        self.calls = 0
        self._saved = [(fa, "flash_attention_plain"),
                       (fa, "flash_attention_bwd_plain"),
                       (da, "decode_attention_plain"),
                       (ms, "mamba_scan_plain"),
                       (ms, "mamba_scan_bwd_plain")]
        self._fns = [getattr(m, a) for m, a in self._saved]

    def __enter__(self):
        for (m, a), fn in zip(self._saved, self._fns):
            def spy(*args, _fn=fn, **kwargs):
                self.calls += 1
                return _fn(*args, **kwargs)
            setattr(m, a, spy)
        return self

    def __exit__(self, *exc):
        for (m, a), fn in zip(self._saved, self._fns):
            setattr(m, a, fn)


def phase_lm_serve(device):
    """``repro_torch.launch.serve.main`` at full OLMo-1B width and depth on
    the card: every wave routed and served, one launch of kernel 7 per
    layer per wave, one of kernel 8 per layer per decode step, one of
    kernel 3 per daemon batch (and the daemon's warm-up pass), no plain
    attention call.  Then wave 0 again through the plain versions, on the
    same weights and prompts."""
    from repro_torch.launch import serve

    with _PlainSpy() as spy:
        zero_counts()                                  # the path starts here
        res = serve.main(SERVE_ARGS)
        counts = read_counts()                         # ... and ends here
    cfg, m = res.cfg, res.daemon.metrics
    layers, steps = cfg.num_layers, SERVE_GEN - 1
    assert (cfg.name, layers, cfg.d_model, cfg.num_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.padded_vocab) == OLMO_1B, cfg
    n_params = sum(t.numel() for t in _leaves(res.params))
    # param_count() counts two norms a layer, which OLMo's non-parametric
    # LayerNorm does not have
    assert n_params == cfg.param_count() - 2 * layers * cfg.d_model, (
        n_params, cfg.param_count())
    assert counts["decode_attention"] == layers * steps * SERVE_WAVES, counts
    assert counts["flash_attention"] == layers * SERVE_WAVES, counts
    assert m.device_launches == m.batches > 0, m
    assert counts["sdqn_score_cols"] == m.batches + 1, (counts, m)  # + warm-up
    others = {k: v for k, v in counts.items() if k not in (
        "decode_attention", "flash_attention", "sdqn_score_cols")}
    assert not any(others.values()), counts
    assert spy.calls == 0, spy.calls
    assert len(res.assignments) == len(res.waves) == SERVE_WAVES
    assert all(0 <= a < 4 for a in res.assignments), res.assignments
    assert int(res.counts.sum()) == SERVE_WAVES, res.counts
    assert m.bound == SERVE_WAVES and m.dropped == 0, m
    for w in res.waves:
        assert w.tokens.shape == (8, SERVE_GEN)
        assert bool(((w.tokens >= 0) & (w.tokens < cfg.padded_vocab)).all())
        assert bool(torch.isfinite(w.prefill_logits).all())
    prefill_ms = 1e3 * sum(w.prefill_s for w in res.waves) / SERVE_WAVES
    step_ms = 1e3 * sum(w.decode_s for w in res.waves) / (SERVE_WAVES * steps)
    print(f"LM serve olmo-1b (params={n_params}, bf16) waves={SERVE_WAVES} "
          f"x 8 requests, prompt {SERVE_PROMPT}, {SERVE_GEN} tokens: "
          f"tok_per_s={res.generated / res.seconds} seconds={res.seconds} "
          f"prefill_ms_per_wave={prefill_ms} decode_ms_per_step={step_ms} "
          f"(8 tokens a step) replicas={res.counts.tolist()} "
          f"daemon_batches={m.batches} counts={counts} plain_calls=0")

    for w, r in enumerate(res.waves):
        print(f"LM wave {w}: prefill_ms={1e3 * r.prefill_s} decode_ms_per_step="
              f"{1e3 * r.decode_s / steps}")

    # wave 0 again: bf16 through the plain versions; and both ways in
    # float32 (the same weights cast up), where kernel and plain differ by
    # their float32 sums alone
    wave = res.waves[0]
    plain = serve.serve_wave(res.params, cfg, wave.prompts, SERVE_GEN,
                             attn_mode="plain")
    p32 = _cast(res.params, torch.float32)
    c32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                              cache_dtype="float32")
    k32 = serve.serve_wave(p32, c32, wave.prompts, SERVE_GEN)
    f32 = serve.serve_wave(p32, c32, wave.prompts, SERVE_GEN,
                           attn_mode="plain")
    del p32
    torch.cuda.empty_cache()
    dev_plain = _max_diff(plain.prefill_logits, f32.prefill_logits)
    dev_kernel = _max_diff(wave.prefill_logits, f32.prefill_logits)
    err = _max_diff(wave.prefill_logits, plain.prefill_logits)
    tol_bf16 = LOGIT_TOL + dev_plain
    err32 = _max_diff(k32.prefill_logits, f32.prefill_logits)
    same, pairs = _tokens_agree(wave, plain, tol_bf16)
    same32, pairs32 = _tokens_agree(k32, f32, F32_LOGIT_TOL)
    print(f"LM wave 0 kernels vs plain, bf16: prefill logits max_abs_err={err} "
          f"(tolerance {tol_bf16} = {LOGIT_TOL} + the plain run's own bf16 "
          f"deviation {dev_plain} from float32; the kernel run's is "
          f"{dev_kernel}); tokens identical={same} over {pairs} of "
          f"{8 * SERVE_GEN} (row, step) pairs before each row's first top-2 "
          f"gap <= {2 * tol_bf16}")
    print(f"LM wave 0 kernels vs plain, float32: prefill logits max_abs_err="
          f"{err32} (tolerance {F32_LOGIT_TOL}); tokens identical={same32} "
          f"over {pairs32} of {8 * SERVE_GEN} (row, step) pairs before each "
          f"row's first top-2 gap <= {2 * F32_LOGIT_TOL}")
    assert err <= tol_bf16 and dev_kernel <= tol_bf16, (err, dev_kernel)
    assert err32 <= F32_LOGIT_TOL, err32
    assert same and same32
    return counts, res


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _tokens_agree(run, other, tol):
    """Rows are independent: each row's greedy tokens must agree up to its
    first step whose two best logits (``other``'s) lie within 2 * tol.
    Returns (agree, (row, step) pairs compared)."""
    pairs, same = 0, True
    for row in range(run.tokens.shape[0]):
        near = (other.top2_gap[row] <= 2 * tol).nonzero()
        upto = int(near[0]) if len(near) else run.tokens.shape[1]
        same &= bool(torch.equal(run.tokens[row, :upto],
                                 other.tokens[row, :upto]))
        pairs += upto
    return same, pairs


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def device_split_us(fn, calls: int = 10) -> dict:
    """{device kernel: microseconds a call} of ``fn`` under torch.profiler
    over ``calls`` calls, the device's own events only (empty when the
    profiler delivers none, as it now and then does on the card's
    machine).  Launches made here are restored by the caller."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / calls
            for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU
            and e.self_device_time_total > 0}


def _library_attention(q, k, v, mask=None, causal=False):
    """``scaled_dot_product_attention`` on (B, H, S, D) tensors, GQA on,
    and the name of the device kernel that did the most of it."""
    from torch.profiler import ProfilerActivity, profile

    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = dict(attn_mask=mask, is_causal=causal,
              enable_gqa=q.shape[1] != k.shape[1])
    call = lambda: sdpa(q, k, v, **kw)     # noqa: E731
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type != torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    top = max(dev, key=lambda e: e.self_device_time_total).key if dev else "?"
    return call, top


def time_decode_row(label, device, name):
    """Kernel 8 at ``DECODE_TIMED[label]`` on the model's (B, S, Hkv, D)
    cache seen through ``permute``, bfloat16 q: held to the plain version
    on these inputs (``LM_TOL``); device time from a CUDA graph, warm (the
    graph replays one cache) and with the L2 cold (``cold_time_ms``), the
    plain version's likewise, the bound from these inputs (the cache's
    own itemsize), ``scaled_dot_product_attention`` with a kv_len mask on
    the same tensors (``library_ms``, a CUDA graph likewise; a float8
    cache it does not take: null, and SDPA on the cache cast to bfloat16
    beside it) and the launch plan that ran."""
    from repro_torch.kernels import decode_attention as da

    shape, n, cache, iters = DECODE_TIMED[label]
    b, hq, hkv, s, d = shape
    q, k, v = _decode_case(shape, torch.bfloat16, device, SEED + 21,
                           cache_layout=True)
    k, v = k.to(getattr(torch, cache)), v.to(getattr(torch, cache))
    got = da.decode_attention(q, k, v, n)
    want = da.decode_attention_plain(q, k, v, n)
    err = _max_diff(got, want)
    print(f"decode_attention vs plain at the timed row {label}: "
          f"max_abs_err={err} (tolerance {LM_TOL[torch.bfloat16]})")
    assert bool(torch.isfinite(got.float()).all()), label
    torch.testing.assert_close(got, want, rtol=LM_TOL[torch.bfloat16],
                               atol=LM_TOL[torch.bfloat16])
    del got, want
    ms = graph_time_ms(lambda: da.decode_attention(q, k, v, n), iters)
    cold_ms = cold_time_ms(lambda: da.decode_attention(q, k, v, n), iters)
    call_ms = cuda_time_ms(lambda: da.decode_attention(q, k, v, n), iters)
    plain_ms = graph_time_ms(lambda: da.decode_attention_plain(q, k, v, n),
                             3, reps=3)
    mask = (torch.arange(s, device=device) < n)[None, None, None, :]
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    lib, backend = _library_attention(q[:, :, None], kb, vb, mask=mask)
    sdpa_ms = graph_time_ms(lib, iters)
    lib_err = float((lib()[:, :, 0].float() - da.decode_attention(
        q, k, v, n).float()).abs().max())
    b_ms, b_by, nbytes, n_ops, terms = attention_bound(
        b, hq, hkv, 1, n, d, n, 2, name, cache_itemsize=k.element_size())
    cap = da.capacity(device, q.dtype, k.dtype, d)
    p = da.plan(b, hq, hkv, s, n, cap)
    plan = dict(chunks=p.chunks, splits=p.splits, span=p.span,
                blocks=p.blocks, clusters=list(cap.clusters))
    row = dict(ms=ms, cold_ms=cold_ms, max_abs_err=err, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by,
               library_ms=sdpa_ms if cache == "bfloat16" else None,
               shape=list(shape), kv_len=n, cache=cache,
               library_kernel=backend, bound_terms_ms=terms, plan=plan,
               path=label)
    if cache != "bfloat16":
        row["sdpa_on_bf16_cache_ms"] = sdpa_ms
    print(f"timing decode_attention {label} (B, Hq, Hkv, S, D)={shape} "
          f"kv_len={n} bf16 q, {cache} (B, S, Hkv, D) cache view: "
          f"kernel_ms={ms} plain_ms={plain_ms} (device time, CUDA graph) "
          f"kernel_cold_ms={cold_ms} (L2 cold) "
          f"kernel_call_ms={call_ms} sdpa_ms={sdpa_ms} (SDPA with a kv_len "
          f"mask{'' if cache == 'bfloat16' else ' on the cache cast to bf16'}"
          f", CUDA graph; kernel {backend[:90]}; max_abs_diff {lib_err}) "
          f"bound_ms={b_ms} ({b_by}; bytes={nbytes} ops={n_ops}, "
          f"{peaks(name)[0]} peaks; terms_ms {terms}) kernel/bound="
          f"{ms / b_ms} plan={plan}")
    return row


def parent_decode_times(src):
    """{row: {"ms", "cold_ms"}} of another checkout's kernel 8 at
    ``DECODE_TIMED`` (``scripts/decode_timings.py --src src`` in a process
    of its own)."""
    out = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                              "decode_timings.py"),
                          "--src", str(src), "--label", "parent"],
                         capture_output=True, text=True, check=True).stdout
    rows = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    for r in rows:
        print(f"timing decode_attention {r['row']} of the parent ({src}): "
              f"kernel_ms={r['ms']} kernel_cold_ms={r['cold_ms']} "
              f"{r.get('error', '')}".rstrip())
    return {r["row"]: r for r in rows}


def parent_bwd_times(src):
    """{kernel: {row: {"ms"}}} of another checkout's kernel 7 forward at
    ``FA_FWD_TIMED`` and its backwards, kernel 7's at ``FA_BWD_TIMED`` and
    kernel 6's at ``SCAN_BWD_TIMED`` (rows keyed by the shape's ``str``),
    from ``scripts/bwd_timings.py --src src`` in a process of its own."""
    out = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                              "bwd_timings.py"),
                          "--src", str(src), "--label", "parent"],
                         capture_output=True, text=True, check=True).stdout
    rows = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    times = {"flash_attention": {}, "flash_attention_bwd": {},
             "mamba_scan_bwd": {}}
    for r in rows:
        print(f"timing {r['kernel']} {r['row']} of the parent ({src}): "
              f"kernel_ms={r['ms']} device kernels us a call (profiler) "
              f"{r['kernels_us']}")
        times[r["kernel"]][r["row"]] = r
    return times


PHASE14_DECODE = ("path", "olmo_32k", "granite_32k", "granite_32k_e4m3",
                  "granite_path", "granite_path_e4m3")


def phase_lm_timings(device, name):
    """Kernel 8 at the LM path's rows (``PHASE14_DECODE``, as
    ``time_decode_row``) and kernel 7 at the prefill shape: device time
    from a CUDA graph, the plain versions' likewise, the bound from these
    inputs, and ``scaled_dot_product_attention`` on the same tensors
    (``library_ms``, a CUDA graph likewise; the backend's kernel
    recorded)."""
    from repro_torch.kernels import flash_attention as fa

    saved = read_counts()
    rows = {label: time_decode_row(label, device, name)
            for label in PHASE14_DECODE}
    b, sq, skv, hq, hkv, d = FA_LM_PREFILL
    q, k, v = (t.to(torch.bfloat16) for t in _qkv(FA_LM_PREFILL, device,
                                                   SEED + 22))
    ms = graph_time_ms(lambda: fa.flash_attention(q, k, v, causal=True), 20)
    call_ms = cuda_time_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                           20)
    plain_ms = graph_time_ms(lambda: fa.flash_attention_plain(
        q, k, v, causal=True), 3, reps=3)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib, backend = _library_attention(qt, kt, vt, causal=True)
    library_ms = graph_time_ms(lib, 20)
    lib_err = float((lib().transpose(1, 2).float() - fa.flash_attention(
        q, k, v, causal=True).float()).abs().max())
    b_ms, b_by, nbytes, n_ops, terms = attention_bound(
        b, hq, hkv, sq, skv, d, causal_pairs(sq, skv), 2, name)
    rows["prefill"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=library_ms,
                           shape=list(FA_LM_PREFILL), library_kernel=backend,
                           bound_terms_ms=terms)
    print(f"timing flash_attention LM prefill (B, Sq, Skv, Hq, Hkv, D)="
          f"{FA_LM_PREFILL} bf16 causal: kernel_ms={ms} plain_ms={plain_ms} "
          f"(device time, CUDA graph) kernel_call_ms={call_ms} "
          f"library_ms={library_ms} (SDPA, CUDA graph; kernel {backend[:90]}; "
          f"max_abs_diff {lib_err}) bound_ms={b_ms} ({b_by}; bytes={nbytes} "
          f"ops={n_ops}, {peaks(name)[0]} peaks; terms_ms {terms}) "
          f"kernel/bound={ms / b_ms}")
    for key, fn in wrappers().items():          # timing launches don't count
        fn.launches = saved[key]
    return rows


def phase_lm_breakdown(device, res):
    """Where a decode step goes at the serving path's shape (8 requests,
    position 512 + i of OLMo-1B): ``_decode_profile`` over
    ``DECODE_PROFILE_STEPS`` steps."""
    _decode_profile("olmo-1b", res.params, res.cfg, res.waves[0].prompts,
                    steps=DECODE_PROFILE_STEPS, top=12)


# ---------------------------------------------------------------------------
# phase 20: the moe, ssm, hybrid and audio LM families (kernels 6, 7, 8)
# ---------------------------------------------------------------------------

# falcon-mamba-7b and qwen2-moe-a2.7b through serve.main, full width and
# depth: 4 replicas, 16 requests in waves of 8, prompts of 512, 32 tokens
FAMILY_WAVES, FAMILY_BATCH = 2, 8
FAMILY_SERVE_ARGS = ["--replicas", "4",
                     "--requests", str(FAMILY_WAVES * FAMILY_BATCH),
                     "--wave-size", str(FAMILY_BATCH),
                     "--prompt-len", str(SERVE_PROMPT),
                     "--gen-tokens", str(SERVE_GEN), "--seed", str(SEED)]
# whisper-medium through serve_wave: prompts of 384 plus 32 generated, in
# its published 448-token decoder context, against 1,500 encoder frames
WHISPER_PROMPT = 384
# dbrx-132b at full width, its 40 layers cut to 4 (one card holds ~31 GB
# of it; the whole model ~264 GB)
DBRX_LAYERS = 4
FAMILY_PROFILE_STEPS = 4
# the published widths each run asserts: falcon-mamba-7b (layers,
# d_model, d_inner, state), qwen2-moe-a2.7b (layers, d_model, experts,
# top-k), whisper-medium (decoder and encoder layers, d_model, heads, head
# width, frames)
FALCON_WIDTHS = (64, 4096, 8192, 16)
QWEN_WIDTHS = (24, 2048, 60, 4)
WHISPER_WIDTHS = (24, 24, 1024, 16, 64, 1500)
# kernel 6 at falcon-mamba-7b's prefill; kernels 7 and 8 at the new
# paths' shapes: (B, Sq, Skv, Hq, Hkv, D, causal) and (B, Hq, Hkv, S, D,
# kv_len)
SCAN_FALCON = (8, 512, 8192, 16)
FA_FAMILIES = {"whisper_encoder": (8, 1500, 1500, 16, 16, 64, False),
               "whisper_cross": (8, 384, 1500, 16, 16, 64, False),
               "whisper_self": (8, 384, 384, 16, 16, 64, True),
               "qwen_prefill": (8, 512, 512, 16, 16, 128, True),
               "dbrx_prefill": (8, 512, 512, 48, 8, 128, True)}
DA_FAMILIES = {"whisper_self": (8, 16, 16, 416, 64, 415),
               "whisper_cross": (8, 16, 16, 1500, 64, 1500),
               "qwen_decode": (8, 16, 16, 544, 128, 543),
               "dbrx_decode": (8, 48, 8, 544, 128, 543)}
FA_FAMILY_TIMED = ("whisper_encoder", "whisper_cross", "dbrx_prefill")
# kernel 7's bfloat16 forward at every row the phases time it (14: the
# prefill; 22: training's forward with the lse; 23: ``train_4k``; the
# family timings): (B, Sq, Skv, Hq, Hkv, D, causal, lse).  With
# ``--parent-src`` the parent's forward is timed at each row before and
# after (``scripts/bwd_timings.py``, inputs ``_qkv(shape, device, SEED +
# 29)``).
FA_FWD_TIMED = {"prefill": (8, 512, 512, 16, 16, 128, True, False),
                "forward_lse": (8, 512, 512, 16, 16, 128, True, True),
                "train_4k": (1, 4096, 4096, 16, 16, 128, True, True),
                "whisper_encoder": (8, 1500, 1500, 16, 16, 64, False, False),
                "whisper_cross": (8, 384, 1500, 16, 16, 64, False, False),
                "dbrx_prefill": (8, 512, 512, 48, 8, 128, True, False)}
DA_FAMILY_TIMED = ("whisper_cross", "dbrx_decode")


class _DispatchSpy:
    """Keeps the routing of every MoE prefill dispatch (T > 1 tokens a
    row) while in place, to count what the capacity dropped afterwards;
    adds no device operation to the run."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.fn, self.calls = moe, moe.dispatch_rows, []

    def __enter__(self):
        def spy(idx, num_experts, cap):
            if idx.shape[1] > 1:
                self.calls.append((idx, num_experts, cap))
            return self.fn(idx, num_experts, cap)
        self.moe.dispatch_rows = spy
        return self

    def __exit__(self, *exc):
        self.moe.dispatch_rows = self.fn

    def summary(self):
        """(assignments dropped, rows whose last expert overflowed, i.e.
        where the reference's last-slot rule wiped a kept token, rows),
        over every recorded dispatch."""
        dropped = fired = rows = 0
        for idx, e, cap in self.calls:
            r, t, k = idx.shape
            counts = torch.zeros((r, e), dtype=torch.int64, device=idx.device)
            counts.scatter_add_(1, idx.reshape(r, t * k),
                                torch.ones_like(idx.reshape(r, t * k)))
            dropped += int((counts - cap).clamp(min=0).sum())
            fired += int((counts[:, e - 1] > cap).sum())
            rows += r
        return dropped, fired, rows


def _family_figures(label, waves, generated, seconds):
    """Print and return tok/s (``generated`` tokens in ``seconds``),
    prefill ms per wave and decode ms per step of a run's waves."""
    steps = len(waves) * (waves[0].tokens.shape[1] - 1)
    fig = dict(tok_per_s=generated / seconds,
               prefill_ms_per_wave=1e3 * sum(w.prefill_s for w in waves)
               / len(waves),
               decode_ms_per_step=1e3 * sum(w.decode_s for w in waves)
               / steps, seconds=seconds)
    print(f"LM family {label}: waves={len(waves)} x {waves[0].tokens.shape[0]}"
          f" requests, prompt {waves[0].prompts.shape[1]}, "
          f"{waves[0].tokens.shape[1]} tokens: tok_per_s={fig['tok_per_s']} "
          f"seconds={seconds} prefill_ms_per_wave={fig['prefill_ms_per_wave']}"
          f" decode_ms_per_step={fig['decode_ms_per_step']}")
    return fig


def _check_waves(waves, cfg, gen):
    for w in waves:
        assert w.tokens.shape == (FAMILY_BATCH, gen), w.tokens.shape
        assert bool(((w.tokens >= 0) & (w.tokens < cfg.padded_vocab)).all())
        assert bool(torch.isfinite(w.prefill_logits).all())


def _to_float32(tree):
    """Cast every leaf of ``tree`` to float32 in place, one leaf at a time,
    so that the bfloat16 weights are freed as their float32 copies are
    made (qwen2-moe's 57 GB in float32 and its 28.6 GB in bfloat16 would
    not fit together)."""
    for key, val in tree.items():
        if isinstance(val, dict):
            _to_float32(val)
        else:
            tree[key] = val.to(torch.float32)


def _family_hold(label, params, cfg, wave, extra=None):
    """Wave 0 again, same prompts, as phase 13 holds OLMo-1B: in bf16
    through the plain versions (attention and scan); then, the weights
    cast to float32 IN PLACE (``params`` is float32 afterwards), through
    the kernels and through the plain versions.  In float32 the two differ
    by the order of float32 sums alone: prefill logits within
    ``F32_LOGIT_TOL``, the exact check.  In bf16 a rounding that goes the
    other way in one of them carries through every layer, and through a
    MoE router to another expert: each run lies some distance from the
    float32 run, and the kernel run's can be the larger, since kernel 7
    rounds its probabilities to bf16 as the reference's LM path does and
    the plain version keeps them in float32.  So in bf16 the two are held
    to each other within LOGIT_TOL plus the larger of the two runs' own
    bf16 deviations.  Tokens identical up to each row's first near tie."""
    from repro_torch.launch import serve

    gen = wave.tokens.shape[1]
    with _PlainSpy() as spy:
        plain = serve.serve_wave(params, cfg, wave.prompts, gen,
                                 attn_mode="plain", extra=extra)
    assert spy.calls > 0, label
    _to_float32(params)
    torch.cuda.empty_cache()
    c32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32",
                              cache_dtype="float32")
    k32 = serve.serve_wave(params, c32, wave.prompts, gen, extra=extra)
    f32 = serve.serve_wave(params, c32, wave.prompts, gen, attn_mode="plain",
                           extra=extra)
    dev_plain = _max_diff(plain.prefill_logits, f32.prefill_logits)
    dev_kernel = _max_diff(wave.prefill_logits, f32.prefill_logits)
    err = _max_diff(wave.prefill_logits, plain.prefill_logits)
    tol_bf16 = LOGIT_TOL + max(dev_plain, dev_kernel)
    err32 = _max_diff(k32.prefill_logits, f32.prefill_logits)
    same, pairs = _tokens_agree(wave, plain, tol_bf16)
    same32, pairs32 = _tokens_agree(k32, f32, F32_LOGIT_TOL)
    print(f"LM family {label} wave 0 kernels vs plain, bf16: prefill logits "
          f"max_abs_err={err} (tolerance {tol_bf16} = {LOGIT_TOL} + the "
          f"larger of the runs' own bf16 deviations from float32: plain "
          f"{dev_plain}, kernels {dev_kernel}); tokens identical={same} over "
          f"{pairs} of {wave.tokens.numel()} (row, step) pairs before each "
          f"row's first top-2 gap <= {2 * tol_bf16}")
    print(f"LM family {label} wave 0 kernels vs plain, float32: prefill "
          f"logits max_abs_err={err32} (tolerance {F32_LOGIT_TOL}); tokens "
          f"identical={same32} over {pairs32} of {wave.tokens.numel()} (row, "
          f"step) pairs before each row's first top-2 gap <= "
          f"{2 * F32_LOGIT_TOL}")
    assert err <= tol_bf16, (label, err, tol_bf16)
    assert err32 <= F32_LOGIT_TOL, (label, err32)
    assert same and same32, label
    return dict(plain_logit_err=err, bf16_dev_plain=dev_plain,
                bf16_dev_kernel=dev_kernel, f32_logit_err=err32,
                f32_pairs=pairs32)


def _decode_profile(label, params, cfg, prompts, extra=None,
                    steps=FAMILY_PROFILE_STEPS, top=6):
    """Where a decode step of ``cfg`` goes at the serving shape, two warm
    steps after the prompt: host ms per step (synchronized, unprofiled),
    and under torch.profiler the device's busy share, kernel 8's and the
    matrix products' shares of device time, device operations per step
    and the ``top`` largest device kernels."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve
    from repro_torch.models import model as mdl

    b, plen = prompts.shape
    with torch.no_grad():
        logits, pcache = mdl.prefill(params, cfg, prompts, extra or {})
        cache = serve.decode_cache(cfg, pcache, b, plen, 2 * steps + 2,
                                   prompts.device)
        del pcache
        tok = torch.argmax(logits, -1)[:, None]
        for i in range(2):                               # warm
            logits, cache = mdl.decode_step(params, cfg, tok, cache, plen + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            logits, cache = mdl.decode_step(params, cfg, tok, cache,
                                            plen + 2 + i)
            tok = torch.argmax(logits, -1)[:, None]
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                logits, cache = mdl.decode_step(params, cfg, tok, cache,
                                                plen + 2 + steps + i)
                tok = torch.argmax(logits, -1)[:, None]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    dev = {e.key: (e.self_device_time_total, e.count)
           for e in prof.key_averages()
           if e.device_type != torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0}
    total = sum(t for t, _ in dev.values())
    assert total > 0, "the profiler saw no device time"
    n_ops = sum(c for _, c in dev.values()) / steps
    k8 = sum(t for key, (t, _) in dev.items() if "decode_attention" in key)
    mm_words = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitk")
    mm = sum(t for key, (t, _) in dev.items()
             if any(w in key.lower() for w in mm_words))
    busy = total / 1e6
    print(f"LM decode step breakdown ({label}, B={b}, position ~{plen}): "
          f"host_ms_per_step={host_ms} (synchronized, unprofiled) profiled "
          f"wall_ms_per_step={1e3 * wall / steps} device_busy_ms_per_step="
          f"{1e3 * busy / steps} device_busy_share={busy / wall} "
          f"kernel8_share_of_device={k8 / total} matmul_share_of_device="
          f"{mm / total} device_ops_per_step={n_ops}")
    for key in sorted(dev, key=lambda x: dev[x][0], reverse=True)[:top]:
        t, c = dev[key]
        print(f"LM decode device time ({label}) {key[:100]}: per_step_us="
              f"{t / steps} calls_per_step={c / steps}")
    return dict(host_ms_per_step=host_ms, device_ops_per_step=n_ops,
                device_busy_share=busy / wall)


def _free(*names):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"LM family freed {', '.join(names)}: "
          f"allocated_gb={torch.cuda.memory_allocated() / 1e9}")


def _served_counts(label, counts, want):
    """The run's launches of kernels 6-8 equal ``want``; every other
    kernel's but kernel 3's (wave routing) are zero."""
    got = {k: counts[k] for k in want}
    print(f"LM family {label} launches: {counts}")
    assert got == want, (label, got, want)
    others = {k: v for k, v in counts.items()
              if k not in want and k != "sdqn_score_cols"}
    assert not any(others.values()), (label, counts)


def _serve_family(arch, device, spy=None):
    """``serve.main`` for ``arch`` with ``FAMILY_SERVE_ARGS``: counts
    zeroed just before and read just after, no plain call."""
    from repro_torch.launch import serve

    with _PlainSpy() as plain, (spy or contextlib.nullcontext()):
        zero_counts()                                  # the path starts here
        res = serve.main(["--arch", arch] + FAMILY_SERVE_ARGS)
        counts = read_counts()                         # ... and ends here
    assert plain.calls == 0, (arch, plain.calls)
    m = res.daemon.metrics
    assert counts["sdqn_score_cols"] == m.batches + 1, (counts, m)
    assert len(res.waves) == FAMILY_WAVES and m.bound == FAMILY_WAVES, m
    n_params = sum(t.numel() for t in _leaves(res.params))
    print(f"LM family {arch}: params={n_params} (param_count() "
          f"{res.cfg.param_count()}), bf16, full width and depth "
          f"({res.cfg.num_layers} layers, d_model {res.cfg.d_model}); "
          f"replicas={res.counts.tolist()} daemon_batches={m.batches}")
    return res, counts, n_params


def _waves_through(params, cfg, device, waves, plen, extra_fn=None):
    """``waves`` waves of FAMILY_BATCH prompts through ``serve_wave``, the
    counts zeroed just before and read just after."""
    from repro_torch.launch import serve

    out = []
    with _PlainSpy() as plain:
        zero_counts()                                  # the path starts here
        t0 = time.perf_counter()
        for w in range(waves):
            prompts = serve.sample_requests(
                serve.seed_generator(SEED, 100 + w, device), FAMILY_BATCH,
                cfg.vocab_size, plen)
            out.append(serve.serve_wave(params, cfg, prompts, SERVE_GEN,
                                        extra=extra_fn(w) if extra_fn
                                        else None))
        seconds = time.perf_counter() - t0
        counts = read_counts()                         # ... and ends here
    assert plain.calls == 0, plain.calls
    return out, counts, seconds


def phase_lm_families(device):
    """Phase 20: falcon-mamba-7b and qwen2-moe-a2.7b through ``serve.main``,
    whisper-medium through ``serve_wave`` with its frames, all three at
    full width and depth; dbrx-132b at full width and 4 layers; jamba at
    its smoke widths; each wave 0 again through the plain versions, every
    model freed before the next.  Returns ({kernel: {path: launches}},
    figures per model)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as mdl

    t_phase = time.perf_counter()
    paths = {"mamba_scan": {}, "flash_attention": {}, "decode_attention": {}}
    figures = {}
    steps = SERVE_GEN - 1

    # falcon-mamba-7b: one kernel-6 launch a layer a wave, none in decode,
    # no attention
    res, counts, n_params = _serve_family("falcon-mamba-7b", device)
    cfg = res.cfg
    assert (cfg.num_layers, cfg.d_model, cfg.d_inner,
            cfg.ssm_state) == FALCON_WIDTHS, cfg
    _served_counts("falcon-mamba-7b", counts, {
        "mamba_scan": cfg.num_layers * FAMILY_WAVES,
        "flash_attention": 0, "decode_attention": 0})
    paths["mamba_scan"]["falcon-mamba-7b prefill"] = counts["mamba_scan"]
    _check_waves(res.waves, cfg, SERVE_GEN)
    fig = _family_figures("falcon-mamba-7b", res.waves, res.generated,
                          res.seconds)
    fig.update(_decode_profile("falcon-mamba-7b", res.params, cfg,
                               res.waves[0].prompts))
    fig.update(_family_hold("falcon-mamba-7b", res.params, cfg, res.waves[0]))
    figures["falcon-mamba-7b"] = dict(fig, params=n_params)
    del res
    _free("falcon-mamba-7b")

    # qwen2-moe-a2.7b: kernel 7 a layer a wave, kernel 8 a layer a step;
    # what the capacity dropped in each prefill
    dspy = _DispatchSpy()
    res, counts, n_params = _serve_family("qwen2-moe-a2.7b", device, dspy)
    cfg = res.cfg
    assert (cfg.num_layers, cfg.d_model, cfg.moe_num_experts,
            cfg.moe_top_k) == QWEN_WIDTHS, cfg
    _served_counts("qwen2-moe-a2.7b", counts, {
        "mamba_scan": 0, "flash_attention": cfg.num_layers * FAMILY_WAVES,
        "decode_attention": cfg.num_layers * steps * FAMILY_WAVES})
    paths["flash_attention"]["qwen2-moe-a2.7b prefill"] = counts[
        "flash_attention"]
    paths["decode_attention"]["qwen2-moe-a2.7b decode"] = counts[
        "decode_attention"]
    dropped, fired, rows = dspy.summary()
    cap = dspy.calls[0][2]
    assert len(dspy.calls) == cfg.num_layers * FAMILY_WAVES, len(dspy.calls)
    print(f"LM family qwen2-moe-a2.7b MoE prefill dispatch: "
          f"{len(dspy.calls)} dispatches of {FAMILY_BATCH} rows x 512 tokens "
          f"x top-{cfg.moe_top_k}, capacity {cap} a row per expert: "
          f"assignments dropped={dropped} of "
          f"{rows * 512 * cfg.moe_top_k}; rows whose last expert overflowed "
          f"(the last-slot rule wiped a kept token)={fired} of {rows}")
    _check_waves(res.waves, cfg, SERVE_GEN)
    fig = _family_figures("qwen2-moe-a2.7b", res.waves, res.generated,
                          res.seconds)
    fig.update(_decode_profile("qwen2-moe-a2.7b", res.params, cfg,
                               res.waves[0].prompts))
    fig.update(_family_hold("qwen2-moe-a2.7b", res.params, cfg, res.waves[0]))
    figures["qwen2-moe-a2.7b"] = dict(
        fig, params=n_params, moe_dropped=dropped, moe_last_slot_rows=fired,
        moe_rows=rows, capacity=cap)
    del res
    _free("qwen2-moe-a2.7b")

    # whisper-medium: kernel 7 for the encoder, the decoder's
    # self-attention and its cross-attention; kernel 8 for both in decode
    cfg = get_config("whisper-medium")
    assert (cfg.num_layers, cfg.enc_layers, cfg.d_model, cfg.num_heads,
            cfg.resolved_head_dim, cfg.enc_seq) == WHISPER_WIDTHS, cfg
    params = mdl.init_params(serve.seed_generator(SEED, 0, device), cfg,
                             device)
    n_params = sum(t.numel() for t in _leaves(params))

    def frames(w):
        gen = serve.seed_generator(SEED, 200 + w, device)
        return {"frames": (0.02 * torch.randn(
            (FAMILY_BATCH, cfg.enc_seq, cfg.d_model), generator=gen,
            device=device)).to(torch.bfloat16)}

    waves, counts, seconds = _waves_through(params, cfg, device, FAMILY_WAVES,
                                            WHISPER_PROMPT, frames)
    # a wave: kernel 7 once an encoder layer, once a decoder layer's self-
    # and once its cross-attention (72); kernel 8 twice a decoder layer a
    # step (48)
    _served_counts("whisper-medium", counts, {
        "mamba_scan": 0,
        "flash_attention": (cfg.enc_layers + 2 * cfg.num_layers)
        * FAMILY_WAVES,
        "decode_attention": 2 * cfg.num_layers * steps * FAMILY_WAVES})
    paths["flash_attention"]["whisper-medium encoder, self and cross "
                             "prefill"] = counts["flash_attention"]
    paths["decode_attention"]["whisper-medium self and cross decode"] = (
        counts["decode_attention"])
    _check_waves(waves, cfg, SERVE_GEN)
    print(f"LM family whisper-medium: params={n_params} (param_count() "
          f"{cfg.param_count()}), bf16, full width and depth")
    fig = _family_figures("whisper-medium", waves,
                          FAMILY_WAVES * FAMILY_BATCH * SERVE_GEN, seconds)
    fig.update(_decode_profile("whisper-medium", params, cfg,
                               waves[0].prompts, frames(0)))
    fig.update(_family_hold("whisper-medium", params, cfg, waves[0],
                            frames(0)))
    figures["whisper-medium"] = dict(fig, params=n_params)
    del params, waves
    _free("whisper-medium")

    # dbrx-132b: full width, 4 of its 40 layers (a cut: ~264 GB whole)
    cfg = dataclasses.replace(get_config("dbrx-132b"), num_layers=DBRX_LAYERS)
    print(f"LM family dbrx-132b CUT to {DBRX_LAYERS} of 40 layers at full "
          f"width (d_model {cfg.d_model}, 48 / 8 heads of 128, 16 experts of "
          f"{cfg.moe_d_ff}, top-{cfg.moe_top_k}): the whole model does not "
          f"fit on one card")
    params = mdl.init_params(serve.seed_generator(SEED, 0, device), cfg,
                             device)
    n_params = sum(t.numel() for t in _leaves(params))
    waves, counts, seconds = _waves_through(params, cfg, device, 1,
                                            SERVE_PROMPT)
    _served_counts("dbrx-132b (4 layers)", counts, {
        "mamba_scan": 0, "flash_attention": DBRX_LAYERS,
        "decode_attention": DBRX_LAYERS * steps})
    paths["flash_attention"]["dbrx-132b (4 layers) prefill"] = counts[
        "flash_attention"]
    paths["decode_attention"]["dbrx-132b (4 layers) decode"] = counts[
        "decode_attention"]
    _check_waves(waves, cfg, SERVE_GEN)
    fig = _family_figures("dbrx-132b (4 layers)", waves,
                          FAMILY_BATCH * SERVE_GEN, seconds)
    fig.update(_decode_profile("dbrx-132b (4 layers)", params, cfg,
                               waves[0].prompts))
    fig.update(_family_hold("dbrx-132b (4 layers)", params, cfg, waves[0]))
    figures["dbrx-132b (4 layers)"] = dict(fig, params=n_params)
    del params, waves
    _free("dbrx-132b")

    # jamba at its smoke widths: kernels 6, 7 and 8 in one hybrid block
    cfg = get_config("jamba-1.5-large-398b", smoke=True)
    spec, nb = mdl.block_spec(cfg), mdl.num_blocks(cfg)
    n_attn = nb * sum(s.mixer == "attn" for s in spec)
    n_mamba = nb * sum(s.mixer == "mamba" for s in spec)
    params = mdl.init_params(serve.seed_generator(SEED, 0, device), cfg,
                             device)
    waves, counts, seconds = _waves_through(params, cfg, device, 1,
                                            SERVE_PROMPT)
    _served_counts("jamba-1.5-large-398b (smoke)", counts, {
        "mamba_scan": n_mamba, "flash_attention": n_attn,
        "decode_attention": n_attn * steps})
    paths["mamba_scan"]["jamba (smoke widths) prefill"] = counts["mamba_scan"]
    paths["flash_attention"]["jamba (smoke widths) prefill"] = counts[
        "flash_attention"]
    paths["decode_attention"]["jamba (smoke widths) decode"] = counts[
        "decode_attention"]
    _check_waves(waves, cfg, SERVE_GEN)
    fig = _family_figures("jamba-1.5-large-398b (smoke)", waves,
                          FAMILY_BATCH * SERVE_GEN, seconds)
    fig.update(_family_hold("jamba-1.5-large-398b (smoke)", params, cfg,
                            waves[0]))
    figures["jamba-1.5-large-398b (smoke)"] = fig
    del params, waves
    _free("jamba")
    print(f"phase 20 seconds={time.perf_counter() - t_phase}")
    return paths, figures


def phase_family_kernels(device):
    """Kernels 6, 7 and 8 against their plain versions at phase 20's new
    shapes: {kernel: max_abs_err}."""
    from repro_torch.kernels import ops

    errs = {}

    def check(key, label, got, want, tol):
        torch.cuda.synchronize()
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert bool(torch.isfinite(g.float()).all())
            err = float((g.float() - w.float()).abs().max())
            print(f"{key} vs plain {label}: max_abs_err={err} "
                  f"(tolerance {tol})")
            torch.testing.assert_close(g, w, rtol=tol, atol=tol)
            errs[key] = max(errs.get(key, 0.0), err)

    args = _scan_args(SCAN_FALCON, device, SEED + 31)
    check("mamba_scan", f"(B, S, di, N)={SCAN_FALCON} float32",
          ops.mamba_scan(*args, mode="cuda"),
          ops.mamba_scan(*args, mode="plain"), SCAN_TOL)
    del args
    for label, (b, sq, skv, hq, hkv, d, causal) in FA_FAMILIES.items():
        q, k, v = (t.to(torch.bfloat16) for t in _qkv(
            (b, sq, skv, hq, hkv, d), device, SEED + sq + hq))
        check("flash_attention", f"{label} (B, Sq, Skv, Hq, Hkv, D)="
              f"{(b, sq, skv, hq, hkv, d)} causal={causal} bf16",
              ops.flash_attention(q, k, v, causal=causal, mode="cuda"),
              ops.flash_attention(q, k, v, causal=causal, mode="plain"),
              LM_TOL[torch.bfloat16])
    for label, (b, hq, hkv, s, d, n) in DA_FAMILIES.items():
        q, k, v = _decode_case((b, hq, hkv, s, d), torch.bfloat16, device,
                               SEED + s + hq, cache_layout=True)
        check("decode_attention", f"{label} (B, Hq, Hkv, S, D)="
              f"{(b, hq, hkv, s, d)} kv_len={n} bf16 (B, S, Hkv, D) cache view",
              ops.decode_attention(q, k, v, n, mode="cuda"),
              ops.decode_attention(q, k, v, n, mode="plain"),
              LM_TOL[torch.bfloat16])
    torch.cuda.empty_cache()
    return errs


def phase_family_timings(device, name):
    """Kernel 6 at falcon-mamba-7b's prefill, kernel 7 at whisper's encoder
    and cross shapes and dbrx's GQA prefill, kernel 8 at whisper's cross
    cache and dbrx's GQA decode: device time from a CUDA graph, the plain
    versions' likewise, the bound from these inputs, and SDPA on the same
    tensors for the attention kernels (``library_ms``)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms

    saved = read_counts()
    rows = {"mamba_scan": [], "flash_attention": [], "decode_attention": []}
    args = _scan_args(SCAN_FALCON, device, SEED + 32)
    ms_ms = graph_time_ms(lambda: ms.mamba_scan(*args), 20)
    plain_ms = graph_time_ms(lambda: ms.mamba_scan_plain(*args), 1, reps=2)
    b_ms, b_by, nbytes, n_ops = scan_bound(SCAN_FALCON, name)
    terms = scan_bound_terms(SCAN_FALCON, name)
    plan = ms.scan_plan(SCAN_FALCON[0], SCAN_FALCON[2], SCAN_FALCON[3])
    rows["mamba_scan"].append(dict(
        ms=ms_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, shape=list(SCAN_FALCON), bound_terms_ms=terms,
        plan=dataclasses.asdict(plan), path="falcon-mamba-7b prefill"))
    print(f"timing mamba_scan falcon-mamba-7b prefill (B, S, di, N)="
          f"{SCAN_FALCON}: kernel_ms={ms_ms} plain_ms={plain_ms} (device "
          f"time, CUDA graph) bound_ms={b_ms} ({b_by}; bytes={nbytes} "
          f"ops={n_ops}; terms_ms {terms}) kernel/bound={ms_ms / b_ms} "
          f"plan: {plan} blocks={plan.blocks}")
    del args
    for label in FA_FAMILY_TIMED:
        b, sq, skv, hq, hkv, d, causal = FA_FAMILIES[label]
        q, k, v = (t.to(torch.bfloat16) for t in _qkv(
            (b, sq, skv, hq, hkv, d), device, SEED + 33))
        ms_ = graph_time_ms(lambda: fa.flash_attention(q, k, v,
                                                       causal=causal), 20)
        plain_ms = graph_time_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=causal), 2, reps=2)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib, backend = _library_attention(qt, kt, vt, causal=causal)
        library_ms = graph_time_ms(lib, 20)
        pairs = causal_pairs(sq, skv) if causal else sq * skv
        b_ms, b_by, nbytes, n_ops, terms = attention_bound(
            b, hq, hkv, sq, skv, d, pairs, 2, name)
        rows["flash_attention"].append(dict(
            ms=ms_, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms, shape=[b, sq, skv, hq, hkv, d],
            causal=causal, library_kernel=backend, bound_terms_ms=terms,
            path=label))
        print(f"timing flash_attention {label} (B, Sq, Skv, Hq, Hkv, D)="
              f"{(b, sq, skv, hq, hkv, d)} bf16 causal={causal}: "
              f"kernel_ms={ms_} plain_ms={plain_ms} (device time, CUDA "
              f"graph) library_ms={library_ms} (SDPA, CUDA graph; kernel "
              f"{backend[:90]}) bound_ms={b_ms} ({b_by}; bytes={nbytes} "
              f"ops={n_ops}; terms_ms {terms}) kernel/bound={ms_ / b_ms}")
        del q, k, v, qt, kt, vt
    for label in DA_FAMILY_TIMED:
        rows["decode_attention"].append(time_decode_row(label, device, name))
    for key, fn in wrappers().items():          # timing launches don't count
        fn.launches = saved[key]
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 21: granite-8b, kernel 8's 4:1 GQA path, with a bf16 and an e4m3 cache
# ---------------------------------------------------------------------------

# granite-8b at its published widths and depth through serve.main: 4
# replicas, one wave of 8 prompts of 512 tokens, 32 generated
GRANITE_ARGS = ["--arch", "granite-8b", "--replicas", "4", "--requests",
                str(FAMILY_BATCH), "--wave-size", str(FAMILY_BATCH),
                "--prompt-len", str(SERVE_PROMPT), "--gen-tokens",
                str(SERVE_GEN), "--seed", str(SEED)]
# (layers, d_model, heads, KV heads, head width, d_ff)
GRANITE_WIDTHS = (36, 4096, 32, 8, 128, 14336)


def _decode_step_pair(params, cfg, prompts, token):
    """Logits of one decode step after ``prompts`` (position P, kv_len P +
    1), through kernel 8 and through its plain version, each from its own
    copy of one prefill cache (made by the kernels), so the two differ in
    the decode step's attention alone.  Counts kernel 8's launches in the
    kernel step."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch import serve
    from repro_torch.models import model as mdl

    b, plen = prompts.shape
    with torch.no_grad():
        _, pcache = mdl.prefill(params, cfg, prompts)
        cache = serve.decode_cache(cfg, pcache, b, plen, 1, prompts.device)
        del pcache
        out = {}
        for mode in ("cuda", "plain"):
            copy = {name: {leaf: x.clone() for leaf, x in sub.items()}
                    for name, sub in cache.items()}
            before = da.decode_attention.launches
            out[mode], _ = mdl.decode_step(params, cfg, token, copy, plen,
                                           attn_mode=mode)
            out[f"{mode}_launches"] = da.decode_attention.launches - before
            del copy
    return out


def phase_lm_granite(device):
    """Phase 21: granite-8b (random bf16 weights from seed 0) through
    ``serve.main`` with its bfloat16 cache, then the same weights and
    prompts through ``serve_wave`` with ``cache_dtype="float8_e4m3fn"``
    (set with ``dataclasses.replace``: ``serve.main`` has no flag, as the
    reference's has none).  Each: exactly one kernel-7 launch a layer and
    one kernel-8 launch a layer a decode step, no plain call, a profiled
    decode step.  Then the float8 wave again through the plain versions
    (prefill logits, which kernel 7 computes, and tokens identical up to
    the first near tie), the bfloat16 wave as phase 20 holds its models
    (``_family_hold``: plain in bf16, kernels and plain in float32), and
    the step that reads the float8 cache, one decode step from one prefill
    cache through kernel 8 and through plain (``_decode_step_pair``): in
    bfloat16 within the hold's tolerance, in float32 (the weights the hold
    cast) within ``F32_LOGIT_TOL``.  Returns ({kernel: {path: launches}},
    figures)."""
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    steps = SERVE_GEN - 1
    with _PlainSpy() as plain:
        zero_counts()                                  # the path starts here
        res = serve.main(GRANITE_ARGS)
        counts = read_counts()                         # ... and ends here
    assert plain.calls == 0, plain.calls
    cfg, params, wave = res.cfg, res.params, res.waves[0]
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff) == GRANITE_WIDTHS, cfg
    n_params = sum(t.numel() for t in _leaves(params))
    m = res.daemon.metrics
    # one wave asks for 100% of a replica's CPU (serve.main's job is
    # 100 / waves %), which no replica has free: the daemon drops it and
    # serve.main serves it all the same, as the reference's does
    assert counts["sdqn_score_cols"] == m.batches + 1, (counts, m)
    assert m.bound + m.dropped == 1 and len(res.waves) == 1, m
    _served_counts("granite-8b", counts, {
        "mamba_scan": 0, "flash_attention": cfg.num_layers,
        "decode_attention": cfg.num_layers * steps})
    _check_waves(res.waves, cfg, SERVE_GEN)
    print(f"LM granite-8b: params={n_params} (param_count() "
          f"{cfg.param_count()}), bf16, full width and depth")
    figures = {"granite-8b": dict(
        _family_figures("granite-8b", res.waves, res.generated, res.seconds),
        params=n_params)}
    figures["granite-8b"].update(_decode_profile("granite-8b", params, cfg,
                                                 wave.prompts))
    paths = {"flash_attention": {"granite-8b prefill":
                                 counts["flash_attention"]},
             "decode_attention": {"granite-8b decode, bf16 cache":
                                  counts["decode_attention"]}}

    c8 = dataclasses.replace(cfg, cache_dtype=E4M3)
    # the float8 path's first calls load its kernels: a short wave first,
    # so that the timed one starts warm as the bf16 one did
    serve.serve_wave(params, c8, wave.prompts[:1], 2)
    with _PlainSpy() as plain:
        zero_counts()                                  # the path starts here
        t0 = time.perf_counter()
        w8 = serve.serve_wave(params, c8, wave.prompts, SERVE_GEN)
        seconds = time.perf_counter() - t0
        counts = read_counts()                         # ... and ends here
    assert plain.calls == 0, plain.calls
    _served_counts("granite-8b e4m3 cache", counts, {
        "mamba_scan": 0, "flash_attention": cfg.num_layers,
        "decode_attention": cfg.num_layers * steps})
    assert counts["sdqn_score_cols"] == 0, counts
    _check_waves([w8], cfg, SERVE_GEN)
    paths["flash_attention"]["granite-8b prefill, e4m3 run"] = counts[
        "flash_attention"]
    paths["decode_attention"]["granite-8b decode, e4m3 cache"] = counts[
        "decode_attention"]
    fig8 = _family_figures("granite-8b e4m3 cache", [w8],
                           FAMILY_BATCH * SERVE_GEN, seconds)
    fig8.update(_decode_profile("granite-8b e4m3 cache", params, c8,
                                wave.prompts))
    with _PlainSpy() as spy:
        p8 = serve.serve_wave(params, c8, wave.prompts, SERVE_GEN,
                              attn_mode="plain")
    assert spy.calls > 0
    same_bf16 = int((w8.tokens == wave.tokens).sum())
    # the decode step that reads the float8 cache, with bf16 q (the path's
    # instance) now and with float32 q on the weights the hold casts
    token = w8.tokens[:, :1]
    pairs = {"bfloat16": _decode_step_pair(params, c8, wave.prompts, token)}
    hold = _family_hold("granite-8b", params, cfg, wave)
    tol = LOGIT_TOL + max(hold["bf16_dev_plain"], hold["bf16_dev_kernel"])
    err8 = _max_diff(w8.prefill_logits, p8.prefill_logits)
    same8, pairs8 = _tokens_agree(w8, p8, tol)
    print(f"LM granite-8b e4m3 cache, kernels vs plain: prefill logits "
          f"max_abs_err={err8} (tolerance {tol}, the bf16 hold's); tokens "
          f"identical={same8} over {pairs8} of {w8.tokens.numel()} (row, "
          f"step) pairs before each row's first top-2 gap <= {2 * tol}; "
          f"tokens equal to the bf16 cache's run: {same_bf16} of "
          f"{w8.tokens.numel()}")
    assert err8 <= tol and same8, (err8, tol, same8)
    del p8
    pairs["float32"] = _decode_step_pair(params, dataclasses.replace(
        c8, dtype="float32", param_dtype="float32"), wave.prompts, token)
    step_errs = {}
    for key, pair in pairs.items():
        assert pair["cuda_launches"] == cfg.num_layers, pair["cuda_launches"]
        assert pair["plain_launches"] == 0, pair["plain_launches"]
        assert bool(torch.isfinite(pair["cuda"]).all())
        step_errs[key] = _max_diff(pair["cuda"], pair["plain"])
        limit = tol if key == "bfloat16" else F32_LOGIT_TOL
        print(f"LM granite-8b e4m3 cache, one decode step (kv_len "
              f"{SERVE_PROMPT + 1}) from one prefill cache, kernel 8 vs "
              f"plain, {key}: logits max_abs_err={step_errs[key]} "
              f"(tolerance {limit})")
        assert step_errs[key] <= limit, (key, step_errs[key], limit)
    del pairs
    figures["granite-8b"].update(hold)
    figures["granite-8b e4m3 cache"] = dict(
        fig8, plain_logit_err=err8, tokens_equal_to_bf16_cache=same_bf16,
        pairs_compared=pairs8, decode_step_logit_err=step_errs)
    del res, params, wave, w8
    _free("granite-8b")
    print(f"phase 21 seconds={time.perf_counter() - t_phase}")
    return paths, figures


# ---------------------------------------------------------------------------
# the paper's main path: the DQN learner (kernels 7 and 1) and Tables 8-10
# ---------------------------------------------------------------------------

LEARNER_SEEDS = 2            # the cut train_seeds: the SDQN preset's E, B
LEARNER_EPISODES = 2
ATTN_LEARNER = dict(seeds=2, envs=4, episodes=1, pods=25)
FLEET_LEARNER = dict(n=MAIN_N, envs=2, pods=3)
STEP_TIMING_EPISODES = 3     # at the SDQN preset's (S, E, batch): 1 warm
PAPER_CUT = dict(episodes=20, seeds=2, trials=5)


class ActionSpy:
    """Records every selection of ``module.masked_argmax`` (the learner's,
    ``train_rl``, by default; ``schedulers`` for episode selectors): the
    actions and whether a greedy row's two best feasible Q values lie
    within ``tie`` (the tolerance of the kernel that scored them)."""

    def __init__(self, tie=ATOL, module="train_rl"):
        self.tie, self.module = tie, module

    def _mod(self):
        import importlib

        return importlib.import_module(f"repro_torch.core.{self.module}")

    def __enter__(self):
        mod = self._mod()
        self.actions, self.near, self.gaps = [], [], []
        self._orig = orig = mod.masked_argmax

        def spy(gen, scores, ok, epsilon=0.0, *, u=None, noise=None):
            a = orig(gen, scores, ok, epsilon, u=u, noise=noise)
            masked = torch.where(ok, scores,
                                 torch.full_like(scores, -torch.inf))
            top = torch.topk(masked, min(2, scores.shape[-1]), dim=-1).values
            greedy = torch.isfinite(top[..., -1])
            if u is not None:
                greedy &= u >= epsilon
            gap = (top[..., 0] - top[..., -1])[greedy]
            self.near.append(bool((gap <= self.tie).any()))
            self.gaps.append(float(gap.min()) if gap.numel() else None)
            self.actions.append(a.cpu())
            return a

        mod.masked_argmax = spy
        return self

    def __exit__(self, *exc):
        self._mod().masked_argmax = self._orig


def _param_diff(a, b) -> float:
    from repro_torch.optim import tree_leaves

    return max(float((x.cpu() - y.cpu()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def compare_learner_runs(first, second, p1, p2, label):
    """Two learner runs on the same draws: identical actions up to the
    first pod step where either run had a near tie; with none, params
    within 1e-5.  Returns the params' max difference (None after a tie)."""
    steps = len(first.actions)
    assert steps == len(second.actions) > 0, label
    tie = next((i for i in range(steps)
                if first.near[i] or second.near[i]), None)
    for i in range(steps if tie is None else tie):
        assert torch.equal(first.actions[i], second.actions[i]), (
            f"{label}: pod step {i} differs before any near tie")
    same = all(torch.equal(a, b) for a, b in zip(first.actions,
                                                 second.actions))
    diff = None
    if tie is None:
        diff = _param_diff(p1, p2)
        assert diff <= 1e-5, (label, diff)
    print(f"{label}: pod_steps={steps} actions_identical={same} "
          f"first_near_tie_step={tie} params_max_abs_diff={diff}")
    return diff


def profile_steps(run, steps, label):
    """torch.profiler over ``run()`` (``steps`` pod steps): device
    operations per step and the device's busy share; "not measured" when
    the profiler delivers no device event."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return profile_report(prof, wall, steps, label)


def profile_report(prof, wall, steps, label, top=8):
    """Device operations per step, the busy share of ``wall`` seconds and
    the ``top`` device operations of a finished profile of ``steps``
    steps; None when the profiler delivered no device event."""
    dev = {e.key: (e.self_device_time_total, e.count)
           for e in prof.key_averages()
           if e.device_type != torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0}
    if not dev:
        print(f"{label} profile: device ops and busy share not measured "
              f"(the profiler delivered no device event)")
        return None
    busy = sum(t for t, _ in dev.values()) / 1e6
    n_ops = sum(c for _, c in dev.values())
    print(f"{label} profile: profiled_wall_ms_per_step={1e3 * wall / steps} "
          f"device_busy_ms_per_step={1e3 * busy / steps} "
          f"device_busy_share={busy / wall} "
          f"device_ops_per_step={n_ops / steps}")
    for key in sorted(dev, key=lambda x: dev[x][0], reverse=True)[:top]:
        t, c = dev[key]
        print(f"{label} device time {key[:100]}: per_step_us={t / steps} "
              f"calls_per_step={c / steps} share={t / 1e6 / busy}")
    return n_ops / steps


def phase_learner(device):
    """The DQN learner on the card (``train.engine.train_seeds``,
    ``core.train_rl``), every draw made on the CPU (so that a seed with no
    near tie stays one) and replayed from ``ArrayDraws``:

    * the SDQN preset (E = 16, batch 256) cut to 2 seeds x 2 episodes on
      ``training_cluster()``, on the card and on the CPU port: identical
      actions up to the first near tie, then params within 1e-5;
    * ``policy="attention"`` on the card through kernel 7 and through
      ``fused="plain"``: the same, and exactly 2 kernel-7 launches a pod
      step (the select and the bootstrap score all S·E sets in one each);
    * the MLP at ``fleet_cluster(5000)``, E = 2, a few pod steps, through
      kernel 1 and through ``fused="plain"``: exactly 2·E launches a pod
      step (kernel 1 scores one cluster a launch);
    * kernels 7 and 1 against their plain versions at the learner's
      shapes (not counted);
    * ms per pod step at the SDQN preset's (S = 10, E = 16, batch 256),
      synchronized, after one warm episode; device operations per step and
      the busy share under torch.profiler.

    Returns ({kernel: launches on the learner path}, {kernel: max abs
    error at the learner's shapes})."""
    from repro_torch.core import presets, train_rl
    from repro_torch.core import env as kenv
    from repro_torch.core.draws import (ArrayDraws, TorchDraws,
                                        record_train_draws)
    from repro_torch.core.schedulers import score_states
    from repro_torch.core.types import PodSpec, fleet_cluster, training_cluster
    from repro_torch.train import engine

    cpu = torch.device("cpu")
    cfg = training_cluster()
    launches, errs = {}, {}

    # the cut train_seeds, card against the CPU port
    rl = dataclasses.replace(presets.SDQN_PRESET, episodes=LEARNER_EPISODES)
    arrays = record_train_draws(
        TorchDraws(torch.Generator().manual_seed(SEED + 7),
                   (LEARNER_SEEDS, rl.n_envs)), cfg, rl, LEARNER_SEEDS, cpu)
    runs = []
    for dev in (device, cpu):
        with ActionSpy() as spy:
            t0 = time.perf_counter()
            params, metrics = engine.train_seeds(
                ArrayDraws(**arrays, device=dev), cfg, rl, LEARNER_SEEDS,
                device=dev)
            secs = time.perf_counter() - t0
        assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
        runs.append((spy, params))
        print(f"learner train_seeds on {dev.type}: seeds={LEARNER_SEEDS} "
              f"envs={rl.n_envs} batch={rl.batch_size} episodes={rl.episodes}"
              f" seconds={secs} avg_cpu={metrics['avg_cpu'].tolist()}")
    compare_learner_runs(runs[0][0], runs[1][0], runs[0][1], runs[1][1],
                         "learner card vs CPU port")

    # the attention class: kernel 7 against fused="plain"
    a = ATTN_LEARNER
    rl = train_rl.RLConfig(policy="attention", n_envs=a["envs"],
                           episodes=a["episodes"], pods_per_episode=a["pods"],
                           batch_size=64)
    arrays = record_train_draws(
        TorchDraws(torch.Generator().manual_seed(SEED + 10),
                   (a["seeds"], a["envs"])), cfg, rl, a["seeds"], cpu)
    runs = {}
    for fused in ("auto", "plain"):
        with ActionSpy(tie=FA_TOL) as spy:
            zero_counts()                           # the path starts here
            carry, _ = train_rl.train_carry(ArrayDraws(**arrays, device=device),
                                            cfg, rl, a["seeds"], device=device,
                                            fused=fused)
            counts = read_counts()                  # ... and ends here
        runs[fused] = (spy, carry.params)
        steps = rl.episodes * rl.pods_per_episode
        want = 2 * steps if fused == "auto" else 0
        assert counts["flash_attention"] == want == sum(counts.values()), (
            fused, counts)
        if fused == "auto":
            launches["flash_attention"] = counts["flash_attention"]
    print(f"attention learner: pod_steps={steps} sets_per_launch="
          f"{a['seeds'] * a['envs']} kernel7_launches="
          f"{launches['flash_attention']} (2 a pod step)")
    compare_learner_runs(runs["auto"][0], runs["plain"][0],
                         runs["auto"][1], runs["plain"][1],
                         "attention learner kernel 7 vs plain")

    # the MLP at 5,000 nodes: kernel 1 against fused="plain"
    f = FLEET_LEARNER
    fcfg = fleet_cluster(f["n"])
    rl = train_rl.RLConfig(n_envs=f["envs"], episodes=1,
                           pods_per_episode=f["pods"], batch_size=32)
    arrays = record_train_draws(
        TorchDraws(torch.Generator().manual_seed(SEED + 9),
                   (1, f["envs"])), fcfg, rl, 1, cpu)
    runs = {}
    for fused in ("auto", "plain"):
        with ActionSpy() as spy:
            zero_counts()                           # the path starts here
            carry, _ = train_rl.train_carry(ArrayDraws(**arrays, device=device),
                                            fcfg, rl, 1, device=device,
                                            fused=fused)
            counts = read_counts()                  # ... and ends here
        runs[fused] = (spy, carry.params)
        want = 2 * f["envs"] * f["pods"] if fused == "auto" else 0
        assert counts["sdqn_score_afterstate"] == want == sum(
            counts.values()), (fused, counts)
        if fused == "auto":
            launches["sdqn_score_afterstate"] = counts["sdqn_score_afterstate"]
    print(f"fleet learner N={f['n']} envs={f['envs']} pod_steps={f['pods']}: "
          f"kernel1_launches={launches['sdqn_score_afterstate']} "
          f"(2·E a pod step)")
    compare_learner_runs(runs["auto"][0], runs["plain"][0],
                         runs["auto"][1], runs["plain"][1],
                         "fleet learner kernel 1 vs plain")

    # kernels 7 and 1 against their plain versions at the learner's shapes
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    for name, c, batch, kernel in (("attention", cfg, (2, 16), "flash_attention"),
                                   ("mlp", fcfg, (1, 2), "sdqn_score_afterstate")):
        from repro_torch.core import policy

        spec = policy.get(name)
        params = TorchDraws(gen).init_params(spec, batch[0], device=device)
        state = kenv.reset(gen, c, device=device, batch=batch)
        pod = PodSpec(*(torch.full(batch, v, device=device)
                        for v in kenv.default_pod(c)))
        pol = None if name == "mlp" else spec
        got = score_states(params, state, pod, c, policy=pol)
        ref = score_states(params, state, pod, c, fused="plain", policy=pol)
        errs[kernel] = float((got - ref).abs().max())
        tol = FA_TOL if name == "attention" else ATOL
        assert errs[kernel] <= tol, (name, errs[kernel])
        print(f"learner-shape check {kernel} {tuple(batch)} x N={c.n_nodes}: "
              f"max_abs_err={errs[kernel]} (tolerance {tol})")

    # ms per pod step at the SDQN preset's shape
    rl = dataclasses.replace(presets.SDQN_PRESET,
                             episodes=STEP_TIMING_EPISODES)
    s = presets.N_SELECTION_SEEDS
    marks = []

    def mark(ep, carry):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    t0 = time.perf_counter()
    train_rl.train_carry(TorchDraws(torch.Generator(device=device).manual_seed(
        SEED + 11), (s, rl.n_envs)), cfg, rl, s, device=device,
        on_episode=mark)
    steps = (len(marks) - 1) * rl.pods_per_episode
    ms = 1e3 * (marks[-1] - marks[0]) / steps
    print(f"learner step SDQN preset (S={s}, E={rl.n_envs}, "
          f"batch={rl.batch_size}, N={cfg.n_nodes}): ms_per_pod_step={ms} "
          f"(synchronized, {steps} steps after a warm episode; first "
          f"episode {marks[0] - t0} s)")
    one = dataclasses.replace(rl, episodes=1)
    ops = profile_steps(lambda: train_rl.train_carry(
        TorchDraws(torch.Generator(device=device).manual_seed(SEED + 12),
                   (s, one.n_envs)), cfg, one, s, device=device),
        one.pods_per_episode, "learner step SDQN preset")
    return launches, errs, {"ms_per_pod_step": ms, "device_ops_per_step": ops}


def _load_paper_tables():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "paper_tables", ROOT / "scripts" / "paper_tables.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_paper_tables(device):
    """Tables 8-10 at a cut budget through ``scripts/paper_tables.py``'s
    functions (train SDQN and SDQN-n with the presets' widths, evaluate
    kube, SDQN and SDQN-n on 5 trials): every trial places or drops all 50
    pods, metrics finite; then the three schedulers on recorded trial
    draws, on the card and on the CPU port: identical experiment pods and
    metrics within 1e-5 relative; then SDQN's and SDQN-n's whole
    ``train_and_select`` on recorded draws, card against CPU port
    (``paired_train_and_select``)."""
    from repro_torch.core import schedulers
    from repro_torch.core.draws import (ArrayDraws, TorchDraws,
                                        record_trial_draws)
    from repro_torch.eval import engine as eval_engine
    from repro_torch.optim import tree_map

    pt = _load_paper_tables()
    t0 = time.perf_counter()
    out = pt.run(**PAPER_CUT, device=device)
    secs = time.perf_counter() - t0
    for name, tb in out["tables"].items():
        assert len(tb["metric"]) == PAPER_CUT["trials"], name
        assert all(np.isfinite(tb["metric"])), name
        for row, dropped in zip(tb["exp_pods"], tb["dropped"]):
            assert sum(row) + dropped == pt.N_PODS, (name, row, dropped)
    policies = out.pop("params")
    draws = TorchDraws(torch.Generator(device=device).manual_seed(
        pt.TRIAL_SEED + 1), (PAPER_CUT["trials"],))
    arrays = record_trial_draws(draws, pt.CFG, pt.N_PODS)
    for name in ("default", "sdqn", "sdqn_n"):
        res = []
        for dev in (device, torch.device("cpu")):
            if name == "default":
                select = schedulers.make_kube_selector(pt.CFG)
            else:
                select = schedulers.make_sdqn_selector(
                    tree_map(lambda x: x.to(dev), policies[name]), pt.CFG)
            res.append(eval_engine.make_batch_episode(
                pt.CFG, select, pt.N_PODS, device=dev)(
                    ArrayDraws(**arrays, device=dev)))
        card, host = res
        assert torch.equal(card.exp_pods.cpu(), host.exp_pods), name
        rel = float(((card.metric.cpu() - host.metric) / host.metric).abs().max())
        assert rel <= 1e-5, (name, rel)
        print(f"paper table {name} card vs CPU port on recorded trials: "
              f"exp_pods identical, metric max_rel_diff={rel}")
    print(f"paper tables (cut {PAPER_CUT}): seconds={secs} "
          + " ".join(f"{k}_mean={v['mean']}" for k, v in out["tables"].items())
          + " " + " ".join(f"{k}_train_s={v['seconds']}"
                           for k, v in out["train"].items()))
    for name in ("sdqn", "sdqn_n"):
        paired_train_and_select(device, pt, name)
    return out


class SelectSpy:
    """The per-candidate validation metrics ``train.engine.select_best``
    gets."""

    def __enter__(self):
        from repro_torch.train import engine

        self._orig = orig = engine.select_best

        def spy(stacked, metrics):
            self.metrics = metrics.detach().cpu().double()
            return orig(stacked, metrics)

        engine.select_best = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.train import engine

        engine.select_best = self._orig


def paired_train_and_select(device, pt, name):
    """The whole ``train_and_select`` of ``name`` at ``PAPER_CUT`` (the
    preset's widths, 12 validation bursts), on the card and on the CPU
    port, from training, validation and trial draws recorded from CPU
    ``TorchDraws``: learner actions identical up to the first near tie
    (two best feasible Q values within ``ATOL``); with none, the same
    selected seed, validation metrics within 1e-5 relative, and the
    Table 9/10 trials' experiment pods identical and metrics within 1e-5
    relative.  After a near tie, the step and its gap are printed."""
    from repro_torch.core import schedulers
    from repro_torch.core.draws import (ArrayDraws, TorchDraws,
                                        record_train_draws,
                                        record_trial_draws)
    from repro_torch.train import engine

    cpu = torch.device("cpu")
    rl = pt.preset(name, PAPER_CUT["episodes"])
    n_seeds = PAPER_CUT["seeds"]
    arrays = record_train_draws(TorchDraws(
        torch.Generator().manual_seed(SEED + 30 + pt.TRAIN_SEEDS[name]),
        (n_seeds, rl.n_envs)), pt.TCFG, rl, n_seeds, cpu)
    val = record_trial_draws(TorchDraws(torch.Generator().manual_seed(
        engine.VALIDATION_SEED), (12,)), pt.CFG, pt.N_PODS)
    trials = record_trial_draws(TorchDraws(torch.Generator().manual_seed(
        pt.TRIAL_SEED), (PAPER_CUT["trials"],)), pt.CFG, pt.N_PODS)
    runs = []
    for dev in (device, cpu):
        t0 = time.perf_counter()
        with ActionSpy() as spy, SelectSpy() as sel:
            params, metric = engine.train_and_select(
                ArrayDraws(**arrays, device=dev), pt.TCFG, pt.CFG, rl,
                n_seeds=n_seeds, val_trials=12,
                val_draws=ArrayDraws(**val, device=dev), device=dev)
        res = eval_trials(dev, pt, schedulers.make_sdqn_selector(params,
                                                                 pt.CFG),
                          trials)
        runs.append((spy, sel.metrics, metric, res,
                     time.perf_counter() - t0))
    (card, card_val, card_m, card_res, card_s), (host, host_val, host_m,
                                                 host_res, host_s) = runs
    steps = len(card.actions)
    assert steps == len(host.actions) == rl.episodes * rl.pods_per_episode
    tie = next((i for i in range(steps) if card.near[i] or host.near[i]),
               None)
    for i in range(steps if tie is None else tie):
        assert torch.equal(card.actions[i], host.actions[i]), (
            f"paired train_and_select {name}: pod step {i} differs before "
            f"any near tie")
    same = all(torch.equal(a, b) for a, b in zip(card.actions, host.actions))
    line = (f"paired train_and_select {name} card vs CPU port (cut "
            f"{PAPER_CUT}): pod_steps={steps} actions_identical={same} "
            f"first_near_tie_step={tie}")
    if tie is not None:
        gaps = [g for g in (card.gaps[tie], host.gaps[tie]) if g is not None]
        print(f"{line} gap={min(gaps)} (asserted up to that step) "
              f"card_s={card_s} cpu_s={host_s}")
        return
    val_rel = float(((card_val - host_val) / host_val).abs().max())
    assert int(torch.argmin(card_val)) == int(torch.argmin(host_val)), name
    assert val_rel <= 1e-5 and abs(card_m / host_m - 1.0) <= 1e-5, (
        name, val_rel, card_m, host_m)
    assert torch.equal(card_res.exp_pods.cpu(), host_res.exp_pods), name
    rel = float(((card_res.metric.cpu() - host_res.metric)
                 / host_res.metric).abs().max())
    assert rel <= 1e-5, (name, rel)
    print(f"{line} selected_seed={int(torch.argmin(card_val))} "
          f"val_metrics={card_val.tolist()} val_max_rel_diff={val_rel} "
          f"trials_exp_pods_identical=True trials_metric_max_rel_diff={rel} "
          f"trials_mean={float(card_res.metric.mean())} card_s={card_s} "
          f"cpu_s={host_s}")


def eval_trials(dev, pt, select, arrays):
    from repro_torch.core.draws import ArrayDraws
    from repro_torch.eval import engine as eval_engine

    return eval_engine.make_batch_episode(pt.CFG, select, pt.N_PODS,
                                          device=dev)(
        ArrayDraws(**arrays, device=dev))


# ---------------------------------------------------------------------------
# the paper's baselines (Tables 11/12, Figure 6, the policy-class table),
# the scenario sweep and SDQN-n's consolidation over time (kernels 7 and 1)
# ---------------------------------------------------------------------------

BASELINE_CUT = dict(episodes=3, seeds=2, trials=5)
CHAOS_NAMES = ("preemptible-flaky", "batch-flaky", "train-flaky")
SUPERVISED_RECORD = dict(episodes=2, pods_per_episode=25, n_envs=8)
SCENARIO_CUT = dict(episodes=6, trials=3, pareto_weights=(15.0,))
MIXTURE_CUT = dict(episodes=4, trials=3, scenario="short-job-burst")
COC = dict(name="cluster-of-clusters-4k", trials=2, pods=32)


class KubeSpy:
    """Records the kube selector's actions in ``train_rl`` (the supervised
    trainer's behaviour policy)."""

    def __enter__(self):
        from repro_torch.core import train_rl

        self.actions = []
        self._orig = orig = train_rl.make_kube_selector

        def make(cfg):
            select = orig(cfg)

            def spy(step, state, pod):
                a = select(step, state, pod)
                self.actions.append(a.cpu())
                return a

            return spy

        train_rl.make_kube_selector = make
        return self

    def __exit__(self, *exc):
        from repro_torch.core import train_rl

        train_rl.make_kube_selector = self._orig


def phase_baselines(device, tables):
    """Tables 11/12, Figure 6's claims (printed, not asserted at the cut
    budget), the literal ablation and the policy-class table through
    ``scripts/paper_tables.py``'s ``run_baselines`` at ``BASELINE_CUT``,
    on phase 16's Tables 8-10; kernel 7's launches in the attention arm of
    the policy-class table (the only kernel user there).  Then the
    supervised trainer on recorded draws, on the card and on the CPU port:
    identical kube actions, params within 1e-5.  Returns the kernel
    launches of the run."""
    from repro_torch.core import baselines, train_rl
    from repro_torch.core.draws import (ArrayDraws, TorchDraws,
                                        record_supervised_draws)

    pt = _load_paper_tables()
    t0 = time.perf_counter()
    zero_counts()                                   # the path starts here
    out = pt.run_baselines(**BASELINE_CUT, device=device, tables=tables)
    counts = read_counts()                          # ... and ends here
    secs = time.perf_counter() - t0
    for name in ("lstm", "transformer"):
        tb = out["tables"][name]
        assert len(tb["metric"]) == BASELINE_CUT["trials"], name
        assert all(np.isfinite(tb["metric"])), name
        for row, dropped in zip(tb["exp_pods"], tb["dropped"]):
            assert sum(row) + dropped == pt.N_PODS, (name, row, dropped)
    assert all(np.isfinite(r["mean"]) for r in out["policy_class"].values())
    assert counts["flash_attention"] > 0, counts
    others = {k: v for k, v in counts.items()
              if v and k != "flash_attention"}
    assert not others, others
    print(f"paper baselines (cut {BASELINE_CUT}): seconds={secs} "
          + " ".join(f"{k}_mean={out['tables'][k]['mean']}"
                     for k in ("lstm", "transformer"))
          + f" claims={out['claims']} literal_mean={out['literal']['mean']} "
          + " ".join(f"policy_class_{k}={v['mean']}"
                     for k, v in out["policy_class"].items()))
    print(f"policy-class attention arm: kernel7_launches="
          f"{counts['flash_attention']} (training, validation and trials); "
          f"launch counts of the run {counts}")

    cfg = pt.TCFG
    rec = SUPERVISED_RECORD
    cpu = torch.device("cpu")
    for name, init_fn, score_fn in (
            ("lstm", baselines.init_lstm, baselines.lstm_score),
            ("transformer", baselines.init_transformer,
             baselines.transformer_score)):
        arrays = record_supervised_draws(
            TorchDraws(torch.Generator().manual_seed(SEED + 21),
                       (rec["n_envs"],)), cfg, init_fn, rec["episodes"],
            rec["pods_per_episode"], rec["n_envs"], cpu)
        runs = []
        for dev in (device, cpu):
            with KubeSpy() as spy:
                params = train_rl.train_supervised_scorer(
                    ArrayDraws(**arrays, device=dev), cfg, init_fn, score_fn,
                    device=dev, **rec)
            runs.append((spy.actions, params))
        (a1, p1), (a2, p2) = runs
        assert len(a1) == len(a2) == rec["episodes"] * rec["pods_per_episode"]
        assert all(torch.equal(x, y) for x, y in zip(a1, a2)), name
        diff = _param_diff(p1, p2)
        assert diff <= 1e-5, (name, diff)
        print(f"supervised {name} card vs CPU port on recorded draws: "
              f"pod_steps={len(a1)} actions_identical=True "
              f"params_max_abs_diff={diff}")
    return counts


def _load_scenario_tables():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "scenario_tables", ROOT / "scripts" / "scenario_tables.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class ScoreCheck:
    """Holds kernel 1 to its plain version at every call a path makes
    (``schedulers.score_states`` at fleet scale): the same inputs through
    ``fused="plain"``, not counted as launches, within ``ATOL``."""

    def __enter__(self):
        from repro_torch.core import schedulers

        self.calls, self.max_err = 0, 0.0
        self._orig = orig = schedulers.score_states

        def check(qparams, state, pod, cfg, fused="auto", policy=None,
                  embed=None, score_fn=None):
            q = orig(qparams, state, pod, cfg, fused=fused, policy=policy,
                     embed=embed, score_fn=score_fn)
            if fused == "auto" and state.n_nodes >= \
                    schedulers.FUSED_SCORE_MIN_NODES:
                ref = orig(qparams, state, pod, cfg, fused="plain")
                err = float((q - ref).abs().max())
                assert err <= ATOL, err
                self.max_err = max(self.max_err, err)
                self.calls += 1
            return q

        schedulers.score_states = check
        return self

    def __exit__(self, *exc):
        from repro_torch.core import schedulers

        schedulers.score_states = self._orig


def phase_scenarios(device):
    """The scenario sweep, the lifecycle rows and the Pareto rows through
    ``scripts/scenario_tables.py``'s ``run`` at ``SCENARIO_CUT`` (every
    non-scoring-only scenario under kube and a cut mixture-trained SDQN;
    the four churn scenarios under kube, SDQN and SDQN-n with the
    consolidator, and under TOPSIS and an SDQN-n per energy weight), every
    row finite.  Then a
    cluster-of-clusters-4k episode (4,096 nodes in three classes, 32
    pods, 2 trials) under SDQN-n with the consolidator every 30 s, through
    kernel 1 (the selector's launch and the consolidator's four a step,
    one a cluster each) and through ``fused="plain"`` on the same recorded
    draws: every kernel-1 call held to its plain version on its inputs,
    the selector's actions identical up to the first near tie.  Between
    the two, the lifecycle SDQN-n's ``train_mixture`` card against CPU
    port (``paired_train_mixture``).  Returns the 4k episode's kernel
    launches."""
    from repro_torch import scenarios
    from repro_torch.core import dqn, schedulers
    from repro_torch.core.draws import (ArrayDraws, TorchDraws,
                                        record_trial_draws)
    from repro_torch.eval import engine as eval_engine
    from repro_torch.sched import elastic

    st = _load_scenario_tables()
    t0 = time.perf_counter()
    out = st.run(**SCENARIO_CUT, device=device)
    secs = time.perf_counter() - t0
    names = [n for n in scenarios.scenario_names()
             if n not in scenarios.SCORING_ONLY]
    assert sorted(out["scenarios"]) == sorted(names), sorted(out["scenarios"])
    for name, row in out["scenarios"].items():
        for pol, r in row.items():
            assert np.isfinite(r["metric_mean"]), (name, pol)
            assert r["pods_placed_mean"] + r["dropped_mean"] == \
                scenarios.make_env(name).scenario.n_pods, (name, pol)
            assert abs(r["evicted_mean"] - r["rescheduled_mean"]
                       - r["lost_mean"]) < 1e-9, (name, pol)
            if name in CHAOS_NAMES:
                print(f"scenario sweep {name} {pol}: avg_cpu="
                      f"{r['metric_mean']} evicted={r['evicted_mean']} "
                      f"rescheduled={r['rescheduled_mean']} "
                      f"lost={r['lost_mean']}")
    for name, row in out["pareto"].items():
        for arm, r in row.items():
            if arm != "sdqnn_dominates":
                assert all(np.isfinite([r["metric_mean"], r["energy_wh_mean"],
                                        r["dropped_mean"]])), (name, arm)
                print(f"pareto {name} {arm}: avg_cpu={r['metric_mean']} "
                      f"energy_wh={r['energy_wh_mean']} "
                      f"dropped={r['dropped_mean']}")
        print(f"pareto {name}: sdqnn dominates/matches topsis on "
              f"{row['sdqnn_dominates']} of "
              f"{len(SCENARIO_CUT['pareto_weights'])}")
    for name, row in out["lifecycle"].items():
        for pol, r in row.items():
            vals = [r[k] for k in ("nodes_active_mean", "energy_wh_mean",
                                   "metric_mean", "retired_mean",
                                   "moved_mean")]
            assert all(np.isfinite(vals)), (name, pol)
            print(f"lifecycle {name} {pol}: nodes_active={vals[0]} "
                  f"energy_wh={vals[1]} avg_cpu={vals[2]} retired={vals[3]} "
                  f"moved={vals[4]}")
    print(f"scenario tables (cut {SCENARIO_CUT}): seconds={secs} train_s="
          + " ".join(f"{k}={v['seconds']}" for k, v in out["train"].items()))
    paired_train_mixture(device, st)

    cfg = dataclasses.replace(scenarios.make_env(COC["name"]),
                              consolidate_every_s=st.CONSOLIDATE_EVERY_S)
    params = dqn.init_qnet(torch.Generator().manual_seed(SEED + 23),
                           device=device)
    draws = TorchDraws(torch.Generator(device=device).manual_seed(SEED + 24),
                       (COC["trials"],))
    arrays = record_trial_draws(draws, cfg, COC["pods"])
    runs = {}
    for fused in ("auto", "plain"):
        select = schedulers.make_sdqn_selector(params, cfg, fused=fused)
        consolidate = elastic.make_consolidator(params, cfg, fused=fused)
        with ActionSpy(module="schedulers") as spy, ScoreCheck() as check:
            zero_counts()                           # the path starts here
            res = eval_engine.make_batch_episode(
                cfg, select, COC["pods"], consolidate, device=device)(
                    ArrayDraws(**arrays, device=device))
            torch.cuda.synchronize()
            got = read_counts()                     # ... and ends here
        runs[fused] = (spy, res)
        steps = COC["pods"] + cfg.settle_steps
        want = COC["trials"] * (COC["pods"] + 4 * steps)
        if fused == "auto":
            counts, check_err = got, check.max_err
            assert got["sdqn_score_afterstate"] == want == sum(
                got.values()), (got, want)
            assert check.calls == COC["pods"] + 4 * steps, check.calls
            print(f"{COC['name']} episode N={cfg.n_nodes} pods={COC['pods']} "
                  f"trials={COC['trials']}: kernel1_launches="
                  f"{got['sdqn_score_afterstate']} (a launch a cluster: "
                  f"{COC['pods']} selections + 4 consolidator sub-steps x "
                  f"{steps} clock steps, per trial) kernel1_vs_plain "
                  f"max_abs_err={check.max_err} over {check.calls} calls")
        else:
            assert sum(got.values()) == 0, got
    (s1, r1), (s2, r2) = runs["auto"], runs["plain"]
    tie = next((i for i, (a, b) in enumerate(zip(s1.near, s2.near))
                if a or b), None)
    for i in range(len(s1.actions) if tie is None else tie):
        assert torch.equal(s1.actions[i], s2.actions[i]), i
    same = torch.equal(r1.exp_pods.cpu(), r2.exp_pods.cpu())
    print(f"{COC['name']} kernel 1 vs plain: first_near_tie_step={tie} "
          f"final_exp_pods_identical={same} moved={r1.moved.tolist()} / "
          f"{r2.moved.tolist()} nodes_active={r1.nodes_active.tolist()} / "
          f"{r2.nodes_active.tolist()} metric={r1.metric.tolist()} / "
          f"{r2.metric.tolist()}")
    assert int(r1.moved.sum()) > 0
    return counts, check_err


def paired_train_mixture(device, st):
    """The lifecycle SDQN-n (``SDQN_N_LIFECYCLE_PRESET``, its
    ``energy_weight``, over ``LIFECYCLE_MIX_NAMES``) trained by
    ``train_mixture`` at ``MIXTURE_CUT``'s episodes on the card and on the
    CPU port, from draws recorded from a CPU ``TorchDraws``
    (``record_mixture_draws``, one block a segment): the learner's
    actions identical up to the first near tie (two best feasible Q
    values within ``ATOL``); with none, params within 1e-5 and the trained
    policy with the consolidation pass every 30 s on recorded trials of
    ``MIXTURE_CUT``'s scenario: experiment pods and pods moved identical,
    metric and active nodes within 1e-5 relative.  After a near tie, its
    step and gap are printed."""
    from repro_torch import scenarios
    from repro_torch.core import presets, schedulers, train_rl
    from repro_torch.core.draws import (ArrayDraws, SegmentDraws, TorchDraws,
                                        record_mixture_draws,
                                        record_trial_draws)
    from repro_torch.eval import engine as eval_engine
    from repro_torch.sched import elastic

    cpu = torch.device("cpu")
    rl = dataclasses.replace(presets.SDQN_N_LIFECYCLE_PRESET,
                             episodes=MIXTURE_CUT["episodes"])
    cfgs = scenarios.training_mixture(presets.LIFECYCLE_MIX_NAMES)
    blocks = record_mixture_draws(TorchDraws(
        torch.Generator().manual_seed(SEED + 40), (rl.n_envs,)), cfgs, rl,
        device=cpu)
    cfg = dataclasses.replace(scenarios.make_env(MIXTURE_CUT["scenario"]),
                              consolidate_every_s=st.CONSOLIDATE_EVERY_S)
    n = cfg.scenario.n_pods
    trials = record_trial_draws(TorchDraws(torch.Generator().manual_seed(
        SEED + 41), (MIXTURE_CUT["trials"],)), cfg, n)
    runs = []
    for dev in (device, cpu):
        t0 = time.perf_counter()
        with ActionSpy() as spy:
            params, _ = train_rl.train_mixture(
                SegmentDraws([(ep0, ArrayDraws(**b, device=dev))
                              for ep0, b in blocks]), cfgs, rl, device=dev)
        res = eval_engine.make_batch_episode(
            cfg, schedulers.make_sdqn_selector(params, cfg), n,
            elastic.make_consolidator(params, cfg), device=dev)(
                ArrayDraws(**trials, device=dev))
        runs.append((spy, params, res, time.perf_counter() - t0))
    (card, card_p, card_res, card_s), (host, host_p, host_res, host_s) = runs
    steps = len(card.actions)
    segments = train_rl.mixture_schedule(cfgs, rl.episodes)
    assert steps == len(host.actions) == sum(
        k for _, _, k in segments) * rl.pods_per_episode, steps
    tie = next((i for i in range(steps) if card.near[i] or host.near[i]),
               None)
    for i in range(steps if tie is None else tie):
        assert torch.equal(card.actions[i], host.actions[i]), (
            f"paired train_mixture: pod step {i} differs before any near tie")
    same = all(torch.equal(a, b) for a, b in zip(card.actions, host.actions))
    line = (f"paired train_mixture lifecycle SDQN-n card vs CPU port (cut "
            f"{MIXTURE_CUT}, {len(segments)} segments, energy_weight="
            f"{rl.energy_weight}): pod_steps={steps} actions_identical="
            f"{same} first_near_tie_step={tie}")
    if tie is not None:
        gaps = [g for g in (card.gaps[tie], host.gaps[tie]) if g is not None]
        print(f"{line} gap={min(gaps)} (asserted up to that step) "
              f"card_s={card_s} cpu_s={host_s}")
        return
    diff = _param_diff(card_p, host_p)
    assert diff <= 1e-5, diff
    assert torch.equal(card_res.exp_pods.cpu(), host_res.exp_pods)
    assert torch.equal(card_res.moved.cpu(), host_res.moved)
    rel = max(float(((x.cpu() - y) / y).abs().max()) for x, y in (
        (card_res.metric, host_res.metric),
        (card_res.nodes_active, host_res.nodes_active)))
    assert rel <= 1e-5, rel
    print(f"{line} params_max_abs_diff={diff} {MIXTURE_CUT['scenario']} "
          f"with the pass: exp_pods_identical=True moved="
          f"{card_res.moved.tolist()} metric_max_rel_diff={rel} "
          f"nodes_active={card_res.nodes_active.tolist()} card_s={card_s} "
          f"cpu_s={host_s}")


# ---------------------------------------------------------------------------
# phase 19: chaos episodes and the rest of the scheduler
# ---------------------------------------------------------------------------

CHAOS_TRIALS = 3
COC_CHAOS = dict(name="cluster-of-clusters-4k", trials=2, pods=32,
                 down_frac=0.05, window_s=20.0)
ONLINE_STEPS = 4
ONLINE_REPLAY = 200
CKPT_REQUESTS = 500
SERVE_SMOKE_ARGS = ["--arch", "olmo-1b", "--smoke", "--replicas", "4",
                    "--requests", "32", "--wave-size", "8", "--prompt-len",
                    "32", "--gen-tokens", "4", "--seed", "0"]
DRAIN_N, DRAIN_LOADED, DRAIN_THRESHOLD = MAIN_N, 0.2, 3


class ColsCheck:
    """Holds kernel 3 to its plain version at every ``sched.api.score``
    call on a job fleet through the kernel path (``PlacementEngine.select``
    and ``api.select`` go through it): the same inputs through
    ``fused="plain"`` (no launch), within ``ATOL`` on the feasible hosts,
    and whether the two best feasible scores lie within ``ATOL``."""

    def __enter__(self):
        from repro_torch.sched import api, placement as pl

        self.calls, self.max_err, self.near = 0, 0.0, []
        self._orig = orig = api.score

        def check(fleet, pod, *, params, fused="auto", **kw):
            q = orig(fleet, pod, params=params, fused=fused, **kw)
            if isinstance(fleet, pl.FleetState) and fused in ("auto", True):
                ref = orig(fleet, pod, params=params, fused="plain", **kw)
                ok = pl.PlacementEngine(params).feasible(fleet, pod)
                if bool(ok.any()):
                    err = float((q - ref).abs()[ok].max())
                    assert err <= ATOL, err
                    self.max_err = max(self.max_err, err)
                    top = torch.topk(torch.where(ok, ref, -torch.inf),
                                     min(2, ref.shape[0])).values
                    self.near.append(bool(torch.isfinite(top[-1]))
                                     and float(top[0] - top[-1]) <= ATOL)
                self.calls += 1
            return q

        api.score = check
        return self

    def __exit__(self, *exc):
        from repro_torch.sched import api

        api.score = self._orig


def _chaos_counts(res):
    s = res.stats
    ev, re, lo = (x.cpu() for x in (s.evicted, s.rescheduled, s.lost))
    assert torch.equal(ev, re + lo), (ev, re, lo)
    return ev.tolist(), re.tolist(), lo.tolist()


def phase_chaos_episodes(device):
    """The three flaky scenarios under kube and SDQN (a random Q-net),
    ``CHAOS_TRIALS`` trials each, traces and draws from ``TorchDraws``:
    the pods evicted, rescheduled and lost per trial, balanced in every
    cluster, and evictions on at least one scenario."""
    from repro_torch import scenarios
    from repro_torch.core import dqn, env, schedulers
    from repro_torch.core.draws import TorchDraws

    params = dqn.init_qnet(torch.Generator().manual_seed(SEED + 30),
                           device=device)
    evicted = 0
    for name in CHAOS_NAMES:
        cfg = scenarios.make_env(name)
        for pol, select in (("kube", schedulers.make_kube_selector(cfg)),
                            ("sdqn", schedulers.make_sdqn_selector(params,
                                                                   cfg))):
            draws = TorchDraws(torch.Generator(device=device).manual_seed(
                SEED + 31), (CHAOS_TRIALS,))
            res = env.run_episode(draws, cfg, select, cfg.scenario.n_pods,
                                  device=device)
            ev, re, lo = _chaos_counts(res)
            evicted += sum(ev)
            print(f"chaos {name} {pol}: avg_cpu={res.metric.tolist()} "
                  f"evicted={ev} rescheduled={re} lost={lo} "
                  f"dropped={res.dropped.tolist()}")
    assert evicted > 0


def _coc_chaos_trace(params, cfg, arrays, device):
    """The 4k episode's failure trace, from the phase's seed: in each
    trial the ``down_frac`` nodes with the best Q for its first arrival at
    reset (those SDQN fills first) are down from its middle arrival for
    ``window_s`` seconds.  (One kernel-1 launch a trial, before the path's
    count starts.)"""
    from repro_torch.core import schedulers
    from repro_torch.core.draws import ArrayDraws
    from repro_torch.core.types import FailureTrace, PodSpec

    draws = ArrayDraws(**arrays, device=device)
    state = draws.reset(cfg, device=device)
    table = draws.pod_table(cfg, COC_CHAOS["pods"], device=device)
    q = schedulers.score_states(params, state, PodSpec(
        *(x[..., 0] for x in table.specs)), cfg)
    n_down = int(COC_CHAOS["down_frac"] * cfg.n_nodes)
    down = torch.zeros_like(q, dtype=torch.bool).scatter(
        -1, torch.topk(q, n_down, dim=-1).indices, True)
    t_mid = torch.cumsum(table.dt_s, dim=-1)[..., COC_CHAOS["pods"] // 2 - 1]
    inf = torch.full_like(q, float("inf"))
    fail = torch.where(down, t_mid[..., None], inf)
    rec = torch.where(down, t_mid[..., None] + COC_CHAOS["window_s"], inf)
    return FailureTrace(fail[..., None, :], rec[..., None, :]), n_down


def phase_chaos_fleet(device):
    """A cluster-of-clusters-4k chaos episode (4,096 nodes, 32 pods, 2
    trials) under SDQN with a random Q-net through kernel 1 and through
    ``fused="plain"`` on the same recorded draws and trace: a launch a
    cluster for every arrival selection and every re-placement attempt
    (exactly trials x 2 x 32), every call held to the plain version, the
    actions identical up to the first near tie.  Returns the launches."""
    from repro_torch import scenarios
    from repro_torch.core import dqn, env, schedulers
    from repro_torch.core.draws import (ArrayDraws, TorchDraws,
                                        record_trial_draws)

    cfg = scenarios.make_env(COC_CHAOS["name"])
    params = dqn.init_qnet(torch.Generator().manual_seed(SEED + 32),
                           device=device)
    draws = TorchDraws(torch.Generator(device=device).manual_seed(SEED + 33),
                       (COC_CHAOS["trials"],))
    arrays = record_trial_draws(draws, cfg, COC_CHAOS["pods"])
    trace, n_down = _coc_chaos_trace(params, cfg, arrays, device)
    runs = {}
    for fused in ("auto", "plain"):
        select = schedulers.make_sdqn_selector(params, cfg, fused=fused)
        with ActionSpy(module="schedulers") as spy, ScoreCheck() as check:
            zero_counts()                           # the path starts here
            res = env.run_episode(ArrayDraws(**arrays, device=device), cfg,
                                  select, COC_CHAOS["pods"],
                                  failure_trace=trace, device=device)
            torch.cuda.synchronize()
            got = read_counts()                     # ... and ends here
        runs[fused] = (spy, res)
        want = COC_CHAOS["trials"] * 2 * COC_CHAOS["pods"]
        if fused == "auto":
            counts = got
            assert got["sdqn_score_afterstate"] == want == sum(
                got.values()), (got, want)
            assert check.calls == 2 * COC_CHAOS["pods"], check.calls
            print(f"{COC_CHAOS['name']} chaos episode N={cfg.n_nodes} pods="
                  f"{COC_CHAOS['pods']} trials={COC_CHAOS['trials']} down="
                  f"{n_down} nodes a trial for {COC_CHAOS['window_s']} s: "
                  f"kernel1_launches={got['sdqn_score_afterstate']} (a "
                  f"launch a cluster: {COC_CHAOS['pods']} arrival selections"
                  f" + {COC_CHAOS['pods']} re-placement attempts, per trial)"
                  f" kernel1_vs_plain max_abs_err={check.max_err} over "
                  f"{check.calls} calls")
            check_err = check.max_err
        else:
            assert sum(got.values()) == 0, got
    (s1, r1), (s2, r2) = runs["auto"], runs["plain"]
    tie = next((i for i, (a, b) in enumerate(zip(s1.near, s2.near))
                if a or b), None)
    for i in range(len(s1.actions) if tie is None else tie):
        assert torch.equal(s1.actions[i], s2.actions[i]), i
    c1, c2 = _chaos_counts(r1), _chaos_counts(r2)
    print(f"{COC_CHAOS['name']} chaos kernel 1 vs plain: first_near_tie_step="
          f"{tie} evicted/rescheduled/lost={c1} / {c2} metric="
          f"{r1.metric.tolist()} / {r2.metric.tolist()}")
    assert sum(c1[0]) > 0
    return counts, check_err


def _spy_params(d):
    """Record the params object each scored batch of ``d`` used."""
    seen, inner = [], d._scorer

    def spy(params, *args):
        seen.append(params)
        return inner(params, *args)

    d._scorer = spy
    return seen


def phase_online(device):
    """The online loop at full width: the flat 5,000-node daemon replays
    phase 3's trace (500/s) on a deterministic clock with a
    ``TransitionRecorder`` on its ``decision_hook`` and without: the same
    decisions, kernel-1 launches equal to batches in both (the recorder
    adds none).  Then ``ONLINE_STEPS`` ``OnlineRefresher.step()``s, each
    publishing new params, and a replay whose every batch scores with the
    last published params.  Then ``serve.main`` with ``--online`` (the
    OLMo-1B smoke widths; the routing Q-net is full width either way):
    kernel 3 once per daemon batch and the warm-up, every refresh step
    published.  Returns the launches of kernels 1 and 3."""
    from repro_torch.kernels import sdqn_score as ss
    from repro_torch.launch import serve
    from repro_torch.scenarios import arrival_trace
    from repro_torch.sched.daemon import (ClusterSubstrate, DaemonConfig,
                                          PlacementDaemon)
    from repro_torch.sched.online import OnlineRefresher, TransitionRecorder

    cfg, state, params = _serving_setup(device)
    trace = arrival_trace(torch.Generator().manual_seed(SEED + 2), cfg,
                          N_REQUESTS, rate_per_s=RATES_PER_S[0])
    runs = {}
    for with_rec in (False, True):
        clock = StepClock()
        rec = TransitionRecorder(state, cfg, device=device) if with_rec \
            else None
        d = PlacementDaemon(ClusterSubstrate(state, cfg, device=device),
                            params, DaemonConfig(batch_size=32,
                                                 max_wait_s=0.005),
                            clock=clock, timer=clock,
                            decision_hook=rec.record if rec else None)
        d.warmup()
        zero_counts()                               # the path starts here
        _replay_deterministic(d, clock, trace.t_s, trace.pods)
        torch.cuda.synchronize()
        got = read_counts()                         # ... and ends here
        m = d.metrics
        assert got["sdqn_score_afterstate"] == m.batches == \
            m.device_launches == sum(got.values()), (got, m)
        check_outcome(d, cfg)
        runs[with_rec] = (d, rec, got, clock)
    (d0, _, c0, _), (d1, rec, c1, clock) = runs[False], runs[True]
    batches = d1.metrics.batches
    same = [(x.req_id, x.node) for x in d0.decisions] == [
        (x.req_id, x.node) for x in d1.decisions]
    assert same and c0 == c1, (c0, c1)
    assert rec.recorded == len(d1.decisions) == N_REQUESTS
    counts = dict(c1)

    ref = OnlineRefresher(d1, rec, seed=SEED)
    ref.warmup()
    t0 = time.perf_counter()
    published = []
    for _ in range(ONLINE_STEPS):
        front = d1._params
        loss = ref.step()
        torch.cuda.synchronize()
        assert loss is not None and np.isfinite(loss)
        assert d1._params is ref.params and d1._params is not front
        published.append(loss)
    secs = time.perf_counter() - t0
    seen = _spy_params(d1)
    more = arrival_trace(torch.Generator().manual_seed(SEED + 34), cfg,
                         ONLINE_REPLAY, rate_per_s=RATES_PER_S[0])
    zero_counts()                                   # the path starts here
    _replay_deterministic(d1, clock, clock.t + more.t_s, more.pods)
    torch.cuda.synchronize()
    got = read_counts()                             # ... and ends here
    assert seen and all(p is ref.params for p in seen), len(seen)
    assert got["sdqn_score_afterstate"] == len(seen), (got, len(seen))
    counts["sdqn_score_afterstate"] += got["sdqn_score_afterstate"]
    print(f"online loop N={cfg.n_nodes}: {N_REQUESTS} requests, decisions "
          f"identical with and without the recorder={same}, kernel1_launches="
          f"{c1['sdqn_score_afterstate']} = batches={batches} "
          f"(recorder adds 0); {ONLINE_STEPS} refresh steps in {secs} s "
          f"(first drains {rec.drained} transitions), losses={published}; "
          f"replay of {ONLINE_REPLAY} more: {len(seen)} batches, all on the "
          f"published params")

    zero_counts()                                   # the path starts here
    res = serve.main(SERVE_SMOKE_ARGS + ["--online", "--online-steps",
                                         str(ONLINE_STEPS)])
    torch.cuda.synchronize()
    got = read_counts()                             # ... and ends here
    m, r = res.daemon.metrics, res.refresher
    assert got["sdqn_score_cols"] == m.batches + 1, (got, m)   # + warm-up
    assert (r.steps, r.swaps) == (ONLINE_STEPS, ONLINE_STEPS), r.steps
    assert r.recorder.drained == len(res.assignments) and np.isfinite(
        r.last_loss)
    assert res.daemon._params is r.params
    print(f"serve --online (smoke LM): kernel3_launches="
          f"{got['sdqn_score_cols']} (batches {m.batches} + warm-up), "
          f"{r.recorder.drained} transitions, {r.steps} refresh steps, "
          f"last_loss={r.last_loss}")
    counts["sdqn_score_cols"] = got["sdqn_score_cols"]
    return counts


def phase_checkpoints(device):
    """Params through ``policy.save_checkpoint`` and back: the flat daemon
    replays ``CKPT_REQUESTS`` of phase 3's trace with the restored params
    and with the in-memory ones (the same decisions), and ``serve.main``
    routes with ``--qnet-path`` as with the fresh init it saved (the same
    assignments).  A damaged shard with ``on_corrupt="fallback"`` gives a
    fresh init and a warning."""
    import tempfile
    import warnings

    from repro_torch.core import policy
    from repro_torch.launch import serve
    from repro_torch.optim import tree_leaves
    from repro_torch.scenarios import arrival_trace
    from repro_torch.sched.daemon import (ClusterSubstrate, DaemonConfig,
                                          PlacementDaemon)

    cfg, state, params = _serving_setup(device)
    trace = arrival_trace(torch.Generator().manual_seed(SEED + 2), cfg,
                          CKPT_REQUESTS, rate_per_s=RATES_PER_S[0])
    with tempfile.TemporaryDirectory() as tmp:
        policy.save_checkpoint(f"{tmp}/qnet", 7, params, policy.get("mlp"))
        restored, spec = policy.restore_checkpoint(f"{tmp}/qnet",
                                                   device=device)
        assert spec.name == "mlp"
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(restored),
                                                     tree_leaves(params)))
        decisions = []
        for p in (params, restored):
            clock = StepClock()
            d = PlacementDaemon(ClusterSubstrate(state, cfg, device=device), p,
                                DaemonConfig(batch_size=32, max_wait_s=0.005),
                                clock=clock, timer=clock)
            _replay_deterministic(d, clock, trace.t_s, trace.pods)
            decisions.append([(x.req_id, x.node) for x in d.decisions])
        assert decisions[0] == decisions[1]

        qp, qspec = serve.load_policy("", serve.seed_generator(0, 1),
                                      device=device)
        policy.save_checkpoint(f"{tmp}/route", 1, qp, qspec)
        fresh = serve.main(SERVE_SMOKE_ARGS)
        loaded = serve.main(SERVE_SMOKE_ARGS + ["--qnet-path",
                                                f"{tmp}/route"])
        assert fresh.assignments == loaded.assignments

        with open(f"{tmp}/qnet/step_00000007/shard_00000.npz", "wb") as f:
            f.write(b"not an npz")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            back, spec = policy.restore_checkpoint(
                f"{tmp}/qnet", on_corrupt="fallback", device=device)
        said = [str(w.message) for w in caught
                if "falling back" in str(w.message)]
        assert said and spec.name == "mlp"
        assert all(a.shape == b.shape and a.device == b.device for a, b in
                   zip(tree_leaves(back), tree_leaves(params)))
    print(f"checkpoints: the flat daemon's {CKPT_REQUESTS} decisions identical"
          f" with restored and in-memory params; serve --qnet-path "
          f"assignments={loaded.assignments} identical to the fresh init's; "
          f"damaged shard with on_corrupt=fallback: {said[0]!r}")


def _drain_fleet(device):
    """``fresh_fleet(DRAIN_N)`` with 1 to 6 jobs on a ``DRAIN_LOADED``
    share of the hosts, their load on the host's columns."""
    from repro_torch.sched import placement as pl

    fleet = pl.fresh_fleet(DRAIN_N, torch.Generator().manual_seed(SEED + 35),
                           device=device)
    rng = np.random.default_rng(SEED + 35)
    jobs = np.where(rng.random(DRAIN_N) < DRAIN_LOADED,
                    rng.integers(1, 7, DRAIN_N), 0)
    j = torch.tensor(jobs, dtype=torch.float32, device=device)
    return fleet._replace(cpu_pct=fleet.cpu_pct + 3.0 * j,
                          mem_pct=fleet.mem_pct + 2.0 * j,
                          job_util_pct=pl.JOB_UTIL_DELTA_PCT * j,
                          num_jobs=j.to(torch.int32)), jobs


def _same_up_to_tie(a, b, near, label):
    """Two migration lists agree, or differ only after a near tie."""
    diff = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if diff is None and len(a) == len(b):
        return True
    assert any(near), f"{label}: differs without a near tie"
    return False


def phase_drain_and_straggler(device):
    """``consolidation_plan`` over ``_drain_fleet`` (hosts with 1 to
    ``DRAIN_THRESHOLD`` jobs drained) and a ``StragglerMonitor``
    evacuation of the most loaded host: kernel 3 once per
    ``engine.select`` / ``api.select`` call (B = 1), every call held to
    the plain version, and the same plan and migrations as through the
    plain path (``use_kernel=False``, resp. ``fused="plain"``) up to near
    ties.  Returns the kernel-3 launches."""
    from repro_torch.core import dqn
    from repro_torch.sched import api, elastic, placement as pl
    from repro_torch.sched.straggler import StragglerMonitor

    fleet, jobs = _drain_fleet(device)
    params = dqn.init_qnet(torch.Generator().manual_seed(SEED + 36),
                           device=device)
    job = pl.JobSpec(cpu_pct_demand=3.0, mem_pct_demand=2.0)
    engine = pl.PlacementEngine(params)
    with ColsCheck() as check:
        zero_counts()                               # the path starts here
        t0 = time.perf_counter()
        plan = elastic.consolidation_plan(engine, fleet, job,
                                          DRAIN_THRESHOLD)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = read_counts()                         # ... and ends here
    assert got["sdqn_score_cols"] == check.calls == sum(got.values()) > 0, (
        got, check.calls)
    plain = elastic.consolidation_plan(
        pl.PlacementEngine(params, use_kernel=False), fleet, job,
        DRAIN_THRESHOLD)
    same = _same_up_to_tie(plan.migrations, plain.migrations, check.near,
                           "consolidation_plan")
    if same:
        assert plan.drain_hosts == plain.drain_hosts
        assert abs(plan.projected_avg_cpu_after
                   - plain.projected_avg_cpu_after) <= 1e-4
    assert plan.projected_avg_cpu_after <= plan.projected_avg_cpu_before + 1e-3
    counts = {"plan": got["sdqn_score_cols"]}
    print(f"consolidation_plan N={DRAIN_N} (candidates "
          f"{int(((jobs > 0) & (jobs <= DRAIN_THRESHOLD)).sum())}): "
          f"hosts_freed={plan.hosts_freed} migrations={len(plan.migrations)}"
          f" avg_cpu {plan.projected_avg_cpu_before} -> "
          f"{plan.projected_avg_cpu_after} in {secs} s; kernel3_launches="
          f"{got['sdqn_score_cols']} max_abs_err={check.max_err} "
          f"near_ties={sum(check.near)}; identical to use_kernel=False: "
          f"{same}")
    plan_err = check.max_err

    slow = int(np.argmax(jobs))
    runs = {}
    for fused in ("auto", "plain"):
        mon = StragglerMonitor(window=8, threshold=1.5)
        for _ in range(8):
            for h in range(64):
                mon.record(h, 1.0)
            mon.record(slow, 3.0)
        assert mon.stragglers() == [slow], mon.stragglers()
        orig = api.select
        if fused == "plain":
            api.select = functools.partial(orig, fused="plain")
        try:
            with ColsCheck() as check:
                zero_counts()                       # the path starts here
                out, migrations = mon.evacuate(engine, fleet, job)
                torch.cuda.synchronize()
                got = read_counts()                 # ... and ends here
        finally:
            api.select = orig
        runs[fused] = (out, migrations, got, check)
    (out, mig, got, check), (pout, pmig, pgot, _) = runs["auto"], runs["plain"]
    assert got["sdqn_score_cols"] == check.calls == sum(got.values()) > 0
    assert sum(pgot.values()) == 0, pgot
    assert int(out.num_jobs.sum()) == int(jobs.sum()) - (
        int(jobs[slow]) - len(mig)) and int(out.num_jobs[slow]) == 0
    same_ev = _same_up_to_tie(mig, pmig, check.near, "evacuate")
    counts["evacuate"] = got["sdqn_score_cols"]
    print(f"straggler evacuation of host {slow} ({int(jobs[slow])} jobs): "
          f"migrations={mig} kernel3_launches={got['sdqn_score_cols']} "
          f"max_abs_err={check.max_err}; identical to fused=plain: {same_ev}")
    return counts, max(plan_err, check.max_err)


def phase_rest(device):
    """Phase 19: the chaos episodes, chaos at fleet size through kernel 1,
    the online loop, checkpoints, the drain planner and the straggler
    monitor.  Returns (launches by path, kernel 1's and 3's max errors)."""
    t0 = time.perf_counter()
    phase_chaos_episodes(device)
    chaos_counts, chaos_err = phase_chaos_fleet(device)
    online_counts = phase_online(device)
    phase_checkpoints(device)
    drain_counts, drain_err = phase_drain_and_straggler(device)
    print(f"phase 19 seconds={time.perf_counter() - t0}")
    return ({"sdqn_score_afterstate": {
                "cluster-of-clusters-4k chaos episode":
                chaos_counts["sdqn_score_afterstate"],
                "online loop, flat cluster":
                online_counts["sdqn_score_afterstate"]},
             "sdqn_score_cols": {
                 "serve --online wave routing":
                 online_counts["sdqn_score_cols"],
                 "consolidation_plan": drain_counts["plan"],
                 "straggler evacuation": drain_counts["evacuate"]}},
            chaos_err, drain_err)


# ---------------------------------------------------------------------------
# Phase 22: LM training (kernel 7 with its row log-sum-exp, and its
# hand-written backward)
# ---------------------------------------------------------------------------

# (B, Sq, Skv, Hq, Hkv, D, causal): every training shape the port reaches
# at its configs' widths, and one ragged causal shape
FA_BWD_SHAPES = {
    "olmo_train": (8, 512, 512, 16, 16, 128, True),
    "granite_train": (8, 512, 512, 32, 8, 128, True),
    "dbrx_train": (8, 512, 512, 48, 8, 128, True),
    "whisper_encoder": (8, 1500, 1500, 16, 16, 64, False),
    "whisper_cross": (8, 448, 1500, 16, 16, 64, False),
    "ragged": (2, 77, 300, 6, 2, 64, True),
}
FA_BWD_TIMED = ("olmo_train", "whisper_encoder", "whisper_cross")
# Relative to the largest element of each gradient.  float32: the kernels
# sum in another order than the plain version.  bfloat16: the kernels round
# P and dS to bfloat16 as the A operands of their products (2^-9 relative
# each, summed over up to 1,500 keys of either sign) and the gradients to
# bfloat16 on output (2^-9); an H100 measured 0.8% at most at these
# shapes, and the bound is 2.5 times that.
FA_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FA_FWD_LSE_TOL = 1e-4                 # the forward's lse against plain's
# Relative to each row's scale (``row_rel_err``: a query's output or dQ
# row, a key's dK or dV row), for the output and the gradients alike.  At
# 4,096 causal keys a late query's output is ~1/40 of an early one's, so a
# check against the whole tensor's largest element (``LM_TOL``,
# ``FA_BWD_TOL``) would pass a wrong tile in the late rows.  A row's scale
# is its largest element, or where larger the largest root-sum-square of
# the terms that sum to an element (``attention_rss``): a dQ row whose
# terms cancel to near zero (the first query's, which sees one key, is 0)
# carries the rounding of its terms, not of its value.  bfloat16: both
# sides round each element to bfloat16 (one step, 2^-8 of the element at
# most) and the kernels round P and dS to bfloat16 as above: an H100
# read one step at a row's largest element (2^-7) at every shape.  One
# shifted 32-key tile in the last rows at 4,096 keys reads 0.58 (output)
# and 2.3-12 (gradients), where dV's whole-tensor error, 0.0177, passes
# ``FA_BWD_TOL`` (``check_row_tol_catches_shifted_tiles``; at two heads on
# the CPU the output's passes ``LM_TOL`` too, ``tests/test_torch_dryrun.py``).
FA_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FA_FAULT_ROWS = 32                    # a quarter of a D = 128 tile

TRAIN_STEPS = 40
TRAIN_ARGS = ["--arch", "olmo-1b", "--steps", str(TRAIN_STEPS), "--batch",
              "8", "--seq", "512", "--log-every", "5"]
TRAIN_PROFILED = (2, 3, 4)            # steps under torch.profiler
TRAIN_MEDIAN_FROM = 5                 # ms a step: median of steps 5-39
# the resume check: smoke OLMo at head width 64 (the backward's), 2 layers
RESUME_ARGS = ["--arch", "olmo-1b", "--smoke", "--d-model", "256",
               "--layers", "2", "--steps", "21", "--batch", "8", "--seq",
               "128", "--ckpt-every", "4", "--log-every", "100"]
RESUME_FAIL_AT = 12
RESUME_TOL = 1e-3                     # relative; embedding atomics
TRAIN_PLAIN_LAYERS = 2                # full width, float32, kernels vs plain
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-4                 # relative to a leaf's largest element
WHISPER_TRAIN = dict(layers=2, batch=8, seq=448, steps=3)
# falcon-mamba-7b at its published widths cut to 8 of its 64 layers (7.0 B
# parameters whole are ~112 GB of bf16 weights, gradients and float32
# master and moments), 30 steps of 8 x 512: kernel 6 at (8, 512, 8192, 16)
SSM_TRAIN_LAYERS = 8
SSM_TRAIN_STEPS = 30
SSM_TRAIN_ARGS = ["--arch", "falcon-mamba-7b", "--layers",
                  str(SSM_TRAIN_LAYERS), "--steps", str(SSM_TRAIN_STEPS),
                  "--batch", "8", "--seq", "512", "--log-every", "5"]
# jamba at its smoke widths with kernel 7's backward's head width
JAMBA_TRAIN = dict(head_dim=64, batch=8, seq=256, steps=3)
# kernel 6's backward against its plain twin: each state size, ragged S,
# one batch row and several, falcon-mamba-7b's training shape
SCAN_BWD_SHAPES = ((1, 32, 8, 4), (2, 64, 16, 8), (1, 128, 32, 16),
                   (2, 37, 12, 4), (3, 300, 200, 8), (1, 257, 1024, 16),
                   SCAN_WIDE, SCAN_FALCON)
SCAN_BWD_TIMED = (SCAN_FALCON, SCAN_PATH, SCAN_WIDE)
# relative to each gradient's largest element: the kernel sums over the
# states, segments, channels and steps in another order than the plain
# twin (an H100 measured 1.1e-6 at most at these shapes)
SCAN_BWD_TOL = 1e-4
# the backward's float32 operations a (batch, step, channel, state): the
# forward again (3), G, P, the dB / dC terms, the three sums (13); and a
# (batch, step, channel): dx, ddt, dD
SCAN_BWD_OPS_PER_STATE, SCAN_BWD_OPS_PER_CHANNEL = 16, 6
# the backward's dB / dC block partials at falcon's shape, at most (a block
# for 8 channels wrote 0.54 GB; 32 channels a block: 0.134)
SCAN_BWD_MAX_PARTIALS = 0.14e9


def _bwd_case(shape, dtype, device, seed):
    b, sq, skv, hq, hkv, d, _ = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(s, generator=gen, device=device).to(dtype)
                 for s in ((b, sq, hq, d), (b, skv, hkv, d),
                           (b, skv, hkv, d), (b, sq, hq, d)))


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def row_rel_err(got, want, rss=None) -> float:
    """The largest |got - want| of a row (the last dimension) over the
    row's scale: its largest |want|, or the largest of ``rss`` (the
    root-sum-square of each element's terms) where that is larger; each
    row's scale floored at 1e-6 of the largest row's."""
    got, want = got.float(), want.float()
    size = want.abs() if rss is None else torch.maximum(want.abs(), rss)
    size = size.amax(dim=-1)
    size = torch.clamp_min(size, 1e-6 * float(size.max()))
    return float(((got - want).abs().amax(dim=-1) / size).max())


@torch.no_grad()
def attention_rss(q, k, v, o, do, lse, causal, block=512):
    """(out, dq, dk, dv): for each element of attention's output and
    gradients the root-sum-square of the terms that sum to it, in float32
    over key blocks as ``flash_attention_bwd_plain``: out_id = sum_j P_ij
    v_jd, dq_id = scale sum_j dS_ij k_jd, dk_jd = scale sum_i dS_ij q_id,
    dv_jd = sum_i P_ij do_id, each dS_ij taken at its size P_ij (|dP_ij| +
    |Delta_i|).  A kernel that rounds P and dS moves an element by a share
    of this, whatever the terms cancel to."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g, scale = hq // hkv, 1.0 / math.sqrt(d)

    def heads(t):                                    # (B, Hkv, g, Sq, D)
        return t.float().reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4)

    qh, oh, doh = heads(q), heads(o), heads(do)
    kh = k.float().permute(0, 2, 1, 3)[:, :, None]   # (B, Hkv, 1, Skv, D)
    vh = v.float().permute(0, 2, 1, 3)[:, :, None]
    lse_h = lse.reshape(b, hkv, g, sq, 1)
    delta = torch.sum(doh * oh, dim=-1, keepdim=True).abs()
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    out2, dq2 = torch.zeros_like(qh), torch.zeros_like(qh)
    dk2 = torch.zeros((b, hkv, skv, d), device=q.device)
    dv2 = torch.zeros_like(dk2)
    for j0 in range(0, skv, block):
        kb, vb = kh[..., j0:j0 + block, :], vh[..., j0:j0 + block, :]
        s = (qh @ kb.transpose(-1, -2)) * scale
        if causal:
            kpos = torch.arange(j0, j0 + kb.shape[-2], device=q.device)
            s = s.masked_fill(kpos[None, :] > qpos, -torch.inf)
        p = torch.exp(s - lse_h)
        ds = p * ((doh @ vb.transpose(-1, -2)).abs() + delta)
        p2, ds2 = p * p, ds * ds
        out2 += p2 @ (vb * vb)
        dq2 += (ds2 @ (kb * kb)) * scale ** 2
        j1 = j0 + kb.shape[-2]
        dk2[:, :, j0:j1] = (ds2.transpose(-1, -2) @ (qh * qh)).sum(dim=2) \
            * scale ** 2
        dv2[:, :, j0:j1] = (p2.transpose(-1, -2) @ (doh * doh)).sum(dim=2)

    def rows(t2):
        return t2.sqrt().permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)

    return (rows(out2), rows(dq2), dk2.sqrt().permute(0, 2, 1, 3),
            dv2.sqrt().permute(0, 2, 1, 3))


def shifted_tile(t, rows=FA_FAULT_ROWS):
    """``t`` (B, S, H, D) with its last ``rows`` rows replaced by the
    ``rows`` before them: what a kernel that read the wrong tile there
    would see."""
    bad = t.clone()
    bad[:, -rows:] = t[:, -2 * rows:-rows]
    return bad


def check_row_tol_catches_shifted_tiles(q, k, v, do, causal, label):
    """Plant two faults at one shape and show that ``FA_ROW_TOL`` (per
    row) rejects both: the output with V's last ``FA_FAULT_ROWS`` keys
    taken from the tile before them, and the gradients with dO's last
    ``FA_FAULT_ROWS`` queries taken so.  The whole-tensor checks
    (``LM_TOL``, ``FA_BWD_TOL``) are printed beside.  Plain versions only
    (no launch)."""
    from repro_torch.kernels import flash_attention as fa

    out, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                        return_lse=True)
    bad = fa.flash_attention_plain(q, k, shifted_tile(v), causal=causal)
    grads = fa.flash_attention_bwd_plain(q, k, v, out, do, lse,
                                         causal=causal)
    bad_grads = fa.flash_attention_bwd_plain(q, k, v, out, shifted_tile(do),
                                             lse, causal=causal)
    rss = attention_rss(q, k, v, out, do, lse, causal)
    tol, dtype = FA_ROW_TOL[q.dtype], q.dtype
    out_row, out_abs = row_rel_err(bad, out, rss[0]), float(
        (bad.float() - out.float()).abs().max())
    g_row = [row_rel_err(b, g, r)
             for b, g, r in zip(bad_grads, grads, rss[1:])]
    g_rel = [_rel_err(b, g) for b, g in zip(bad_grads, grads)]
    print(f"planted faults {label}: V's last {FA_FAULT_ROWS} keys shifted "
          f"a tile: output per row {out_row} (FA_ROW_TOL {tol}: caught "
          f"{out_row > tol}), max_abs {out_abs} (LM_TOL {LM_TOL[dtype]}: "
          f"caught {out_abs > LM_TOL[dtype]}); dO's last {FA_FAULT_ROWS} "
          f"queries shifted: dq, dk, dv per row {g_row} (caught "
          f"{[e > tol for e in g_row]}), relative to the largest {g_rel} "
          f"(FA_BWD_TOL {FA_BWD_TOL[dtype]}: caught "
          f"{[e > FA_BWD_TOL[dtype] for e in g_rel]})")
    assert out_row > tol and min(g_row) > tol, (out_row, g_row)


def check_bwd_kernels(device):
    """Kernel 7's forward with its lse and the backward kernels against the
    plain versions on the same tensors, and against autograd of the plain
    forward in float32, at every ``FA_BWD_SHAPES`` shape in float32 and
    bfloat16 (``check_bwd_case``).  Returns the largest absolute gradient
    error per dtype."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).split(".")[1]
        for label, shape in FA_BWD_SHAPES.items():
            errs[key] = max(errs.get(key, 0.0),
                            check_bwd_case(label, shape, dtype, device)[0])
    torch.cuda.empty_cache()
    return errs


def check_bwd_case(label, shape, dtype, device):
    """Kernel 7's forward with its lse and its backward at ``shape`` in
    ``dtype`` against the plain versions on the same tensors (the output
    within ``LM_TOL``, the lse ``FA_FWD_LSE_TOL``, the gradients
    ``FA_BWD_TOL`` of the largest, the output and the gradients
    ``FA_ROW_TOL`` of each row's largest) and against autograd of the plain
    forward in float32; in bfloat16 twice more (``check_bwd_repeats``).
    Returns the largest absolute gradient error and the output's."""
    from repro_torch.kernels import flash_attention as fa

    causal = shape[6]
    q, k, v, do = _bwd_case(shape, dtype, device, SEED + len(label))
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    pout, plse = fa.flash_attention_plain(q, k, v, causal=causal,
                                          return_lse=True)
    lse_err = float((lse - plse).abs().max())
    out_err = float((out.float() - pout.float()).abs().max())
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(q, k, v, out, do, lse, causal=causal)
    live = [t.float().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(
        fa.flash_attention_plain(*live, causal=causal), live, do.float())
    rel = [_rel_err(g, w) for g, w in zip(got, want)]
    rel_auto = [_rel_err(g, w) for g, w in zip(got, auto)]
    rss = attention_rss(q, k, v, out, do, lse, causal)
    out_row = row_rel_err(out, pout, rss[0])
    rows = [row_rel_err(g, w, r) for g, w, r in zip(got, want, rss[1:])]
    abs_err = max(float((g.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
    print(f"flash_attention_bwd {label} {shape} {dtype}: dq, dk, dv "
          f"relative to the largest gradient vs plain {rel}, vs "
          f"autograd of the plain forward {rel_auto}, vs plain per row "
          f"{rows}; lse max_abs_err {lse_err}; out max_abs_err {out_err}, "
          f"per row {out_row}")
    tol = FA_BWD_TOL[dtype]
    assert max(rel + rel_auto) <= tol, (label, dtype, rel, rel_auto)
    assert max(rows + [out_row]) <= FA_ROW_TOL[dtype], (label, dtype, rows,
                                                        out_row)
    assert lse_err <= FA_FWD_LSE_TOL, (label, dtype, lse_err)
    assert out_err <= LM_TOL[dtype], (label, dtype, out_err)
    if dtype == torch.bfloat16:
        check_bwd_repeats(got, q, k, v, out, do, lse, causal, label)
    return abs_err, out_err


def check_bwd_repeats(got, q, k, v, out, do, lse, causal, label):
    """Two more calls of the bfloat16 backward on the same tensors: dQ
    (its pieces added in ascending key-block order), dK and dV (summed in
    registers in a fixed order) bit for bit the first call's ``got``."""
    from repro_torch.kernels import flash_attention as fa

    calls = [got] + [fa.flash_attention_bwd(q, k, v, out, do, lse,
                                            causal=causal) for _ in range(2)]
    torch.cuda.synchronize()
    same = [[bool(torch.equal(a, b)) for a, b in zip(calls[0], again)]
            for again in calls[1:]]
    print(f"flash_attention_bwd {label} bf16 three calls: dq, dk, dv of the "
          f"second and third bit for bit the first's {same}")
    assert all(all(s) for s in same), (label, same)


def check_kernels_refuse_grad(device):
    """Kernels 1-5 and 8 raise on the card under grad mode when an input
    requires grad, instead of returning an output cut off from the graph;
    kernel 6 under grad returns outputs that carry its backward: one
    launch of the training forward and one of ``mamba_scan_bwd``, the
    gradients those of autograd through ``mamba_scan_plain``."""
    from repro_torch.kernels import mamba_scan as ms, ops

    cfg, state, params, pods = make_case(300, 4, device, SEED)
    live = {k: p.clone().requires_grad_() for k, p in params.items()}
    cols = tuple(torch.rand(64, device=device) for _ in range(6))
    deltas = torch.rand((2, 6), device=device)
    q = torch.randn((2, 4, 64), device=device, requires_grad=True)
    kv = torch.randn((2, 2, 32, 64), device=device)
    s = 32
    scan = [torch.randn((1, s, 8), device=device, requires_grad=True),
            torch.rand((1, s, 8), device=device),
            -torch.rand((8, 4), device=device), torch.randn((1, s, 4),
                                                            device=device),
            torch.randn((1, s, 4), device=device), torch.ones(8, device=device),
            torch.zeros((1, 8, 4), device=device)]
    calls = {
        "sdqn_score_afterstate": lambda: ops.sdqn_score_afterstate(
            state, pods, cfg, live),
        "sdqn_score_afterstate_topk": lambda: ops.sdqn_topk_afterstate(
            state, pods, cfg, live, k=4),
        "sdqn_score": lambda: ops.sdqn_score(torch.rand((64, 6),
                                                        device=device), live),
        "sdqn_score_cols": lambda: ops.sdqn_score_delta(cols, deltas, live),
        "sdqn_score_cols_topk": lambda: ops.sdqn_topk_delta(cols, deltas, live,
                                                            k=4),
        "decode_attention": lambda: ops.decode_attention(q, kv, kv, 32),
    }
    before = read_counts()
    for key, call in calls.items():
        try:
            call()
        except ValueError as e:
            print(f"no backward: {key} under grad raises "
                  f"{type(e).__name__}: {str(e)[:100]}")
        else:
            raise AssertionError(f"{key} ran under grad with an input that "
                                 f"requires grad")
    assert read_counts() == before, "a refused call launched"
    y, h_t = ops.mamba_scan(*scan)
    (y.square().sum() + h_t.sum()).backward()
    after = read_counts()
    live = scan[0].detach().clone().requires_grad_()
    wy, wh = ms.mamba_scan_plain(live, *scan[1:])
    (wy.square().sum() + wh.sum()).backward()
    err = _rel_err(scan[0].grad, live.grad)
    print(f"mamba_scan under grad: dx through kernel 6's backward vs autograd "
          f"of the plain version, relative to the largest {err}; launches "
          f"mamba_scan +{after['mamba_scan'] - before['mamba_scan']}, "
          f"mamba_scan_bwd +{after['mamba_scan_bwd'] - before['mamba_scan_bwd']}")
    assert err <= SCAN_BWD_TOL, err
    assert after["mamba_scan"] - before["mamba_scan"] == 1, after
    assert after["mamba_scan_bwd"] - before["mamba_scan_bwd"] == 1, after


def _train_spy(steps_mod, times, profiles):
    """A ``make_train_step`` that times every step (synchronized) and
    profiles steps ``TRAIN_PROFILED``."""
    from torch.profiler import ProfilerActivity, profile

    orig = steps_mod.make_train_step

    def make(*args, **kwargs):
        step, adam_cfg = orig(*args, **kwargs)

        def run(params, opt_state, batch):
            i = len(times)
            if i == TRAIN_PROFILED[0]:
                profiles["prof"] = profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA])
                profiles["prof"].__enter__()
                profiles["t0"] = time.perf_counter()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(params, opt_state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if i == TRAIN_PROFILED[-1]:
                profiles["wall"] = time.perf_counter() - profiles["t0"]
                profiles["prof"].__exit__(None, None, None)
            return out

        return run, adam_cfg

    return orig, make


def _train_main(argv):
    """``launch.train.main(argv)`` with every step timed (synchronized) and
    steps ``TRAIN_PROFILED`` profiled, the launch counts zeroed just before
    and read just after, the plain versions' calls counted:
    ``(losses, counts, step seconds, profiles, wall s, peak bytes)``."""
    from repro_torch.launch import steps as steps_mod, train

    times, profiles = [], {}
    orig, spy = _train_spy(steps_mod, times, profiles)
    steps_mod.make_train_step = spy
    torch.cuda.reset_peak_memory_stats()
    try:
        with _PlainSpy() as plain:
            t0 = time.perf_counter()
            zero_counts()                                  # the path starts here
            losses = train.main(argv)
            torch.cuda.synchronize()
            counts = read_counts()                         # ... and ends here
            wall = time.perf_counter() - t0
    finally:
        steps_mod.make_train_step = orig
    assert plain.calls == 0, plain.calls
    return (losses, counts, times, profiles, wall,
            torch.cuda.max_memory_allocated())


def _train_path():
    """``launch.train.main`` with OLMo-1B at full width and depth:
    ``TRAIN_STEPS`` steps of 8 x 512 tokens, bf16 weights, ``default_adam``,
    a checkpoint under the ignored ``build/``."""
    import shutil

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.roofline import HW, cell_flops

    ckpt = ROOT / "build" / "lm_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    losses, counts, times, profiles, wall, peak = _train_main(
        TRAIN_ARGS + ["--ckpt-dir", str(ckpt)])
    cfg = get_config("olmo-1b")
    layers, micro = cfg.num_layers, 1
    want = layers * micro * TRAIN_STEPS
    runs = remat_runs(cfg)
    print(f"LM training olmo-1b (remat={cfg.remat!r}) launches: {counts}")
    assert counts["flash_attention"] == runs * want, (runs, counts)
    assert counts["flash_attention_bwd"] == want, counts
    assert sum(counts.values()) == (runs + 1) * want, counts
    assert len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), losses
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    assert last < first, (first, last)
    step_s = statistics.median(times[TRAIN_MEDIAN_FROM:])
    tokens = 8 * 512
    model_flops = cell_flops(cfg, ShapeConfig("train", 512, 8,
                                              "train"))["model_flops"]
    print(f"LM training olmo-1b (16 layers, d_model 2048, vocab 50304, "
          f"{cfg.param_count()} parameters, bf16 weights, float32 master and "
          f"moments, remat={cfg.remat!r}), batch 8 x 512, {TRAIN_STEPS} "
          f"steps through "
          f"launch.train.main: ms_per_step={1e3 * step_s} (median of steps "
          f"{TRAIN_MEDIAN_FROM}-{TRAIN_STEPS - 1}, synchronized) "
          f"tokens_per_s={tokens / step_s} mfu={model_flops / (step_s * HW.peak_flops)} "
          f"(model_flops {model_flops} = 6 N D over the step and {HW.peak_flops} "
          f"FLOP/s) first_step_ms={1e3 * times[0]} peak_memory_gb={peak / 1e9} "
          f"loss first-10 mean {first} -> last-10 mean {last} wall_s={wall} "
          f"(init, steps, the final 16.5 GB checkpoint)")
    report = profile_report(profiles["prof"], profiles["wall"],
                            len(TRAIN_PROFILED), "LM training olmo-1b",
                            top=10)
    shutil.rmtree(ckpt, ignore_errors=True)
    return counts, dict(ms_per_step=1e3 * step_s, tokens_per_s=tokens / step_s,
                        mfu=model_flops / (step_s * HW.peak_flops),
                        peak_memory_gb=peak / 1e9, loss_first10=first,
                        loss_last10=last, device_ops_per_step=report)


def _resume_check():
    """``--fail-at`` exits 17; a rerun resumes from the last checkpoint and
    its losses match the uninterrupted run's within ``RESUME_TOL``."""
    import shutil

    from repro_torch.launch import train

    base = ROOT / "build" / "lm_resume"
    shutil.rmtree(base, ignore_errors=True)
    full = train.main(RESUME_ARGS + ["--ckpt-dir", str(base / "a")])
    try:
        train.main(RESUME_ARGS + ["--ckpt-dir", str(base / "b"), "--fail-at",
                                  str(RESUME_FAIL_AT)])
    except SystemExit as e:
        assert e.code == 17, e.code
    else:
        raise AssertionError("--fail-at did not exit")
    rest = train.main(RESUME_ARGS + ["--ckpt-dir", str(base / "b")])
    start = len(full) - len(rest)
    rel = float(np.max(np.abs(np.array(rest) - np.array(full[start:]))
                       / np.abs(np.array(full[start:]))))
    print(f"LM training resume: --fail-at {RESUME_FAIL_AT} exited 17; the "
          f"rerun resumed at step {start} and ran steps {start}-"
          f"{len(full) - 1}; losses vs the uninterrupted run: max relative "
          f"difference {rel}")
    assert start <= 13 and rel <= RESUME_TOL, (start, rel)
    shutil.rmtree(base, ignore_errors=True)


def _plain_step_check(device, arch="olmo-1b"):
    """``arch`` at full width cut to ``TRAIN_PLAIN_LAYERS`` layers in
    float32: one ``make_train_step`` step and its gradients through the
    kernels (kernel 7 and its backward, or for the ssm family kernel 6 and
    its backward) and through ``attn_mode="plain"``, from the same params
    and batch."""
    from repro_torch.configs.base import get_config
    from repro_torch.data import synthetic_batches
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.serve import seed_generator
    from repro_torch.optim import tree_leaves

    cfg = dataclasses.replace(get_config(arch),
                              num_layers=TRAIN_PLAIN_LAYERS, dtype="float32",
                              param_dtype="float32")
    params, opt = steps_mod.init_train_state(seed_generator(SEED, 0, device),
                                             cfg, device=device)
    batch = {k: x.to(device) for k, x in next(synthetic_batches(
        SEED, 8, 512, cfg.vocab_size)).items()}
    runs = {}
    for mode in ("cuda", "plain"):
        zero_counts()
        metrics, grads = steps_mod.value_and_grad(cfg, params, batch,
                                                  attn_mode=mode)
        step, _ = steps_mod.make_train_step(cfg, attn_mode=mode)
        new, _, step_metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        runs[mode] = (metrics, grads, new, step_metrics, read_counts())
    kernel, plain = runs["cuda"], runs["plain"]
    want = 2 * TRAIN_PLAIN_LAYERS                   # value_and_grad and step
    fwd, bwd = (("mamba_scan", "mamba_scan_bwd") if cfg.family == "ssm"
                else ("flash_attention", "flash_attention_bwd"))
    n = remat_runs(cfg)                    # the recompute inside the backward
    assert (kernel[4][fwd], kernel[4][bwd]) == (n * want, want), kernel[4]
    assert sum(kernel[4].values()) == (n + 1) * want, kernel[4]
    assert not any(plain[4].values()), plain[4]
    loss_err = abs(float(kernel[0]["loss"]) - float(plain[0]["loss"]))
    grad_err = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(tree_leaves(kernel[1]),
                                   tree_leaves(plain[1])))
    param_err = max(float((a - b).abs().max())
                    for a, b in zip(tree_leaves(kernel[2]),
                                    tree_leaves(plain[2])))
    print(f"LM training kernels vs plain ({arch} width, {TRAIN_PLAIN_LAYERS} "
          f"layers, float32, 8 x 512, remat={cfg.remat!r}): loss {float(kernel[0]['loss'])} vs "
          f"{float(plain[0]['loss'])} (diff {loss_err}); gradient leaves max "
          f"relative diff {grad_err}; params after one step max_abs_diff "
          f"{param_err}")
    assert loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL, (
        loss_err, grad_err)
    assert param_err <= TRAIN_LOSS_TOL, param_err
    del runs, params, opt, kernel, plain
    torch.cuda.empty_cache()


def _whisper_train(device):
    """whisper-medium at full width, 2 encoder and 2 decoder layers, 3
    train steps: kernel 7 and its backward non-causal (the encoder over
    1,500 frames, cross-attention against them) and causal, at D = 64."""
    from repro_torch.configs.base import get_config
    from repro_torch.data import synthetic_batches
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.serve import seed_generator

    w = WHISPER_TRAIN
    cfg = dataclasses.replace(get_config("whisper-medium"),
                              num_layers=w["layers"], enc_layers=w["layers"])
    params, opt = steps_mod.init_train_state(seed_generator(SEED, 0, device),
                                             cfg, device=device)
    step, _ = steps_mod.make_train_step(cfg, total_steps=w["steps"])
    data = synthetic_batches(SEED, w["batch"], w["seq"], cfg.vocab_size,
                             cfg=cfg)
    losses = []
    with _PlainSpy() as plain:
        zero_counts()                                  # the path starts here
        for _ in range(w["steps"]):
            batch = {k: x.to(device) for k, x in next(data).items()}
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))
        counts = read_counts()                         # ... and ends here
    want = w["steps"] * 3 * w["layers"]         # encoder, self, cross
    runs = remat_runs(cfg)
    print(f"LM training whisper-medium (full width, {w['layers']} + "
          f"{w['layers']} layers, {w['batch']} x {w['seq']} tokens, 1,500 "
          f"frames, remat={cfg.remat!r}): losses {losses}; launches {counts}")
    assert plain.calls == 0 and all(np.isfinite(losses)), losses
    assert counts["flash_attention"] == runs * want, (runs, counts)
    assert counts["flash_attention_bwd"] == want, counts
    assert sum(counts.values()) == (runs + 1) * want, counts
    del params, opt
    torch.cuda.empty_cache()
    return counts


def _ssm_train_path():
    """``launch.train.main`` with falcon-mamba-7b at its published widths
    cut to ``SSM_TRAIN_LAYERS`` layers: ``SSM_TRAIN_STEPS`` steps of 8 x
    512 tokens, bf16 weights, ``default_adam``, no checkpoint."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.roofline import HW, cell_flops

    losses, counts, times, profiles, wall, peak = _train_main(SSM_TRAIN_ARGS)
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"),
                              num_layers=SSM_TRAIN_LAYERS)
    want = SSM_TRAIN_LAYERS * SSM_TRAIN_STEPS
    runs = remat_runs(cfg)
    print(f"LM training falcon-mamba-7b (remat={cfg.remat!r}) launches: "
          f"{counts}")
    assert counts["mamba_scan"] == runs * want, (runs, counts)
    assert counts["mamba_scan_bwd"] == want, counts
    assert sum(counts.values()) == (runs + 1) * want, counts  # no attention
    assert len(losses) == SSM_TRAIN_STEPS and all(np.isfinite(losses)), losses
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    assert last < first, (first, last)
    step_s = statistics.median(times[TRAIN_MEDIAN_FROM:])
    tokens = 8 * 512
    model_flops = cell_flops(cfg, ShapeConfig("train", 512, 8,
                                              "train"))["model_flops"]
    mfu = model_flops / (step_s * HW.peak_flops)
    print(f"LM training falcon-mamba-7b ({SSM_TRAIN_LAYERS} of 64 layers, "
          f"d_model 4096, d_inner 8192, N 16, vocab 65024, "
          f"{cfg.param_count()} parameters, bf16 weights, float32 master and "
          f"moments, remat={cfg.remat!r}), batch 8 x 512, {SSM_TRAIN_STEPS} "
          f"steps through "
          f"launch.train.main: ms_per_step={1e3 * step_s} (median of steps "
          f"{TRAIN_MEDIAN_FROM}-{SSM_TRAIN_STEPS - 1}, synchronized) "
          f"tokens_per_s={tokens / step_s} mfu={mfu} (model_flops "
          f"{model_flops} over the step and {HW.peak_flops} FLOP/s) "
          f"first_step_ms={1e3 * times[0]} peak_memory_gb={peak / 1e9} "
          f"loss first-10 mean {first} -> last-10 mean {last} wall_s={wall}")
    report = profile_report(profiles["prof"], profiles["wall"],
                            len(TRAIN_PROFILED), "LM training falcon-mamba-7b",
                            top=10)
    return counts, dict(ms_per_step=1e3 * step_s, tokens_per_s=tokens / step_s,
                        mfu=mfu, peak_memory_gb=peak / 1e9,
                        loss_first10=first, loss_last10=last,
                        device_ops_per_step=report)


def _jamba_train(device):
    """jamba-1.5-large-398b at its smoke widths with head width 64 (kernel
    7's backward's), ``JAMBA_TRAIN["steps"]`` train steps: kernel 6 and its
    backward in every mamba layer, kernel 7 and its backward in every
    attention layer, counted from ``block_spec``."""
    from repro_torch.configs.base import get_config
    from repro_torch.data import synthetic_batches
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.serve import seed_generator
    from repro_torch.models.model import block_spec, num_blocks

    j = JAMBA_TRAIN
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b", smoke=True),
                              head_dim=j["head_dim"])
    params, opt = steps_mod.init_train_state(seed_generator(SEED, 0, device),
                                             cfg, device=device)
    step, _ = steps_mod.make_train_step(cfg, total_steps=j["steps"])
    data = synthetic_batches(SEED, j["batch"], j["seq"], cfg.vocab_size)
    losses = []
    with _PlainSpy() as plain:
        zero_counts()                                  # the path starts here
        for _ in range(j["steps"]):
            batch = {k: x.to(device) for k, x in next(data).items()}
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))
        counts = read_counts()                         # ... and ends here
    spec, blocks = block_spec(cfg), num_blocks(cfg)
    mamba = j["steps"] * blocks * sum(s.mixer == "mamba" for s in spec)
    attn = j["steps"] * blocks * sum(s.mixer == "attn" for s in spec)
    runs = remat_runs(cfg)                       # the smoke config's "none"
    print(f"LM training jamba-1.5-large-398b (smoke widths, head width "
          f"{j['head_dim']}, {cfg.num_layers} layers, {j['batch']} x "
          f"{j['seq']} tokens, remat={cfg.remat!r}): losses {losses}; "
          f"launches {counts}")
    assert plain.calls == 0 and all(np.isfinite(losses)), losses
    assert counts["mamba_scan"] == runs * mamba, counts
    assert counts["flash_attention"] == runs * attn, counts
    assert counts["mamba_scan_bwd"] == mamba, counts
    assert counts["flash_attention_bwd"] == attn, counts
    assert sum(counts.values()) == (runs + 1) * (mamba + attn), counts
    del params, opt
    torch.cuda.empty_cache()
    return counts


# rematerialization (``cfg.remat``): short runs of each setting through
# ``steps.make_train_step``, one turn each ("full" first), at phase 22's
# widths and 8 x 512 tokens
REMAT_SETTINGS = ("none", "dots", "full")
REMAT_TURNS = ("full", "none", "dots")
REMAT_STEPS = 9
REMAT_TIMED = (2, 7)                  # ms a step: median of steps 2-6
REMAT_PROFILED = (7, 8)               # then two steps under torch.profiler
                                      # (a setting's first turn only)
# each setting's backward peak on the card against the dry run's plan of it
REMAT_PLAN_TOL = 0.05
# the products with no batch dimensions a layer's forward reaches on the
# card (every one ``aten.mm``): OLMo-1B q, k, v, o, gate, up, down;
# falcon-mamba-7b in, x, dt, out
REMAT_PROJECTIONS = {"olmo-1b": 7, "falcon-mamba-7b": 4}


def remat_runs(cfg) -> int:
    """How often a training step launches each forward kernel for one
    launch of its backward: twice where the config rematerializes (the
    block runs again inside the backward), else once."""
    from repro_torch.models import model as mdl

    return 1 if mdl._remat_policy(cfg) is None else 2


class _RecomputeSpy:
    """Every launch of kernel 7's and kernel 6's forward while entered: the
    thread it ran on and a copy of its outputs, in order."""

    def __init__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import mamba_scan as ms

        self.calls = []
        self._modules = (fa, ms)
        self._real = [m._launch_forward for m in self._modules]

    def __enter__(self):
        import threading

        for module, real in zip(self._modules, self._real):
            def spy(*args, _real=real, **kwargs):
                outs = _real(*args, **kwargs)
                torch.cuda.synchronize()
                self.calls.append((threading.get_ident(), [
                    None if t is None else t.clone() for t in outs]))
                return outs
            module._launch_forward = spy
        return self

    def __exit__(self, *exc):
        for module, real in zip(self._modules, self._real):
            module._launch_forward = real


def _product_ops(cfg, params, batch):
    """{aten op: calls} of the products a training forward (under grad,
    no checkpoint) reaches on the card."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import model as mdl

    names = ("mm", "addmm", "bmm", "baddbmm", "addbmm", "mv", "addmv", "dot",
             "convolution", "_scaled_mm")
    seen = {}

    class Products(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.__name__.split(".")[0] in names:
                seen[str(func)] = seen.get(str(func), 0) + 1
            return func(*args, **(kwargs or {}))

    live = steps_mod.tree_map(lambda p: p.detach().requires_grad_(True),
                              steps_mod._split_blocks(params))
    with torch.enable_grad(), Products():
        out = mdl.forward(live, dataclasses.replace(cfg, remat="none"),
                          batch["tokens"], batch, mode="train")
    del out, live
    return seen


def start_remat_plans():
    """``scripts/remat_plans.py --backward`` in a process of its own, so
    that its fake-tensor traces on the CPU run beside the card's work
    until ``remat_plans`` reads them."""
    return subprocess.Popen([sys.executable, str(ROOT / "scripts" /
                                                 "remat_plans.py"),
                             "--backward"], stdout=subprocess.PIPE, text=True)


def remat_plans(proc):
    """{(arch, remat): planned backward peak bytes} from
    ``start_remat_plans``' process, waited for."""
    out, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, proc.returncode
    return {(r["arch"], r["remat"]): r["backward_peak_bytes"]
            for r in (json.loads(line) for line in out.splitlines()
                      if line.startswith("{"))}


def _remat_grads(base, params, batch, arch, planned):
    """``value_and_grad`` at one fixed batch under "none" twice, "full" and
    "dots": each call's own peak (above what was allocated before it)
    within ``REMAT_PLAN_TOL`` of ``planned``, the dry run's plan of it on
    fake tensors; then "full" once more under ``_RecomputeSpy``, whose
    copies of every forward launch's outputs the peaks above leave out:
    kernel 7's or 6's forward launched again on autograd's device thread,
    each recompute's outputs bit for bit its first launch's.  Every call's
    gradients bit for bit the first "none" call's."""
    import threading

    from repro_torch.launch import steps as steps_mod

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return [x for k, v in tree.items() for x in flat(v, f"{prefix}/{k}")]
        return [(prefix, tree)]

    want, differ, peaks = None, {}, {}
    for key in ("none", "none again", "full", "dots", "full, spied"):
        cfg = dataclasses.replace(base, remat=key.split()[0].rstrip(","))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        spied = key == "full, spied"
        spy = _RecomputeSpy() if spied else contextlib.nullcontext()
        with spy:
            _, grads = steps_mod.value_and_grad(cfg, params, batch)
        torch.cuda.synchronize()
        if spied:
            calls = spy.calls
        else:
            peaks[key] = torch.cuda.max_memory_allocated() - before
        if want is None:
            want = dict(flat(grads))
        else:
            differ[key] = sorted(path for path, g in flat(grads)
                                 if not torch.equal(g, want[path]))
        del grads
    layers = base.num_layers
    main = threading.get_ident()
    assert [c[0] == main for c in calls] == [True] * layers + [False] * layers
    for i in range(layers):                # the recompute runs last to first
        first, again = calls[i][1], calls[2 * layers - 1 - i][1]
        assert all((a is None and b is None) or torch.equal(a, b)
                   for a, b in zip(first, again)), (arch, i)
    del calls
    plan = {key: planned[arch, key.split()[0]] for key in peaks}
    ratio = {key: peaks[key] / plan[key] for key in peaks}
    print(f"remat gradients {arch} ({layers} layers, 8 x 512, one batch): "
          f"leaves that differ from the first 'none' call's "
          f"{ {k: len(v) for k, v in differ.items()} } of {len(want)} (first "
          f"few { {k: v[:4] for k, v in differ.items()} }); value_and_grad's "
          f"own peak GB { {k: v / 1e9 for k, v in peaks.items()} } against "
          f"the dry run's plan GB { {k: v / 1e9 for k, v in plan.items()} }: "
          f"measured/plan {ratio} (tolerance {REMAT_PLAN_TOL}); recompute of "
          f"kernel {'6' if base.family == 'ssm' else '7'}: {layers} launches "
          f"on autograd's device thread, each output bit for bit its first "
          f"launch's")
    del want
    assert not any(differ.values()), differ
    assert all(abs(r - 1) <= REMAT_PLAN_TOL for r in ratio.values()), ratio
    figures = {f"value_and_grad_peak_gb_{k.replace(' ', '_')}": v / 1e9
               for k, v in peaks.items()}
    figures.update({f"planned_peak_gb_{k}": v / 1e9
                    for k, v in plan.items() if k in REMAT_SETTINGS})
    figures["measured_over_plan"] = ratio
    figures["leaves_differing"] = {k: len(v) for k, v in differ.items()}
    torch.cuda.empty_cache()
    return figures


def _remat_turns(device, name, arch, planned, layers=0):
    """``arch`` at its published widths (cut to ``layers``), 8 x 512
    tokens: the aten products its forward reaches, ``_remat_grads``
    (against ``planned``, ``remat_plans``'), then
    ``REMAT_STEPS`` steps of ``make_train_step`` a turn of
    ``REMAT_TURNS``, every launch counted (the forward kernel twice a
    backward launch under "full" and "dots"), from the same params, state
    and batches each turn: ms a step, tokens/s, MFU on 6 N D, the share of
    ``cell_flops``' hlo FLOPs (the re-forward counted under "full", as the
    reference's dry run counts it), peak memory (the turn's state beside
    the kept first params and state), and in a setting's first turn the
    device's busy share over ``REMAT_PROFILED``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data import synthetic_batches
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.serve import seed_generator
    from repro_torch.roofline import HW, cell_flops

    base = get_config(arch)
    if layers:
        base = dataclasses.replace(base, num_layers=layers)
    fwd, bwd = (("mamba_scan", "mamba_scan_bwd") if base.family == "ssm"
                else ("flash_attention", "flash_attention_bwd"))
    params, opt = steps_mod.init_train_state(seed_generator(SEED, 0, device),
                                             base, device=device)
    data = synthetic_batches(SEED, 8, 512, base.vocab_size)
    batches = [{k: x.to(device) for k, x in next(data).items()}
               for _ in range(REMAT_STEPS)]
    ops = _product_ops(base, params, batches[0])
    print(f"remat {arch}: the products a training forward reaches on the "
          f"card ({base.num_layers} layers): {ops}")
    assert ops == {"aten.mm.default":
                   REMAT_PROJECTIONS[arch] * base.num_layers}, ops
    figures = {"grads": _remat_grads(base, params, batches[0], arch,
                                     planned)}
    shape = ShapeConfig("train", 512, 8, "train")
    tokens = 8 * 512
    runs, totals = {r: [] for r in REMAT_SETTINGS}, {}
    for remat in REMAT_TURNS:
        cfg = dataclasses.replace(base, remat=remat)
        step, _ = steps_mod.make_train_step(cfg, total_steps=REMAT_STEPS)
        p, o, times, losses = params, opt, [], []
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        prof = (None if runs[remat] else
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]))
        with _PlainSpy() as plain:
            zero_counts()                              # the path starts here
            for i, batch in enumerate(batches):
                if i == REMAT_PROFILED[0] and prof is not None:
                    prof.__enter__()
                    wall = time.perf_counter()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p, o, metrics = step(p, o, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(float(metrics["loss"]))
            if prof is not None:
                wall = time.perf_counter() - wall
                prof.__exit__(None, None, None)
            counts = read_counts()                     # ... and ends here
        peak = torch.cuda.max_memory_allocated()
        del p, o, metrics
        ops_per_step = prof and profile_report(
            prof, wall, len(REMAT_PROFILED), f"remat {arch} {remat!r}", top=4)
        n = remat_runs(cfg)
        want = base.num_layers * REMAT_STEPS
        assert plain.calls == 0 and all(np.isfinite(losses)), losses
        assert (counts[fwd], counts[bwd]) == (n * want, want), counts
        assert sum(counts.values()) == (n + 1) * want, counts
        step_s = statistics.median(times[slice(*REMAT_TIMED)])
        flops = cell_flops(cfg, shape, remat_full=cfg.remat == "full")
        row = dict(ms_per_step=1e3 * step_s, tokens_per_s=tokens / step_s,
                   mfu=flops["model_flops"] / (step_s * HW.peak_flops),
                   hlo_flops_share=flops["hlo_flops"] / (step_s
                                                        * HW.peak_flops),
                   peak_memory_gb=peak / 1e9, launches=counts,
                   device_ops_per_step=ops_per_step, last_loss=losses[-1])
        runs[remat].append(row)
        for key in counts:
            totals[key] = totals.get(key, 0) + counts[key]
        print(f"remat turn {arch} remat={remat!r} ({base.num_layers} layers, "
              f"8 x 512, {REMAT_STEPS} steps through make_train_step): "
              f"ms_per_step={row['ms_per_step']} (median of steps "
              f"{REMAT_TIMED[0]}-{REMAT_TIMED[1] - 1}) tokens_per_s="
              f"{row['tokens_per_s']} mfu={row['mfu']} (6 N D) "
              f"hlo_flops_share={row['hlo_flops_share']} (cell_flops' hlo "
              f"FLOPs, remat_full={cfg.remat == 'full'}) peak_memory_gb="
              f"{row['peak_memory_gb']} launches {fwd} {counts[fwd]} {bwd} "
              f"{counts[bwd]} last loss {losses[-1]}; {name}")
    figures["turns"] = runs
    for remat, rows in runs.items():
        ms = [r["ms_per_step"] for r in rows]
        print(f"remat {arch} remat={remat!r}: ms_per_step {ms} (mean "
              f"{statistics.mean(ms)}), mfu "
              f"{[r['mfu'] for r in rows]}, hlo_flops_share "
              f"{[r['hlo_flops_share'] for r in rows]}, peak_memory_gb "
              f"{[r['peak_memory_gb'] for r in rows]}")
    del params, opt, batches
    torch.cuda.empty_cache()
    return totals, figures


def check_scan_bwd_kernels(device):
    """Kernel 6's training forward and its backward against the plain
    twins on the same CUDA tensors at ``SCAN_BWD_SHAPES``: y bit for bit
    the serving launch's, y, hT and the chunk states within ``SCAN_TOL``
    of ``mamba_scan_plain(..., return_states=True)``, the seven gradients
    (with dhT and without) within ``SCAN_BWD_TOL`` of each gradient's
    largest element; each backward twice, bit for bit.  Returns the
    largest absolute gradient error."""
    from repro_torch.kernels import mamba_scan as ms

    worst = 0.0
    for shape in SCAN_BWD_SHAPES:
        b, s, di, n = shape
        args = _scan_args(shape, device, SEED + s)
        serve_y, serve_h = ms.mamba_scan(*args)
        y, h_t, states = ms.mamba_scan_fwd(*args)
        py, ph, pst = ms.mamba_scan_plain(*args, return_states=True)
        fwd_err = max(float((u - v).abs().max()) for u, v in
                      ((y, py), (h_t, ph), (states, pst)))
        same = torch.equal(y, serve_y) and torch.equal(h_t, serve_h)
        print(f"mamba_scan training forward {shape}: y, hT bit for bit the "
              f"serving launch's {same}; y, hT, chunk states {tuple(states.shape)}"
              f" vs plain max_abs_err {fwd_err}")
        assert same and fwd_err <= SCAN_TOL, (shape, same, fwd_err)
        gen = torch.Generator(device=device).manual_seed(SEED + s)
        dy = torch.randn((b, s, di), generator=gen, device=device)
        dht = torch.randn((b, di, n), generator=gen, device=device) * 0.5
        for dh in (dht, None):
            got = ms.mamba_scan_bwd(*args[:6], states, dy, dh)
            again = ms.mamba_scan_bwd(*args[:6], states, dy, dh)
            torch.cuda.synchronize()
            want = ms.mamba_scan_bwd_plain(*args[:6], states, dy, dh)
            rel = [_rel_err(g, w) for g, w in zip(got, want)]
            repeat = all(torch.equal(g, h) for g, h in zip(got, again))
            worst = max([worst] + [float((g - w).abs().max())
                                   for g, w in zip(got, want)])
            print(f"mamba_scan_bwd {shape} dhT {'given' if dh is not None else 'absent'}: "
                  f"dx, ddt, dA, dB, dC, dD, dh0 relative to the largest vs "
                  f"plain {rel}; twice bit for bit {repeat}")
            assert max(rel) <= SCAN_BWD_TOL and repeat, (shape, rel, repeat)
        del args, dy, dht, states, got, again, want
    torch.cuda.empty_cache()
    return worst


def scan_bwd_bound(shape, name, chunk):
    """(ms, by, bytes, ops, terms) of one backward call in training (dhT
    absent, no dh0): x, dt, dy, B, C, A, D and the chunk states read once,
    dx, ddt, dB, dC, dA, dD written once at the memory rate; the float32
    operations at the float32 peak; one exponential a (batch, step,
    channel, state) at ``sfu_rate`` (dA is recomputed, not stored)."""
    b, s, di, n = shape
    nbytes = 4 * (5 * b * s * di + 4 * b * s * n + b * -(-s // chunk) * di * n
                  + 2 * di * n + 2 * di)
    ops = b * s * di * (n * SCAN_BWD_OPS_PER_STATE + SCAN_BWD_OPS_PER_CHANNEL)
    _, (flops, bw) = peaks(name)
    terms = {"bytes": nbytes / bw * 1e3, "operations": ops / flops * 1e3,
             "exponentials": b * s * di * n / sfu_rate() * 1e3}
    by = max(terms, key=terms.get)
    return (terms[by], "bytes" if by == "bytes" else "operations", nbytes,
            ops, terms)


def scan_train_timings(device, name):
    """Kernel 6's backward at ``SCAN_BWD_TIMED`` (device time from a CUDA
    graph, two device kernels a call), its plain twin, its bound, the two
    kernels' split (profiler); and the training forward (chunk states
    written) against the serving launch at falcon-mamba-7b's shape, in
    turns (null, states, states, null)."""
    from repro_torch.kernels import mamba_scan as ms

    saved = read_counts()
    rows = {}
    for shape in SCAN_BWD_TIMED:
        b, s, di, n = shape
        args = _scan_args(shape, device, SEED + 26)
        _, _, states = ms.mamba_scan_fwd(*args)
        dy = torch.randn((b, s, di), device=device)
        call = lambda: ms.mamba_scan_bwd(  # noqa: E731
            *args[:6], states, dy, None, need_dh0=False)
        names = device_kernels(call)
        assert len(names) == 2 and all("mamba_scan_bwd" in k
                                       for k in names), names
        got = call()
        want = ms.mamba_scan_bwd_plain(*args[:6], states, dy, None,
                                       need_dh0=False)
        err = max(float((g - w).abs().max()) for g, w in zip(got[:6],
                                                             want[:6]))
        kernel_ms = graph_time_ms(call, 10)
        split = {key[:32]: us for key, us in device_split_us(call).items()}
        plain_ms = graph_time_ms(lambda: ms.mamba_scan_bwd_plain(
            *args[:6], states, dy, None, need_dh0=False), 1, reps=2)
        plan = ms.scan_bwd_plan(b, di, n)
        b_ms, b_by, nbytes, n_ops, terms = scan_bwd_bound(shape, name,
                                                          plan.chunk)
        label = ("falcon-mamba-7b training" if shape == SCAN_FALCON
                 else f"{shape}")
        rows[shape] = dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=None, shape=list(shape),
                           bound_terms_ms=terms, kernels_us=split,
                           max_abs_err=err, plan=dataclasses.asdict(plan),
                           blocks_per_sm=ms.scan_bwd_occupancy(plan),
                           partial_bytes=2 * 4 * int(np.prod(plan.partials(s))),
                           path=label)
        print(f"timing mamba_scan_bwd {label} (B, S, di, N)={shape}: "
              f"kernel_ms={kernel_ms} (2 device kernels: "
              f"{[k[:40] for k in names]}) plain_ms={plain_ms} bound_ms={b_ms} "
              f"({b_by}; bytes={nbytes} ops={n_ops}; terms_ms {terms}) "
              f"kernel/bound={kernel_ms / b_ms} device kernels us a call "
              f"(profiler) {split} max_abs_err vs plain {err} plan {plan} "
              f"blocks={plan.blocks} shared_bytes={plan.shared_bytes} "
              f"blocks_per_sm={rows[shape]['blocks_per_sm']} "
              f"partial_bytes={rows[shape]['partial_bytes']}")
        if shape == SCAN_FALCON:    # two blocks an SM, a quarter of the
            row = rows[shape]       # partials of a block for 8 channels
            assert row["blocks_per_sm"] >= 2, row
            assert row["partial_bytes"] <= SCAN_BWD_MAX_PARTIALS, row
        del args, states, dy, got, want
    args = _scan_args(SCAN_FALCON, device, SEED + 27)
    null = lambda: ms.mamba_scan(*args)               # noqa: E731
    with_states = lambda: ms.mamba_scan_fwd(*args)    # noqa: E731
    turns = [graph_time_ms(fn, 20) for fn in (null, with_states, with_states,
                                               null)]
    b_ms, b_by, nbytes, _ = scan_bound(SCAN_FALCON, name)
    b, s, di, n = SCAN_FALCON
    chunks = ms.scan_plan(b, di, n).chunks(s)
    bytes_ms = (nbytes + 4 * b * chunks * di * n) / peaks(name)[1][1] * 1e3
    rows["forward_states"] = dict(
        ms=statistics.mean(turns[1:3]), null_states_ms=[turns[0], turns[3]],
        plain_ms=graph_time_ms(lambda: ms.mamba_scan_plain(
            *args, return_states=True), 1, reps=2),
        bound_ms=max(b_ms, bytes_ms),
        bound_by="bytes" if bytes_ms >= b_ms else b_by,
        shape=list(SCAN_FALCON),
        path="LM training forward (chunk states stored)")
    print(f"timing mamba_scan LM training forward {SCAN_FALCON} with the "
          f"chunk states ({chunks} chunks), in turns null / states / states "
          f"/ null: {turns} ms (states/null = "
          f"{(turns[1] + turns[2]) / (turns[0] + turns[3])})")
    del args
    for key, fn in wrappers().items():          # timing launches don't count
        fn.launches = saved[key]
    torch.cuda.empty_cache()
    return rows


def attention_bwd_bound(b, hq, hkv, sq, skv, d, pairs, itemsize, name):
    """(ms, by, bytes, ops, terms) of one backward call: q, o, dO, k, v and
    lse read once and dq, dk, dv written once at the memory rate; the five
    products (S, dP, dV, dK, dQ: 2 D operations a visible pair each) at the
    tensor-core bf16 rate (bfloat16) or the float32 rate (the float32
    kernels run on FMAs); one exponential a visible pair at the SFU rate;
    dS = P (dP - Delta) and the scale, 3 float32 operations a pair."""
    nbytes = (itemsize * 4 * b * sq * hq * d + itemsize * 4 * b * skv * hkv * d
              + 4 * b * hq * sq)
    n = b * hq * pairs
    key, (f32_peak, bw) = peaks(name)
    peak = BF16_PEAK[key] if itemsize == 2 else f32_peak
    products = 5 * 2 * d * n
    terms = {"bytes": nbytes / bw * 1e3, "products": products / peak * 1e3,
             "exponentials": n / sfu_rate() * 1e3,
             "elementwise": 3 * n / f32_peak * 1e3}
    by = max(terms, key=terms.get)
    return (terms[by], "bytes" if by == "bytes" else "operations", nbytes,
            products + 4 * n, terms)


def _library_backward_ms(q, k, v, do, causal, iters=10):
    """``scaled_dot_product_attention``'s backward alone at these inputs:
    its forward runs once on a side stream, then ``iters`` backward calls
    (``torch.autograd.grad`` with the graph kept) are captured in a CUDA
    graph on that stream (autograd runs a backward on its forward's
    stream) and replayed between CUDA events."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = sdpa(qt, kt, vt, is_causal=causal,
                   enable_gqa=qt.shape[1] != kt.shape[1])
        for _ in range(3):
            torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
    return replay_ms(graph, iters)


def train_timings(device, name):
    """The backward at ``FA_BWD_TIMED`` shapes in bfloat16 (device time
    from a CUDA graph), its plain version, its bound and SDPA's backward
    (``library_ms``); and kernel 7's forward at OLMo-1B's training shape
    with the lse stored and without, in turns (null, lse, lse, null)."""
    from repro_torch.kernels import flash_attention as fa

    saved = read_counts()
    rows = {}
    for label in FA_BWD_TIMED:
        b, sq, skv, hq, hkv, d, causal = shape = FA_BWD_SHAPES[label]
        q, k, v, do = _bwd_case(shape, torch.bfloat16, device, SEED + 24)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        call = lambda: fa.flash_attention_bwd(  # noqa: E731
            q, k, v, out, do, lse, causal=causal)
        names = device_kernels(call)
        assert len(names) == 3 and all("fa_bwd" in n for n in names), names
        ms = graph_time_ms(call, 10)
        split = {key[:24]: us for key, us in device_split_us(call).items()}
        plain_ms = graph_time_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, out, do, lse, causal=causal), 2, reps=3)
        library_ms = _library_backward_ms(q, k, v, do, causal)
        pairs = causal_pairs(sq, skv) if causal else sq * skv
        b_ms, b_by, nbytes, n_ops, terms = attention_bwd_bound(
            b, hq, hkv, sq, skv, d, pairs, 2, name)
        rows[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=library_ms,
                           shape=list(shape), bound_terms_ms=terms,
                           kernels_us=split, path=label)
        print(f"timing flash_attention_bwd {label} (B, Sq, Skv, Hq, Hkv, D, "
              f"causal)={shape} bf16: kernel_ms={ms} (3 device kernels: "
              f"{[n[:40] for n in names]}) plain_ms={plain_ms} library_ms="
              f"{library_ms} (SDPA's backward alone, CUDA graph) bound_ms="
              f"{b_ms} ({b_by}; bytes={nbytes} ops={n_ops}; terms_ms "
              f"{terms}) kernel/bound={ms / b_ms} kernel/library="
              f"{ms / library_ms} device kernels us a call (profiler) "
              f"{split}")
        del q, k, v, do, out, lse
    b, sq, skv, hq, hkv, d, causal = FA_BWD_SHAPES["olmo_train"]
    q, k, v, _ = _bwd_case(FA_BWD_SHAPES["olmo_train"], torch.bfloat16,
                           device, SEED + 25)
    null = lambda: fa.flash_attention(q, k, v, causal=True)    # noqa: E731
    with_lse = lambda: fa.flash_attention_fwd(q, k, v, causal=True)  # noqa: E731
    turns = [graph_time_ms(fn, 20) for fn in (null, with_lse, with_lse, null)]
    b_ms, b_by, nbytes, n_ops, terms = attention_bound(
        b, hq, hkv, sq, skv, d, causal_pairs(sq, skv), 2, name)
    # the library's forward that returns the rows' lse: PyTorch's flash
    # attention op on (B, H, S, D), natural-log lse (B, H, S) float32
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = lambda: torch.ops.aten._scaled_dot_product_flash_attention(  # noqa: E731
        qt, kt, vt, 0.0, True)
    lib_lse_err = float((lib()[1] - with_lse()[1]).abs().max())
    rows["forward_lse"] = dict(
        ms=statistics.mean(turns[1:3]), null_lse_ms=[turns[0], turns[3]],
        plain_ms=graph_time_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=True, return_lse=True), 3, reps=3),
        bound_ms=b_ms + 4 * b * hq * sq / peaks(name)[1][1] * 1e3,
        bound_by=b_by, library_ms=graph_time_ms(lib, 20),
        library_kernel="aten._scaled_dot_product_flash_attention",
        shape=list(FA_BWD_SHAPES["olmo_train"][:6]),
        path="LM training forward (lse stored)")
    print(f"timing flash_attention LM training forward (8, 512, 16, 128) "
          f"bf16 causal, in turns null / lse / lse / null: {turns} ms "
          f"(lse/null = {(turns[1] + turns[2]) / (turns[0] + turns[3])}); "
          f"library_ms={rows['forward_lse']['library_ms']} "
          f"(aten._scaled_dot_product_flash_attention, lse returned, CUDA "
          f"graph; its lse against the kernel's max_abs_err {lib_lse_err})")
    del qt, kt, vt
    for key, fn in wrappers().items():          # timing launches don't count
        fn.launches = saved[key]
    return rows


def check_kernel7_bwd_build():
    """The backward's ten instances spill nothing: the float32 dQ and dK/dV
    kernels at D in {64, 128}, and the bfloat16 preprocess, main pass and
    postprocess at both; the bfloat16 main pass runs its products on
    wgmma (HGMMA) from TMA loads (UTMALDG) and adds dQ with bulk
    reduce-adds (UBLKRED).  (The forward's: ``check_kernel7_sass``.)"""
    import re

    counts = sass_counts("flash_attention_bwd")
    spills = ptxas_spills("flash_attention_bwd")
    kernels = {fn: c for fn, c in counts.items() if "fa_bwd" in fn}
    kinds = sorted(re.search(r"fa_bwd_\w+?_(?:bf16|f32)I", fn).group(0)
                   + re.search(r"ILi(\d+)E", fn).group(1) for fn in kernels)
    assert kinds == sorted(f"fa_bwd_{k}I{d}" for k in (
        "dq_f32", "dkdv_f32", "pre_bf16", "main_bf16", "post_bf16")
        for d in (64, 128)) and set(kernels) == set(spills), (
        sorted(counts), sorted(spills))
    for fn, c in sorted(kernels.items()):
        regs, stores, loads = spills[fn]
        print(f"sass[flash_attention_bwd] {fn}: {c} registers={regs} "
              f"spill_stores={stores} spill_loads={loads}")
        assert stores == loads == 0, (fn, spills[fn])
        assert "main_bf16" not in fn or (c["HGMMA"] > 0 and c["UTMALDG"] > 0
                                         and c["UBLKRED"] > 0), (fn, c)


def phase_lm_train(device, name):
    """Phase 22: LM training on the card.  Returns ({kernel: {path:
    launches}}, {dtype: kernel 7 backward max_abs_err}, figures, kernel 7
    timing rows, kernel 6 backward max_abs_err, kernel 6 timing rows)."""
    t0 = time.perf_counter()
    plans = start_remat_plans()
    try:
        errs = check_bwd_kernels(device)
        check_kernels_refuse_grad(device)
        scan_err = check_scan_bwd_kernels(device)
        counts, figures = _train_path()
        torch.cuda.empty_cache()
        ssm_counts, figures["falcon-mamba-7b"] = _ssm_train_path()
        torch.cuda.empty_cache()
        _resume_check()
        _plain_step_check(device)
        _plain_step_check(device, "falcon-mamba-7b")
        whisper = _whisper_train(device)
        jamba = _jamba_train(device)
        t1 = time.perf_counter()
        planned = remat_plans(plans)
        print(f"phase 22 remat plans (scripts/remat_plans.py --backward) "
              f"waited for {time.perf_counter() - t1} s")
    finally:
        if plans.poll() is None:
            plans.kill()
            plans.wait()
    olmo_turns, figures["remat olmo-1b"] = _remat_turns(device, name,
                                                        "olmo-1b", planned)
    ssm_turns, figures["remat falcon-mamba-7b"] = _remat_turns(
        device, name, "falcon-mamba-7b", planned, SSM_TRAIN_LAYERS)
    print(f"phase 22 remat seconds={time.perf_counter() - t1}")
    rows = train_timings(device, name)
    scan_rows = scan_train_timings(device, name)
    print(f"phase 22 seconds={time.perf_counter() - t0}")
    jamba_path = "LM training, jamba smoke widths, head width 64"
    turns_path = "LM training, remat none / dots / full in turns"
    paths = {key: {"LM training": counts[key],
                   "LM training, whisper-medium 2 + 2 layers": whisper[key],
                   jamba_path: jamba[key], turns_path: olmo_turns[key]}
             for key in ("flash_attention", "flash_attention_bwd")}
    for key in ("mamba_scan", "mamba_scan_bwd"):
        paths[key] = {"LM training, falcon-mamba-7b 8 layers": ssm_counts[key],
                      jamba_path: jamba[key], turns_path: ssm_turns[key]}
    return paths, errs, figures, rows, scan_err, scan_rows


# ---------------------------------------------------------------------------
# Phase 23: the dry run for one card (launch.dryrun), checked on the card
# ---------------------------------------------------------------------------

# (arch, shape, --micro) of the cells run on the card: OLMo-1B's train_4k at
# one 4,096-token sequence a microbatch (256 of them, cut to 2), so kernel 7
# and its backward at (1, 4096, 16, 128) causal in every layer; and
# falcon-mamba-7b's long_500k, 64 layers at full width, one decode step at
# index 524,287 (its mixer's decode is plain PyTorch: no kernel)
DRYRUN_CHECKED = (("olmo-1b", "train_4k", 256),
                  ("falcon-mamba-7b", "long_500k", 0))
DRYRUN_STEPS = 3
DRYRUN_CELLS = {"ok": 32, "skipped": 8}        # 10 archs x 4 shapes
# (B, Sq, Skv, Hq, Hkv, D, causal): OLMo-1B's train_4k attention
FA_TRAIN_4K = (1, 4096, 4096, 16, 16, 128, True)


def phase_dryrun(device, name):
    """Phase 23: ``launch.dryrun.plan_cells`` plans every (arch, shape)
    cell for one card (fake tensors on the CPU, each cell's JSON under
    ``dryrun_out``), then ``check_cell`` runs ``DRYRUN_CHECKED``
    on the card: the arguments it allocates must be the plan's to the byte,
    the peak is printed beside the plan's, kernel 7 and its backward at
    ``FA_TRAIN_4K`` are held to their plain twins (per row too, a planted
    shifted tile shown to fail that check) and timed beside SDPA's.  A
    checked cell at the default microbatching reuses its plan from the
    sweep; one at another ``--micro`` is planned again.
    Returns ({kernel: {path: launches}}, {kernel: error}, {kernel: timing
    row}, figures)."""
    from repro_torch.configs.base import SHAPES, list_archs
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    cells = dryrun.plan_cells(list_archs(), list(SHAPES),
                              out_dir=str(ROOT / dryrun.DEFAULT_OUT))
    plan_s = time.perf_counter() - t0
    status = {k: sum(c["status"] == k for c in cells)
              for k in ("ok", "skipped", "failed")}
    fits = [f"{c['arch']} {c['shape']}" for c in cells
            if c.get("fits_hbm_80g")]
    print(f"dry run: {len(cells)} cells planned on one card in {plan_s} s "
          f"(budget 60): {status}; fit the card by the plan: {fits}")
    assert status == dict(DRYRUN_CELLS, failed=0), status
    figures = {"plan_s": plan_s, "status": status, "fit": fits}
    paths = {"flash_attention": {}, "flash_attention_bwd": {}}
    planned = {(c["arch"], c["shape"]): c for c in cells}
    for arch, shape, micro in DRYRUN_CHECKED:
        plan = (dryrun.run_cell(arch, shape, micro=micro) if micro
                else planned[arch, shape])
        mem = plan["memory"]
        assert plan["fits_hbm_80g"], (arch, shape, mem)
        torch.cuda.empty_cache()
        with _PlainSpy() as plain:
            zero_counts()                                  # the path starts
            got = dryrun.check_cell(arch, shape, micro=micro, device=device,
                                    n_steps=DRYRUN_STEPS)
            counts = read_counts()                         # ... and ends
        assert plain.calls == 0, plain.calls
        ratio = got["peak_bytes"] / plan["hbm_bytes_per_chip"]
        print(f"dry-run check {arch} {shape} --micro {micro}: {got['rows']} "
              f"rows in {got['microbatches']} microbatches, "
              f"{DRYRUN_STEPS} steps, ms {got['ms']}, loss {got['loss']}; "
              f"argument bytes on the card {got['argument_bytes']} (the "
              f"caching allocator took {got['allocated_argument_bytes']}) vs "
              f"the plan's {mem['traced_argument_bytes']}; peak "
              f"{got['peak_bytes']} bytes (max_memory_allocated) vs the "
              f"plan's hbm_bytes_per_chip {plan['hbm_bytes_per_chip']} "
              f"(argument {mem['argument_size_in_bytes']} + temp "
              f"{mem['temp_size_in_bytes']} + output "
              f"{mem['output_size_in_bytes']} - alias "
              f"{mem['alias_size_in_bytes']}): measured/plan {ratio}; "
              f"launches {counts}; {name}")
        assert got["argument_bytes"] == mem["traced_argument_bytes"], (
            got, mem)
        figures[f"{arch} {shape}"] = dict(
            got, plan_hbm_bytes_per_chip=plan["hbm_bytes_per_chip"],
            plan_memory=mem, measured_over_plan=ratio)
        if SHAPES[shape].kind == "train":
            cfg = dryrun.cell_config(arch)
            want = cfg.num_layers * got["microbatches"] * DRYRUN_STEPS
            runs = remat_runs(cfg)            # the config's "full": twice
            assert counts["flash_attention"] == runs * want, counts
            assert counts["flash_attention_bwd"] == want, counts
            assert sum(counts.values()) == (runs + 1) * want, counts
            assert {k: v * DRYRUN_STEPS for k, v in
                    mem["launches"].items()} == {
                        "flash_attention": runs * want,
                        "flash_attention_bwd": want}, mem["launches"]
            assert np.isfinite(got["loss"]), got
            for key in paths:
                paths[key][f"dry-run check, {arch} {shape}"] = counts[key]
        else:
            assert sum(counts.values()) == 0, counts
        torch.cuda.empty_cache()
    errs = check_bwd_case("olmo_train_4k", FA_TRAIN_4K, torch.bfloat16,
                          device)
    q, k, v, do = _bwd_case(FA_TRAIN_4K, torch.bfloat16, device,
                            SEED + len("olmo_train_4k"))  # check_bwd_case's
    check_row_tol_catches_shifted_tiles(q, k, v, do, FA_TRAIN_4K[6],
                                        "olmo_train_4k")
    del q, k, v, do
    t1 = time.perf_counter()
    remat_counts, figures["remat"] = _remat_dryrun(device, name)
    for key in paths:
        paths[key]["dry-run check, olmo-1b train_4k at the microbatching "
                   "only remat full fits"] = remat_counts[key]
    print(f"phase 23 remat seconds={time.perf_counter() - t1}")
    rows = train_4k_timings(device, name)
    print(f"phase 23 seconds={time.perf_counter() - t0}")
    return paths, {"flash_attention_bwd": errs[0],
                   "flash_attention": errs[1]}, rows, figures


# OLMo-1B's train_4k planned under each remat against 80 GB (the issue of
# which microbatching fits the card), the microbatch counts tried in turn
REMAT_CELL = ("olmo-1b", "train_4k")
REMAT_MICRO = (1, 2, 4, 8, 16, 32, 64, 128, 256)
REMAT_PEAK_TOL = 0.02                 # measured peak against the plan's


def _remat_dryrun(device, name):
    """OLMo-1B ``train_4k`` planned at ``--micro 256`` under each remat
    (the three planned peaks), then the smallest microbatch count M of
    ``REMAT_MICRO`` at which "full" fits 80 GB and "none" does not, and
    ``check_cell`` at M under "full" on the card: the arguments the plan's
    to the byte, the peak within ``REMAT_PEAK_TOL`` of the plan's, the
    launches exactly the plan's a step (kernel 7 twice a backward launch).
    Returns (launch counts, figures)."""
    from repro_torch.launch import dryrun

    arch, shape = REMAT_CELL
    limit = (dryrun.HBM_80G, "80 GB")
    figures = {"micro_256": {}}
    for remat in REMAT_SETTINGS:
        plan = dryrun.run_cell(arch, shape, micro=256, limit=limit,
                               overrides={"remat": remat})
        mem = plan["memory"]
        figures["micro_256"][remat] = dict(
            hbm_bytes_per_chip=plan["hbm_bytes_per_chip"],
            temp_size_in_bytes=mem["temp_size_in_bytes"],
            launches=mem["launches"], flops=plan["cost"]["flops"])
    print(f"dry run {arch} {shape} --micro 256, planned peak "
          f"(hbm_bytes_per_chip) by remat: "
          f"{ {r: f['hbm_bytes_per_chip'] for r, f in figures['micro_256'].items()} }"
          f"; traced launches "
          f"{ {r: f['launches'] for r, f in figures['micro_256'].items()} }")
    found = None
    for micro in REMAT_MICRO:
        full = dryrun.run_cell(arch, shape, micro=micro, limit=limit,
                               overrides={"remat": "full"})
        if not full["fits_hbm_80g"]:
            continue
        none = dryrun.run_cell(arch, shape, micro=micro, limit=limit,
                               overrides={"remat": "none"})
        print(f"dry run {arch} {shape} --micro {micro}: remat full fits "
              f"({full['hbm_bytes_per_chip']} bytes planned), none "
              f"{'fits' if none['fits_hbm_80g'] else 'does not'} "
              f"({none['hbm_bytes_per_chip'] or none['memory']['not_traced']})")
        if not none["fits_hbm_80g"]:
            found = micro, full
            break
    assert found is not None, "no microbatching that only remat full fits"
    micro, plan = found
    mem = plan["memory"]
    torch.cuda.empty_cache()
    with _PlainSpy() as plain:
        zero_counts()                                  # the path starts here
        got = dryrun.check_cell(arch, shape, micro=micro, device=device,
                                n_steps=DRYRUN_STEPS,
                                overrides={"remat": "full"})
        counts = read_counts()                         # ... and ends here
    ratio = got["peak_bytes"] / plan["hbm_bytes_per_chip"]
    print(f"dry-run check {arch} {shape} --micro {micro} remat full (the "
          f"smallest count of microbatches only full fits in 80 GB): "
          f"{got['rows']} rows of 4,096 tokens in {got['microbatches']} "
          f"microbatches, {DRYRUN_STEPS} steps, ms {got['ms']}, loss "
          f"{got['loss']}; argument bytes {got['argument_bytes']} vs the "
          f"plan's {mem['traced_argument_bytes']}; peak {got['peak_bytes']} "
          f"vs the plan's {plan['hbm_bytes_per_chip']}: measured/plan "
          f"{ratio}; launches {counts} vs the plan's {mem['launches']} a "
          f"step; {name}")
    assert plain.calls == 0, plain.calls
    assert got["argument_bytes"] == mem["traced_argument_bytes"], (got, mem)
    assert abs(ratio - 1) <= REMAT_PEAK_TOL, ratio
    want = dryrun.cell_config(arch).num_layers * got["microbatches"] * \
        DRYRUN_STEPS
    assert counts["flash_attention"] == 2 * want, counts
    assert counts["flash_attention_bwd"] == want, counts
    assert sum(counts.values()) == 3 * want, counts
    assert {k: v * DRYRUN_STEPS for k, v in mem["launches"].items()} == {
        "flash_attention": 2 * want, "flash_attention_bwd": want}
    assert np.isfinite(got["loss"]), got
    figures["check"] = dict(got, micro=micro,
                            plan_hbm_bytes_per_chip=plan["hbm_bytes_per_chip"],
                            measured_over_plan=ratio, launches=counts)
    torch.cuda.empty_cache()
    return counts, figures


def train_4k_timings(device, name):
    """Kernel 7's training forward (the lse stored) and its backward at
    ``FA_TRAIN_4K`` in bfloat16: device time from a CUDA graph, the plain
    twins', the bound from these inputs and SDPA's forward and backward
    (``library_ms``)."""
    from repro_torch.kernels import flash_attention as fa

    saved = read_counts()
    b, sq, skv, hq, hkv, d, causal = FA_TRAIN_4K
    q, k, v, do = _bwd_case(FA_TRAIN_4K, torch.bfloat16, device, SEED + 28)
    fwd = lambda: fa.flash_attention_fwd(q, k, v, causal=causal)  # noqa: E731
    out, lse = fwd()
    bwd = lambda: fa.flash_attention_bwd(  # noqa: E731
        q, k, v, out, do, lse, causal=causal)
    names = device_kernels(bwd)
    assert len(names) == 3 and all("fa_bwd" in n for n in names), names
    pairs = causal_pairs(sq, skv)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib, backend = _library_attention(qt, kt, vt, causal=causal)
    _, _, _, _, terms = attention_bound(b, hq, hkv, sq, skv, d, pairs, 2,
                                        name)
    terms["bytes"] += 4 * b * hq * sq / peaks(name)[1][1] * 1e3   # the lse
    by = max(terms, key=terms.get)
    rows = {"forward": dict(
        ms=graph_time_ms(fwd, 10), plain_ms=graph_time_ms(
            lambda: fa.flash_attention_plain(q, k, v, causal=causal,
                                             return_lse=True), 2, reps=3),
        bound_ms=terms[by], bound_by="bytes" if by == "bytes"
        else "operations", library_ms=graph_time_ms(lib, 10),
        library_kernel=backend, bound_terms_ms=terms, shape=list(FA_TRAIN_4K),
        path="dry-run check, olmo-1b train_4k (forward, lse stored)")}
    b_ms, b_by, nbytes, n_ops, bterms = attention_bwd_bound(
        b, hq, hkv, sq, skv, d, pairs, 2, name)
    rows["backward"] = dict(
        ms=graph_time_ms(bwd, 10), plain_ms=graph_time_ms(
            lambda: fa.flash_attention_bwd_plain(q, k, v, out, do, lse,
                                                 causal=causal), 2, reps=3),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=_library_backward_ms(q, k, v, do, causal),
        bound_terms_ms=bterms, shape=list(FA_TRAIN_4K),
        kernels_us={key[:24]: us for key, us in device_split_us(bwd).items()},
        path="dry-run check, olmo-1b train_4k")
    for label, row in rows.items():
        print(f"timing flash_attention {label} (B, Sq, Skv, Hq, Hkv, D, "
              f"causal)={FA_TRAIN_4K} bf16: kernel_ms={row['ms']} plain_ms="
              f"{row['plain_ms']} library_ms={row['library_ms']} (SDPA's "
              f"{label}, CUDA graph) bound_ms={row['bound_ms']} "
              f"({row['bound_by']}; terms_ms {row['bound_terms_ms']}) "
              f"kernel/bound={row['ms'] / row['bound_ms']} kernel/library="
              f"{row['ms'] / row['library_ms']}")
    for key, fn in wrappers().items():          # timing launches don't count
        fn.launches = saved[key]
    return rows


def check_kernel6_build():
    """Kernel 6's twelve forward instances (six serving, six that also
    write the chunk states) and its backward's kernels (the reverse scan
    at each built (N, SPL, L, K), ``SCAN_BWD_BUILT``, and the fixed-order
    sums) spill nothing."""
    from repro_torch.kernels import mamba_scan as ms

    fwd = ptxas_spills("mamba_scan")
    bwd = ptxas_spills("mamba_scan_bwd")
    states = {fn: v for fn, v in fwd.items() if "Lb1E" in fn}
    n_bwd = sum(len(ks) for ks in ms.SCAN_BWD_BUILT.values()) + 1
    assert len(fwd) == 12 and len(states) == 6 and len(bwd) == n_bwd, (
        sorted(fwd), sorted(bwd))
    for fn, (regs, stores, loads) in sorted(states.items()) + sorted(
            bwd.items()):
        print(f"ptxas[mamba_scan{'_bwd' if fn in bwd else ''}] {fn}: "
              f"registers={regs} spill_stores={stores} spill_loads={loads}")
        assert stores == loads == 0, (fn, regs, stores, loads)


SASS_OPS = ("HMMA", "LDGSTS", "LDSM", "HGMMA", "UTMALDG", "UBLKCP", "UBLKRED")


def sass_counts(source):
    """{kernel function: {opcode: count}} of ``csrc/<source>.cu``'s built
    library (``cuobjdump -sass``): tensor-core products (HMMA; HGMMA on
    wgmma), cp.async copies (LDGSTS), ldmatrix loads (LDSM), TMA tensor
    loads (UTMALDG), bulk copies (UBLKCP) and bulk reduce-adds
    (UBLKRED)."""
    import re

    from repro_torch.kernels import _build

    tool = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(_build._lib_path(source))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn:
            for op in re.findall(r"\b(" + "|".join(SASS_OPS) + r")\b", line):
                counts[fn][op] += 1
    return counts


def check_kernel7_sass():
    """Kernel 7's fourteen instances: the four bfloat16 ones at D in {64,
    128} (with and without the lse store) run on wgmma (HGMMA) fed by TMA
    loads (UTMALDG), with no mma.sync (HMMA), no cp.async and no spill
    (ptxas); no mma.sync bfloat16 instance is left at those widths; the
    other ten (float32 at every width, bfloat16 at D in {8, 16, 32}) run
    their products on mma.sync (HMMA) and load K/V tiles with cp.async
    (LDGSTS), the bfloat16 ones reading fragments with ldmatrix (LDSM) and
    spilling nothing."""
    import re

    counts = sass_counts("flash_attention")
    spills = ptxas_spills("flash_attention")
    kernels = {fn: c for fn, c in counts.items()
               if "flash_attention_" in fn}
    assert len(kernels) == 14, sorted(counts)
    wgmma = {fn for fn in kernels if "flash_attention_wgmma" in fn}
    assert sorted(int(re.search(r"ILi(\d+)E", fn).group(1)) for fn in
                  wgmma) == [64, 64, 128, 128], sorted(wgmma)
    for fn, c in sorted(kernels.items()):
        regs, stores, loads = spills.get(fn, (None, None, None))
        print(f"sass[flash_attention] {fn}: {c} registers={regs} "
              f"spill_stores={stores} spill_loads={loads}")
        if fn in wgmma:
            assert c["HGMMA"] > 0 and c["UTMALDG"] > 0, (fn, c)
            assert c["HMMA"] == c["LDGSTS"] == 0, (fn, c)
            assert stores == loads == 0, (fn, spills.get(fn))
        else:
            assert c["HMMA"] > 0 and c["LDGSTS"] > 0, (fn, c)
            assert "bf16" not in fn or c["LDSM"] > 0, (fn, c)
            assert "bf16" not in fn or re.search(r"ILi(8|16|32)E", fn), fn
            assert "bf16" not in fn or stores == loads == 0, (fn, regs)


def ptxas_spills(source):
    """{kernel function: (registers, spill store bytes, spill load bytes)}
    from ptxas's report (``-Xptxas -v``) of ``csrc/<source>.cu``'s build."""
    import re

    from repro_torch.kernels import _build

    out, fn = {}, None
    for line in _build.BUILD_LOG[source]["ptxas"].splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = [0, 0, 0]
        elif fn:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                out[fn][1:] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out[fn][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def check_kernel8_build():
    """Every instance of kernel 8 (q float32 or bfloat16 x cache in q's
    dtype or float8_e4m3fn x D in {16, 32, 64, 128}) copies its K/V tiles
    with cp.async (LDGSTS), spills nothing (ptxas), and the bfloat16-q
    ones run their products on the tensor cores (HMMA) from ldmatrix
    loads (LDSM)."""
    counts = sass_counts("decode_attention")
    spills = ptxas_spills("decode_attention")
    kernels = {fn: c for fn, c in counts.items()
               if "decode_attention_kernel" in fn}
    assert len(kernels) == 16 and set(kernels) == set(spills), (
        sorted(counts), sorted(spills))
    for fn, c in sorted(kernels.items()):
        regs, stores, loads = spills[fn]
        mma = "kernelI13__nv_bfloat16" in fn
        print(f"sass[decode_attention] {fn}: {c} registers={regs} "
              f"spill_stores={stores} spill_loads={loads}")
        assert c["LDGSTS"] > 0 and stores == loads == 0, (fn, c, spills[fn])
        assert not mma or (c["HMMA"] > 0 and c["LDSM"] > 0), (fn, c)


def timed(phase, *args):
    """``phase(*args)``, its wall seconds printed on a line of their own."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"phase {phase.__name__} seconds={time.perf_counter() - t0}")
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-src", default="",
                    help="another checkout's src directory: phases 14 and "
                         "20 also time its kernel 8 at every row, before "
                         "and after this one's (scripts/decode_timings.py), "
                         "phase 22 its kernel 7 forward and kernel 7 and "
                         "kernel 6 backwards (scripts/bwd_timings.py)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t_start = t0 = time.perf_counter()
    secs = _build.build(_build.all_sources())  # one nvcc per source, together
    print(f"build: {secs} (wall {time.perf_counter() - t0:.2f} s)")
    for src, log in _build.BUILD_LOG.items():
        for line in log["ptxas"].splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"ptxas[{src}]: {line.strip()}")
    check_kernel7_sass()
    check_kernel8_build()
    check_kernel7_bwd_build()
    check_kernel6_build()

    max_err = timed(phase_kernels, device)
    errs = timed(phase_new_kernels, device)
    errs["sdqn_score_afterstate"] = max_err
    for key, err in timed(phase_plan_kernels, device).items():
        errs[key] = max(errs[key], err)
    launches = {}
    launches["sdqn_score_afterstate"], fill = timed(phase_main_path, device)
    timed(phase_decision_parity, device)
    launches["sdqn_score_afterstate_topk"] = timed(phase_sharded_cluster,
                                                   device)
    timed(phase_sharded_parity, device)
    launches.update(timed(phase_fleet, device))
    launches["sdqn_score"] = timed(phase_engine, device)
    errs.update(timed(phase_seq_kernels, device))
    launches.update(timed(phase_policy_paths, device))
    timed(phase_policy_parity, device)
    timed(phase_policy_arms, device)
    lm_errs = timed(phase_lm_kernels, device)
    lm_counts, res = timed(phase_lm_serve, device)
    timed(phase_lm_breakdown, device, res)
    del res
    torch.cuda.empty_cache()
    learner_counts, learner_errs, _ = timed(phase_learner, device)
    for key, err in learner_errs.items():
        errs[key] = max(errs[key], err)
    tables = timed(phase_paper_tables, device)
    baseline_counts = timed(phase_baselines, device, tables)
    coc_counts, coc_err = timed(phase_scenarios, device)
    errs["sdqn_score_afterstate"] = max(errs["sdqn_score_afterstate"], coc_err)
    rest_paths, chaos_err, drain_err = timed(phase_rest, device)
    errs["sdqn_score_afterstate"] = max(errs["sdqn_score_afterstate"],
                                        chaos_err)
    errs["sdqn_score_cols"] = max(errs["sdqn_score_cols"], drain_err)
    family_paths, family_figures = timed(phase_lm_families, device)
    family_errs = timed(phase_family_kernels, device)
    granite_paths, granite_figures = timed(phase_lm_granite, device)
    family_figures.update(granite_figures)
    bwd_parents = ([parent_bwd_times(args.parent_src)] if args.parent_src
                   else [])
    (train_paths, train_errs, train_figures, train_rows, scan_err,
     scan_rows) = timed(phase_lm_train, device, name)
    if args.parent_src:         # parent, this, parent: in turns on one card
        bwd_parents.append(parent_bwd_times(args.parent_src))
        for label in FA_BWD_TIMED:
            row = train_rows[label]
            row["parent_ms"] = [
                p["flash_attention_bwd"].get(label, {}).get("ms")
                for p in bwd_parents]
            print(f"timing flash_attention_bwd {label}: kernel_ms="
                  f"{row['ms']} parent_ms={row['parent_ms']} (before, after) "
                  f"library_ms={row['library_ms']} (SDPA's backward) "
                  f"bound_ms={row['bound_ms']} kernel/parent="
                  f"{row['ms'] / statistics.mean(row['parent_ms'])} "
                  f"kernel/library={row['ms'] / row['library_ms']}")
        for shape in SCAN_BWD_TIMED:
            row = scan_rows[shape]
            row["parent_ms"] = [
                p["mamba_scan_bwd"].get(str(shape), {}).get("ms")
                for p in bwd_parents]
            print(f"timing mamba_scan_bwd {shape}: kernel_ms={row['ms']} "
                  f"parent_ms={row['parent_ms']} (before, after) "
                  f"bound_ms={row['bound_ms']} kernel/parent="
                  f"{row['ms'] / statistics.mean(row['parent_ms'])}")
    dry_paths, dry_errs, dry_rows, dry_figures = timed(phase_dryrun, device,
                                                       name)
    if args.parent_src:         # the parent's kernel 7b at train_4k, in turns
        row = dry_rows["backward"]
        row["parent_ms"] = [p["flash_attention_bwd"].get("train_4k", {})
                            .get("ms") for p in bwd_parents]
        print(f"timing flash_attention_bwd train_4k: kernel_ms={row['ms']} "
              f"parent_ms={row['parent_ms']} (before, after) library_ms="
              f"{row['library_ms']} bound_ms={row['bound_ms']} kernel/parent="
              f"{row['ms'] / statistics.mean(row['parent_ms'])}")
    errs["mamba_scan"] = max(errs["mamba_scan"], family_errs["mamba_scan"])
    for key in ("flash_attention", "decode_attention"):
        lm_errs[key]["bfloat16"] = max(lm_errs[key]["bfloat16"],
                                       family_errs[key])
    paths = {"flash_attention": {"attention policy class":
                                 launches["flash_attention"],
                                 "LM prefill": lm_counts["flash_attention"],
                                 "attention learner":
                                 learner_counts["flash_attention"],
                                 "policy-class table, attention arm":
                                 baseline_counts["flash_attention"]},
             "sdqn_score_afterstate": {
                 "flat cluster": launches["sdqn_score_afterstate"],
                 "fleet learner": learner_counts["sdqn_score_afterstate"],
                 "cluster-of-clusters-4k episode with consolidation":
                 coc_counts["sdqn_score_afterstate"]},
             "decode_attention": {"LM decode": lm_counts["decode_attention"]},
             "sdqn_score_cols": {"flat job->host": launches["sdqn_score_cols"],
                                 "LM wave routing":
                                 lm_counts["sdqn_score_cols"]}}
    paths["mamba_scan"] = {"mamba policy class": launches["mamba_scan"]}
    paths["flash_attention_bwd"] = {}
    paths["mamba_scan_bwd"] = {}
    for key, per_path in (list(rest_paths.items())
                          + list(family_paths.items())
                          + list(granite_paths.items())
                          + list(train_paths.items())
                          + list(dry_paths.items())):
        paths[key].update(per_path)
    for key, per_path in paths.items():
        launches[key] = sum(per_path.values())
    errs["decode_attention"] = max(lm_errs["decode_attention"].values())
    train_errs["bfloat16"] = max(train_errs["bfloat16"],
                                 dry_errs["flash_attention_bwd"])
    lm_errs["flash_attention"]["bfloat16"] = max(
        lm_errs["flash_attention"]["bfloat16"], dry_errs["flash_attention"])
    errs["flash_attention_bwd"] = max(train_errs.values())
    lm_errs["flash_attention_bwd"] = train_errs
    timing = timed(phase_new_timings, device, name)
    timing["sdqn_score_afterstate"] = timed(phase_timings, device, name, fill)
    timing.update(timed(phase_seq_timings, device, name))
    parents = ([parent_decode_times(args.parent_src)] if args.parent_src
               else [])
    lm_timing = timed(phase_lm_timings, device, name)
    timing["decode_attention"] = dict(lm_timing["path"], other_shapes=[
        lm_timing[label] for label in PHASE14_DECODE[1:]])
    timing["flash_attention"]["other_shapes"] = [lm_timing["prefill"]]
    for key, rows in timed(phase_family_timings, device, name).items():
        timing[key].setdefault("other_shapes", []).extend(rows)
    timing["flash_attention"]["other_shapes"].extend(
        [train_rows["forward_lse"], dry_rows["forward"]])
    if args.parent_src:         # parent, this, parent: in turns on one card
        fwd_rows = {"prefill": lm_timing["prefill"],
                    "forward_lse": train_rows["forward_lse"],
                    "train_4k": dry_rows["forward"]}
        fwd_rows.update((row["path"], row) for row in
                        timing["flash_attention"]["other_shapes"]
                        if row.get("path") in FA_FWD_TIMED)
        for label, row in fwd_rows.items():
            row["parent_ms"] = [
                p["flash_attention"].get(label, {}).get("ms")
                for p in bwd_parents]
            lib = row.get("library_ms")
            print(f"timing flash_attention {label}: kernel_ms={row['ms']} "
                  f"parent_ms={row['parent_ms']} (before, after) "
                  f"library_ms={lib} bound_ms={row['bound_ms']} "
                  f"kernel/parent="
                  f"{row['ms'] / statistics.mean(row['parent_ms'])} "
                  f"kernel/library={lib and row['ms'] / lib}")
    timing["flash_attention_bwd"] = dict(
        train_rows[FA_BWD_TIMED[0]],
        other_shapes=[train_rows[label] for label in FA_BWD_TIMED[1:]]
        + [dry_rows["backward"]])
    timing["mamba_scan"].setdefault("other_shapes", []).append(
        scan_rows["forward_states"])
    timing["mamba_scan_bwd"] = dict(
        scan_rows[SCAN_BWD_TIMED[0]],
        other_shapes=[scan_rows[shape] for shape in SCAN_BWD_TIMED[1:]])
    errs["mamba_scan_bwd"] = max([scan_err] + [scan_rows[shape]["max_abs_err"]
                                               for shape in SCAN_BWD_TIMED])
    t8 = timing["decode_attention"]       # every timed row held to plain
    errs["decode_attention"] = max([errs["decode_attention"], t8["max_abs_err"]]
                                   + [r["max_abs_err"]
                                      for r in t8["other_shapes"]])
    if args.parent_src:         # parent, this, parent: in turns on one card
        parents.append(parent_decode_times(args.parent_src))
        t8 = timing["decode_attention"]
        for row in [t8] + t8["other_shapes"]:
            for key in ("ms", "cold_ms"):
                row[f"parent_{key}"] = [p.get(row["path"], {}).get(key)
                                        for p in parents]
            print(f"timing decode_attention {row['path']}: kernel_ms="
                  f"{row['ms']} parent_ms={row['parent_ms']} (before, "
                  f"after) kernel_cold_ms={row['cold_ms']} parent_cold_ms="
                  f"{row['parent_cold_ms']} bound_ms={row['bound_ms']} "
                  f"sdpa_ms="
                  f"{row.get('library_ms') or row.get('sdpa_on_bf16_cache_ms')}")
    timed(phase_breakdown, device)
    timed(phase_sharded_breakdown, device)
    timed(phase_policy_breakdown, device)

    # (wrapper, CUDA source, the TPU kernel's function line; for kernels
    # 7's and 6's backwards, which no Pallas kernel has, the attention and
    # the chunked scan the JAX model trains through by XLA's autodiff).  No single PyTorch call computes
    # the fused SDQN functions or a selective scan (library_ms null);
    # kernels 7's and 8's is scaled_dot_product_attention, the backward's
    # its backward.
    # A kernel on more than one path reports their launches summed, per
    # path under "paths"; its timing at the first path's shape, the others'
    # under "other_shapes".
    kernels_src = "src/repro/kernels/"
    table = (
        ("sdqn_score_afterstate", "sdqn_score_afterstate.cu",
         kernels_src + "sdqn_score.py:171"),
        ("sdqn_score", "sdqn_score.cu", kernels_src + "sdqn_score.py:51"),
        ("sdqn_score_cols", "sdqn_score_cols.cu",
         kernels_src + "sdqn_score.py:249"),
        ("sdqn_score_afterstate_topk", "sdqn_score_afterstate_topk.cu",
         kernels_src + "sdqn_score.py:386"),
        ("sdqn_score_cols_topk", "sdqn_score_cols.cu",
         kernels_src + "sdqn_score.py:486"),
        ("mamba_scan", "mamba_scan.cu", kernels_src + "mamba_scan.py:61"),
        ("flash_attention", "flash_attention.cu",
         kernels_src + "flash_attention.py:77"),
        ("decode_attention", "decode_attention.cu",
         kernels_src + "decode_attention.py:69"),
        ("flash_attention_bwd", "flash_attention_bwd.cu",
         "src/repro/models/layers.py:124"),
        ("mamba_scan_bwd", "mamba_scan_bwd.cu",
         "src/repro/models/mamba.py:62"),
    )
    kernels = []
    for key, src, line in table:
        t = timing[key]
        assert launches[key] > 0, (key, launches)
        kernels.append({
            "name": key, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": line,
            "launches": launches[key], "max_abs_err": errs[key],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms"),
        })
        if key in paths:
            kernels[-1]["paths"] = paths[key]
        if key in lm_errs:
            kernels[-1]["max_abs_err_by_dtype"] = dict(
                lm_errs[key], **({"float32": errs[key]}
                                 if key == "flash_attention" else {}))
        for extra in ("other_shapes", "shape", "kv_len", "cache",
                      "library_kernel", "bound_terms_ms", "launch_floor_ms",
                      "plan", "parent_ms", "cold_ms", "parent_cold_ms"):
            if extra in t:
                kernels[-1][extra] = t[extra]
    print(f"lm_families {json.dumps(family_figures)}")
    print(f"lm_train {json.dumps(train_figures)}")
    print(f"dry_run {json.dumps(dry_figures, default=str)}")
    print(f"chip_smoke seconds={time.perf_counter() - t_start}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
