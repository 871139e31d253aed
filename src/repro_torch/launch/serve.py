"""Batched LM serving with SDQN request routing (port of
``repro.launch.serve``).

Requests arrive in waves; the SDQN placement daemon (``sched.daemon``)
routes each wave to one of several model-server replicas on their load
features (every wave submitted as a placement request, a batch of them
scored in one launch of the column kernel and bound with optimistic
concurrency), then the wave is served: prefill of its prompts (kernel 7 in
every attention layer, kernel 6 in every mamba layer), the prompt's cache
copied into one of ``prompt_len + gen_tokens`` positions, and a greedy
decode loop (kernel 8 in every attention layer of every step).  The model's weights are random,
drawn from ``--seed``; the replicas share them.

    python -m repro_torch.launch.serve --arch olmo-1b --replicas 4 \\
        --requests 32 --wave-size 8 --prompt-len 512 --gen-tokens 32

runs on the CUDA card; ``--device cpu`` runs the kernels' plain versions
on the CPU (``--smoke`` for a reduced model).  Every family serves
(dense, moe, ssm, hybrid, vlm); ``main`` passes no encoder input, as the
reference's does, so an encoder-decoder arch (whisper) raises
``ValueError`` there; ``serve_wave(extra={"frames": ...})`` serves it.  ``--qnet-path`` loads the
routing policy from a checkpoint directory (``checkpoint.ckpt``, either
package's) or a legacy ``.npz``.  ``--online`` records every routing
decision (``sched.online.FleetTransitionRecorder`` on the daemon's
``decision_hook``) and, after the routing burst, runs ``--online-steps``
refresh cycles that fine-tune the routing policy on the realized rewards
and publish it to the daemon.  ``main`` returns a ``ServeResult`` with
every wave's tokens; ``serve_wave`` is one wave.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core import policy as policy_mod
from repro_torch.device import resolve_device
from repro_torch.models import model as mdl
from repro_torch.sched.daemon import (DaemonConfig, FleetSubstrate,
                                      PlacementDaemon)
from repro_torch.sched.placement import JobSpec, fresh_fleet


def seed_generator(seed: int, stream: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` for sub-stream ``stream`` of ``seed`` (the
    port's ``fold_in``: 0 the model, 1 the routing policy, 2 the fleet,
    100 + w the prompts of wave w)."""
    state = np.random.SeedSequence([seed, stream]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def sample_requests(gen: torch.Generator, n: int, vocab: int,
                    prompt_len: int) -> torch.Tensor:
    """(n, prompt_len) int64 token ids, uniform below ``vocab``, on the
    generator's device."""
    return torch.randint(0, vocab, (n, prompt_len), generator=gen,
                         device=gen.device)


def load_policy(path: str, gen: torch.Generator, policy: str = "mlp",
                device=None):
    """SDQN routing params and their policy class: ``(params, PolicySpec)``.

    Empty ``path``: a fresh init of ``policy``; a ``.npz``: the Table-4 MLP
    (the reference's legacy flat file); otherwise a checkpoint directory
    (``checkpoint.ckpt``'s format, written by either package; its latest
    step), whose manifest names its policy class (``policy`` for one
    without a record)."""
    if not path:
        spec = policy_mod.get(policy)
        return spec.init(gen, device=device), spec
    if path.endswith(".npz"):
        device = resolve_device(device)
        loaded = np.load(path)
        return ({k: torch.tensor(np.asarray(loaded[k], np.float32),
                                 device=device) for k in loaded.files},
                policy_mod.get("mlp"))
    return policy_mod.restore_checkpoint(path, default_policy=policy,
                                         device=device)


def load_qnet(path: str, gen: torch.Generator, device=None) -> dict:
    """Just the params (MLP default); prefer ``load_policy``."""
    params, _ = load_policy(path, gen, device=device)
    return params


@dataclasses.dataclass
class WaveResult:
    prompts: torch.Tensor          # (B, prompt_len)
    tokens: torch.Tensor           # (B, gen_tokens) greedy tokens
    prefill_logits: torch.Tensor   # (B, Vp) float32
    top2_gap: torch.Tensor         # (B, gen_tokens): best minus second logit
    prefill_s: float               # prefill and cache copy, synchronized
    decode_s: float                # the gen_tokens - 1 decode steps


def _top2_gap(logits: torch.Tensor) -> torch.Tensor:
    top = torch.topk(logits, 2, dim=-1).values
    return top[:, 0] - top[:, 1]


def decode_cache(cfg: ModelConfig, pcache: dict, batch: int, plen: int,
                 gen_tokens: int, device=None) -> dict:
    """The decode cache of ``plen + gen_tokens`` positions seeded from a
    prefill cache: its K/V in the first ``plen`` positions, every other
    leaf (the mamba ``conv`` and ``h``, the encoder's ``xk`` and ``xv``)
    whole.  The reference pads only its 5-D leaves of length ``plen``
    (``repro/launch/serve.py:156-163``) and keeps the rest as they are.
    Leaves go into the config's ``cache_dtype`` through
    ``model.cache_cast`` (a float8 cache rounds as the reference's
    ``astype``)."""
    cache = mdl.init_cache(cfg, batch, plen + gen_tokens, device=device)
    for name, sub in cache.items():
        for leaf, t in sub.items():
            src = mdl.cache_cast(pcache[name][leaf], t.dtype)
            if leaf in ("k", "v"):
                t[:, :, :plen] = src
            else:
                t.copy_(src)
    return cache


def serve_wave(params, cfg: ModelConfig, prompts: torch.Tensor,
               gen_tokens: int, *, attn_mode: Optional[str] = None,
               extra: Optional[dict] = None) -> WaveResult:
    """Prefill ``prompts`` (B, P) (with ``extra``, e.g. an encoder-decoder's
    ``{"frames": ...}``), copy the prefill cache into a decode cache of P +
    ``gen_tokens`` positions (K/V into the first P, the mamba states and
    the encoder's K/V whole), and decode ``gen_tokens`` greedy tokens (the
    first from the prefill's logits).  ``attn_mode`` is that of
    ``kernels.ops`` (None: the kernels on the card, the plain versions on
    the CPU)."""
    device = prompts.device
    b, plen = prompts.shape

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        logits, pcache = mdl.prefill(params, cfg, prompts,
                                     {} if extra is None else extra,
                                     attn_mode=attn_mode)
        cache = decode_cache(cfg, pcache, b, plen, gen_tokens, device)
        del pcache
        sync()
        t1 = time.perf_counter()
        prefill_logits = logits
        tok = torch.argmax(logits, dim=-1)[:, None]
        out, gaps = [tok], [_top2_gap(logits)]
        for i in range(gen_tokens - 1):
            logits, cache = mdl.decode_step(params, cfg, tok, cache, plen + i,
                                            attn_mode=attn_mode)
            tok = torch.argmax(logits, dim=-1)[:, None]
            out.append(tok)
            gaps.append(_top2_gap(logits))
        sync()
        t2 = time.perf_counter()
    return WaveResult(prompts, torch.cat(out, dim=1), prefill_logits,
                      torch.stack(gaps, dim=1), t1 - t0, t2 - t1)


@dataclasses.dataclass
class ServeResult:
    counts: np.ndarray             # waves per replica
    assignments: List[int]         # replica of each wave (-1: unplaced)
    waves: List[WaveResult]
    params: dict
    cfg: ModelConfig
    daemon: PlacementDaemon
    seconds: float                 # serving the waves, routing excluded
    generated: int                 # tokens generated
    refresher: Optional[object] = None   # the OnlineRefresher (--online)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--wave-size", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--qnet-path", default="",
                    help="trained SDQN params: a checkpoint directory or a "
                         "legacy .npz (the Table-4 MLP); fresh init if empty")
    ap.add_argument("--policy", default="mlp",
                    help="policy class (core.policy registry) when "
                         "--qnet-path is empty or carries no policy record")
    ap.add_argument("--online", action="store_true",
                    help="record every routing decision and fine-tune the "
                         "routing policy on the realized rewards (params "
                         "swap at batch cuts)")
    ap.add_argument("--online-steps", type=int, default=4,
                    help="refresh cycles after the routing burst (with "
                         "--online)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (raises "
                         "without one)")
    return ap


def main(argv=None) -> ServeResult:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    params = mdl.init_params(seed_generator(args.seed, 0, device), cfg, device)

    # SDQN routing across replicas, served by the placement daemon: waves
    # are submitted as requests, batch-scored in one launch, bound
    # optimistically
    qparams, qspec = load_policy(args.qnet_path, seed_generator(args.seed, 1),
                                 policy=args.policy, device=device)
    fleet = fresh_fleet(args.replicas, seed_generator(args.seed, 2),
                        device=device)
    waves = args.requests // args.wave_size
    sub = FleetSubstrate(fleet, policy=qspec, device=device)
    recorder = refresher = None
    if args.online:
        from repro_torch.core.types import FEATURE_DIM
        from repro_torch.sched.online import FleetTransitionRecorder

        if qspec.feature_dim != FEATURE_DIM:
            raise SystemExit(
                f"--online needs a policy with the canonical afterstate "
                f"feature width ({FEATURE_DIM}); {qspec.name} trains on "
                f"{qspec.feature_dim}-wide rows")
        recorder = FleetTransitionRecorder(fleet, device=device)
    daemon = PlacementDaemon(
        sub, qparams,
        DaemonConfig(batch_size=max(min(waves, 8), 1), max_wait_s=0.0),
        decision_hook=recorder.record if recorder else None)
    daemon.warmup()
    job = JobSpec(cpu_pct_demand=100.0 / max(waves, 1), kind="serve")
    for _ in range(waves):
        daemon.submit(job)
    daemon.drain()
    assignments = [d.node for d in sorted(daemon.decisions)]

    if args.online:
        # a pure submit / bind trace: the recorder's shadow needs no resync
        from repro_torch.sched.online import OnlineRefresher

        refresher = OnlineRefresher(daemon, recorder, spec=qspec)
        refresher.warmup()
        for _ in range(args.online_steps):
            refresher.step()
        loss = ("n/a" if refresher.last_loss is None
                else f"{refresher.last_loss:.4f}")
        print(f"[serve] online refresh: {recorder.drained} transitions "
              f"recorded, {refresher.steps} refresh steps, "
              f"{refresher.swaps} param swaps, last_loss={loss}")

    t0 = time.perf_counter()
    results = []
    for w, _replica in enumerate(assignments):
        prompts = sample_requests(seed_generator(args.seed, 100 + w, device),
                                  args.wave_size, cfg.vocab_size,
                                  args.prompt_len)
        results.append(serve_wave(params, cfg, prompts, args.gen_tokens,
                                  extra={}))
    dt = time.perf_counter() - t0
    generated = len(results) * args.wave_size * args.gen_tokens

    placed = [a for a in assignments if a >= 0]
    counts = np.bincount(np.asarray(placed, np.int64), minlength=args.replicas)
    steps = len(results) * max(args.gen_tokens - 1, 0)
    prefill_ms = 1e3 * sum(r.prefill_s for r in results) / max(len(results), 1)
    step_ms = 1e3 * sum(r.decode_s for r in results) / max(steps, 1)
    print(f"[serve] {args.requests} requests, {generated} tokens in {dt:.1f}s "
          f"({generated / dt:.1f} tok/s) on {device}")
    print(f"[serve] prefill {prefill_ms:.2f} ms per wave of {args.wave_size} "
          f"x {args.prompt_len} tokens; decode {step_ms:.3f} ms per step "
          f"({args.wave_size} tokens)")
    print(f"[serve] SDQN routing ({qspec.name}) across replicas: "
          f"{counts.tolist()} "
          f"({daemon.metrics.batches} daemon batches, "
          f"{daemon.metrics.device_launches} scoring launches, "
          f"{daemon.metrics.conflicts} bind conflicts)")
    print(f"[serve] replica load (cpu%): "
          f"{np.round(np.asarray(sub.live.cpu_pct), 1).tolist()}")
    return ServeResult(counts, assignments, results, params, cfg, daemon, dt,
                       generated, refresher)


if __name__ == "__main__":
    main()
