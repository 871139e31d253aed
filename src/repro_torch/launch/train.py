"""End-to-end LM training (port of ``repro.launch.train``), on one
card.

    python -m repro_torch.launch.train --arch olmo-1b --steps 40 \\
        --batch 8 --seq 512 --ckpt-dir DIR

The train step (``launch.steps.make_train_step``: gradient accumulation,
AdamW at a cosine schedule) runs every attention through kernel 7 and its
hand-written backward; checkpoints are written in the background in the
reference's format (``checkpoint.ckpt``, either package reads them) with
auto-resume; the data stream is deterministic and seek-able
(``data.make_loader``), batches copied to the card from pinned memory.
``--fail-at N`` simulates a crash at step N (exit 17, after the
checkpoint in flight is written); rerunning resumes from the last
checkpoint.  ``--device cpu`` runs the kernels' plain versions on the CPU
(``--smoke`` for a reduced model).  ``main`` returns the losses.  The
reference's mesh has no counterpart: one card holds the run.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

from repro_torch.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.configs.base import get_config
from repro_torch.data import DataConfig, make_loader
from repro_torch.device import resolve_device
from repro_torch.launch import steps
from repro_torch.launch.serve import seed_generator
from repro_torch.models import model as mdl
from repro_torch.optim import adam_init, tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=0, help="simulate a crash at step N")
    ap.add_argument("--d-model", type=int, default=0, help="override width (e.g. ~100M model)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    overrides = {}
    if args.d_model:
        overrides.update(d_model=args.d_model, head_dim=0)
    if args.layers:
        overrides["num_layers"] = args.layers
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    device = resolve_device(args.device)

    adam_cfg = dataclasses.replace(steps.default_adam(cfg), lr=args.lr)
    train_step, _ = steps.make_train_step(
        cfg, adam_cfg, num_microbatches=args.microbatches,
        q_chunk=min(512, args.seq), total_steps=args.steps,
    )

    params = mdl.init_params(seed_generator(args.seed, 0, device), cfg,
                             device=device)
    opt_state = adam_init(params, adam_cfg)
    n_params = sum(x.numel() for x in tree_leaves(params))

    start_step = 0
    manager = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if manager is not None and latest_step(args.ckpt_dir) is not None:
        state_like = {"params": params, "opt": opt_state}
        restored = restore(args.ckpt_dir, state_like, device=device)
        params, opt_state = restored["params"], restored["opt"]
        start_step = latest_step(args.ckpt_dir) + 1
        print(f"[train] resumed from step {start_step - 1}")

    data_cfg = DataConfig(batch=args.batch, seq_len=args.seq,
                          vocab=cfg.vocab_size, seed=args.seed)
    loader = make_loader(data_cfg, model_cfg=cfg, start_step=start_step,
                         pin=device.type == "cuda")

    print(f"[train] arch={cfg.name} params={n_params:,} steps={start_step}..{args.steps}")
    t_last, losses = time.time(), []
    try:
        for step, batch in zip(range(start_step, args.steps), loader):
            if args.fail_at and step == args.fail_at:
                if manager is not None:
                    manager.wait()
                print(f"[train] SIMULATED FAILURE at step {step}", flush=True)
                sys.exit(17)
            batch = {k: x.to(device, non_blocking=True)
                     for k, x in batch.items()}
            params, opt_state, metrics = train_step(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
            if step % args.log_every == 0 or step == args.steps - 1:
                dt = (time.time() - t_last) / max(args.log_every, 1)
                t_last = time.time()
                print(f"  step {step:5d} loss={float(metrics['loss']):.4f} "
                      f"acc={float(metrics['accuracy']):.3f} gnorm={float(metrics['grad_norm']):.2f} "
                      f"lr={float(metrics['lr']):.2e} {dt*1e3:.0f}ms/step", flush=True)
            if manager is not None and step and step % args.ckpt_every == 0:
                manager.save_async(step, {"params": params, "opt": opt_state},
                                   extra={"arch": cfg.name})
    finally:
        loader.close()
    if manager is not None:
        manager.save_async(args.steps - 1, {"params": params, "opt": opt_state},
                           extra={"arch": cfg.name})
        manager.wait()
    if len(losses) > 20:
        first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
        print(f"[train] loss {first:.4f} -> {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
    return losses


if __name__ == "__main__":
    main()
