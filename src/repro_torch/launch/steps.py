"""Step functions (port of ``repro.launch.steps``): train (microbatched
gradient accumulation + AdamW), prefill, decode, for one card.

``make_train_step``'s step differentiates ``model.loss_and_metrics`` with
``torch.autograd.grad`` on the card's kernels: every attention goes
through kernel 7 and its hand-written backward, every selective scan
through kernel 6 and its backward.  The config's ``remat`` applies as in
the reference (``model``'s docstring): under "full" or "dots" each block
runs again inside the backward, so a step launches each forward kernel
twice for every backward launch.  The reference's ``q_chunk``,
``mamba_chunk`` and ``act_sharding`` set its memory and layout, not its
result, and are taken and ignored, as serving ignores them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as mdl
from repro_torch.optim import (AdamConfig, adam_init, adam_update,
                               tree_leaves, tree_map)
from repro_torch.optim.schedule import cosine_warmup


def default_adam(cfg: ModelConfig) -> AdamConfig:
    # moments in bf16 for the largest archs to bound optimizer memory
    big = cfg.param_count() > 60e9
    return AdamConfig(
        lr=3e-4,
        weight_decay=0.1,
        grad_clip_norm=1.0,
        moment_dtype="bfloat16" if big else "float32",
        master_dtype="" if big else "float32",
    )


def _split_blocks(params: dict) -> dict:
    """``params`` with the stacked ``layers`` (and the encoder's) as lists
    of per-block trees of views."""
    def blocks(stacked):
        n = tree_leaves(stacked)[0].shape[0]
        return [tree_map(lambda p, i=i: p[i], stacked) for i in range(n)]

    out = dict(params, layers=blocks(params["layers"]))
    if "encoder" in params:
        out["encoder"] = dict(params["encoder"],
                              layers=blocks(params["encoder"]["layers"]))
    return out


def _stack_blocks(tree: dict) -> dict:
    """The inverse of ``_split_blocks`` on a tree of gradients."""
    def stack(blocks):
        return tree_map(lambda *xs: torch.stack(xs), *blocks)

    out = dict(tree, layers=stack(tree["layers"]))
    if "encoder" in tree:
        out["encoder"] = dict(tree["encoder"],
                              layers=stack(tree["encoder"]["layers"]))
    return out


def value_and_grad(cfg: ModelConfig, params: dict, batch: dict,
                   attn_mode: Optional[str] = None):
    """(metrics, grads) of ``loss_and_metrics`` at ``params``: grads in the
    params' tree and dtypes, zeros for a leaf the loss does not reach (as
    under ``jax.grad``); metrics detached.  Each block's parameters enter
    as views of their own, so a block's gradient is written once, not
    rebuilt at the stacked size."""
    live = tree_map(lambda p: p.detach().requires_grad_(True),
                    _split_blocks(params))
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss, metrics = mdl.loss_and_metrics(live, cfg, batch,
                                             attn_mode=attn_mode)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    grads = _stack_blocks(tree_map(lambda _: next(it), live))
    return {k: m.detach() for k, m in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, adam_cfg: Optional[AdamConfig] = None,
                    num_microbatches: int = 1, q_chunk: int = 512,
                    mamba_chunk: int = 64, total_steps: int = 10000,
                    act_sharding=None, attn_mode: Optional[str] = None):
    """``(train_step, adam_cfg)``: ``train_step(params, opt_state, batch)
    -> (params, opt_state, metrics)``.  With ``num_microbatches`` > 1 the
    batch is split along its first axis, the gradients summed in float32
    and divided by the count, the metrics averaged.  AdamW at
    ``cosine_warmup(lr, 200, total_steps)``; its ``grad_norm`` and ``lr``
    join the metrics.  ``attn_mode`` is that of ``kernels.ops`` (None: the
    kernels on the card, the plain versions on the CPU)."""
    del q_chunk, mamba_chunk, act_sharding
    adam_cfg = adam_cfg or default_adam(cfg)
    schedule = cosine_warmup(adam_cfg.lr, 200, total_steps)

    def train_step(params, opt_state, batch):
        if num_microbatches > 1:
            b = batch["tokens"].shape[0]
            if b % num_microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{num_microbatches} microbatches")
            size = b // num_microbatches
            grads, metrics = None, []
            for i in range(num_microbatches):
                micro = {k: x[i * size:(i + 1) * size]
                         for k, x in batch.items()}
                m, g = value_and_grad(cfg, params, micro, attn_mode)
                g32 = tree_map(lambda x: x.to(torch.float32), g)
                grads = g32 if grads is None else tree_map(torch.add, grads,
                                                           g32)
                metrics.append(m)
            grads = tree_map(lambda g: g / num_microbatches, grads)
            metrics = {k: torch.stack([m[k] for m in metrics]).mean()
                       for k in metrics[0]}
        else:
            metrics, grads = value_and_grad(cfg, params, batch, attn_mode)
        params, opt_state, stats = adam_update(params, grads, opt_state,
                                               adam_cfg, schedule)
        metrics.update(stats)
        return params, opt_state, metrics

    return train_step, adam_cfg


def make_prefill_step(cfg: ModelConfig, q_chunk: int = 512,
                      mamba_chunk: int = 64, act_sharding=None,
                      attn_mode: Optional[str] = None):
    del q_chunk, mamba_chunk, act_sharding

    def prefill_step(params, batch):
        return mdl.prefill(params, cfg, batch["tokens"], batch,
                           attn_mode=attn_mode)

    return prefill_step


def make_decode_step(cfg: ModelConfig, q_chunk: int = 512, act_sharding=None,
                     mlp_sharding=None, attn_mode: Optional[str] = None):
    del q_chunk, act_sharding, mlp_sharding

    def decode_step(params, batch, cache, index):
        return mdl.decode_step(params, cfg, batch["tokens"], cache, index,
                               attn_mode=attn_mode)

    return decode_step


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     adam_cfg: Optional[AdamConfig] = None, device=None):
    """Random params drawn from ``gen`` and their AdamW state."""
    adam_cfg = adam_cfg or default_adam(cfg)
    params = mdl.init_params(gen, cfg, device=device)
    return params, adam_init(params, adam_cfg)


# per-arch microbatch sizes for train_4k (the reference's, for its
# 256-chip mesh; global batch 256)
TRAIN_MICROBATCH: Dict[str, int] = {
    "olmo-1b": 256,
    "granite-8b": 128,
    "qwen2-moe-a2.7b": 64,
    "whisper-medium": 256,
    "falcon-mamba-7b": 64,
    "dbrx-132b": 32,
    "internvl2-76b": 32,
    "command-r-plus-104b": 16,
    "jamba-1.5-large-398b": 16,
    "llama3-405b": 16,
}


def num_microbatches(arch: str, global_batch: int) -> int:
    micro = TRAIN_MICROBATCH.get(arch, 32)
    return max(1, global_batch // micro)
