"""Deterministic synthetic LM data (port of ``repro.data.synthetic``).

A structured pseudo-language: Zipfian first tokens and a Markov map
``t -> 37 t + 11`` with a 15% resample, so that the loss falls in a short
run (uniform tokens give no signal).  ``synthetic_lm_tokens`` is a pure
function of its unit draws; ``synthetic_batches`` draws them from a
``torch.Generator`` seeded per step from ``np.random.SeedSequence([seed,
step])``, so the stream is seek-able by ``start_step`` (resume).  The
reference draws from JAX's threefry keys, which PyTorch cannot replay:
the tests feed both packages the reference's own draws.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

RESAMPLE = 0.15


def step_generator(seed: int, step: int, stream: int = 0) -> torch.Generator:
    """A CPU generator for ``stream`` of step ``step`` of ``seed``: 0 the
    tokens' draws, 1 the encoder frames, 2 the vlm patch embeds."""
    key = [seed, step] + ([stream] if stream else [])
    state = np.random.SeedSequence(key).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def synthetic_lm_tokens(u, noise, vocab: int) -> torch.Tensor:
    """(batch, seq_len) int64 tokens from unit draws: ``u`` (batch,) sets
    the Zipfian first tokens, ``noise`` (batch, seq_len) the resamples
    (float32 either, tensors or arrays).  t_{i+1} = (37 t_i + 11) mod V,
    or (17 t_i + i) mod V where ``noise[:, i] < 0.15``, with V = min(vocab,
    32768); token i is t_{i+1}."""
    v_eff = min(vocab, 32768)
    if not isinstance(u, torch.Tensor):
        u = torch.from_numpy(np.array(u, np.float32))
    u = u.to(device="cpu", dtype=torch.float32)
    log_v = torch.log(torch.tensor(1.0 + v_eff, dtype=torch.float32))
    first = (v_eff * (torch.exp(u * log_v) - 1.0) / v_eff).to(torch.int32)
    tok = (first % v_eff).numpy().astype(np.int64)
    resample = np.asarray(noise, np.float32) < np.float32(RESAMPLE)
    out = np.empty(resample.shape, np.int64)
    for i in range(resample.shape[1]):        # integer map: exact in int64
        tok = np.where(resample[:, i], (tok * 17 + i) % v_eff,
                       (tok * 37 + 11) % v_eff)
        out[:, i] = tok
    return torch.from_numpy(out)


def _side_normal(seed, step, stream, shape) -> torch.Tensor:
    """0.02 N(0, 1) in bfloat16 from a side stream (the reference's
    ``0.02 * normal(..., bfloat16)``)."""
    x = torch.randn(shape, generator=step_generator(seed, step, stream))
    return x.to(torch.bfloat16) * 0.02


def synthetic_batches(seed: int, batch: int, seq_len: int, vocab: int,
                      cfg=None, start_step: int = 0
                      ) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite iterator of CPU train batches from ``start_step`` on:
    ``tokens``, ``targets`` (batch, seq_len) int64 (one stream shifted by
    one), ``loss_mask`` ones; an encoder-decoder ``cfg`` adds ``frames``
    (batch, enc_seq, d_model), a vlm ``patch_embeds`` (batch,
    num_vision_tokens, d_model), both bfloat16."""
    step = start_step
    while True:
        gen = step_generator(seed, step)
        u = torch.rand((batch,), generator=gen)
        noise = torch.rand((batch, seq_len + 1), generator=gen)
        toks = synthetic_lm_tokens(u, noise, vocab)
        out = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
               "loss_mask": torch.ones((batch, seq_len), dtype=torch.float32)}
        if cfg is not None and cfg.is_encoder_decoder:
            out["frames"] = _side_normal(seed, step, 1,
                                         (batch, cfg.enc_seq, cfg.d_model))
        if cfg is not None and cfg.num_vision_tokens:
            out["patch_embeds"] = _side_normal(
                seed, step, 2, (batch, cfg.num_vision_tokens, cfg.d_model))
        yield out
        step += 1
