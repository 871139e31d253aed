"""The LM (port of ``repro.models.model``): every family, dense, moe,
ssm, hybrid, vlm and audio (encoder-decoder), for training and inference.

Layers are grouped into *blocks* (the repeating unit: one layer, or a
period of ``attn_period`` layers for jamba) whose parameters are stacked
over blocks, ``(nb, ...)``, in the reference's tree, so
``convert.lm_params_from_numpy`` is a tree map.  Where the reference scans
over the stacked blocks (``lax.scan``), the port loops over them in
Python (``scan_layers`` sets how the reference compiles, and the port
takes and ignores it).  ``params["layers"]`` (and the encoder's) may also
be a list of per-block trees: ``launch.steps`` trains on such a list of
views, so that each block's gradient is a tensor of its own and not a
stacked one rebuilt per block.

Rematerialization follows ``cfg.remat`` as the reference's
``_remat_policy`` maps it, one block (with its aux loss) a region, in the
decoder stack and in whisper's encoder alike, and only in a forward that
autograd records (``mode`` "train" under grad mode; prefill and decode
run as they are): "none" keeps every activation; "full" (and any other
value) runs each block under ``torch.utils.checkpoint`` (non-reentrant,
so ``torch.autograd.grad`` takes it) and keeps only its inputs, the block
running again inside the backward, kernels 7 and 6 with it, up to the
last tensor the backward saved (a block's last product, the MLP's or the
mixer's output projection, is not run again: the backward needs its
inputs, not its output); "dots" keeps
the outputs of the products with no batch dimensions, the projections
(``aten.mm``, ``aten.addmm``), and recomputes the rest, batched products
(``aten.bmm``: the MoE experts, the plain attention), kernels 7 and 6,
norms and elementwise work: ``checkpoint_dots_with_no_batch_dims``' rule.

The decode cache has, per sub-layer and stacked over blocks, ``k`` and
``v`` (nb, B, max_len, Hkv, hd) for attention, ``conv`` (nb, B, cw - 1,
di) and ``h`` (nb, B, di, N) float32 for a mamba mixer, and ``xk`` and
``xv`` (nb, B, enc_seq, Hkv, hd), the encoder's keys and values, for
cross-attention.  ``decode_step`` writes the new token's K/V and the new
mamba state into it IN PLACE (the reference returns a new cache, which on
the card would copy the whole cache every step) and returns the same dict.

The reference's quirks are kept: cross-attention's keys and values carry
no bias even where ``use_bias`` holds (``_cross_kv``), and prefill returns
the conv state in bfloat16 even in a float32 run.

Public entry points: init_params, init_cache, forward, loss_and_metrics
(train), prefill, decode_step, logits_from_hidden.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch import kernels
from repro_torch.models import layers, mamba, moe


@dataclasses.dataclass(frozen=True)
class SubLayer:
    mixer: str  # "attn" | "mamba"
    ffn: str    # "mlp" | "moe" | "none"
    cross: bool = False  # enc-dec cross attention after the mixer
    causal: bool = True


ENCODER_SPEC = [SubLayer("attn", "mlp", causal=False)]


def block_spec(cfg: ModelConfig) -> List[SubLayer]:
    """The repeating sub-layer structure of one block (decoder side)."""
    if cfg.family == "ssm":
        return [SubLayer("mamba", "none")]  # mamba-1 blocks have no separate FFN
    if cfg.attn_period:  # hybrid (jamba)
        subs = []
        for j in range(cfg.attn_period):
            mixer = "attn" if j % cfg.attn_period == cfg.attn_offset else "mamba"
            use_moe = cfg.moe_num_experts and (j % cfg.moe_every == cfg.moe_every - 1)
            subs.append(SubLayer(mixer, "moe" if use_moe else "mlp"))
        return subs
    ffn = "moe" if cfg.moe_num_experts else "mlp"
    return [SubLayer("attn", ffn, cross=cfg.is_encoder_decoder)]


def num_blocks(cfg: ModelConfig) -> int:
    spec = block_spec(cfg)
    assert cfg.num_layers % len(spec) == 0, (cfg.num_layers, len(spec))
    return cfg.num_layers // len(spec)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


E4M3_MAX_ROUNDED = 464.0   # the largest |x| that rounds to e4m3's 448


def cache_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in the cache's ``dtype``, rounded as the reference's
    ``astype`` rounds: to nearest even, and for ``float8_e4m3fn`` (no
    infinity) every value past the range, infinities included, becomes
    NaN of its sign, where PyTorch's cast saturates to +-448."""
    y = x.to(dtype)
    if dtype != torch.float8_e4m3fn:
        return y
    over = x.abs() > E4M3_MAX_ROUNDED      # exact in bfloat16 and float32
    bits = y.view(torch.uint8)
    return torch.where(over, bits | 0x7F, bits).view(dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_sublayer(gen, sub: SubLayer, cfg: ModelConfig, dtype,
                   device) -> dict:
    p: Dict[str, Any] = {
        "norm1": layers.init_norm(cfg.norm, cfg.d_model, dtype, device)}
    if sub.mixer == "attn":
        p["attn"] = layers.init_attention(gen, cfg, dtype, device)
    else:
        p["mamba"] = mamba.init_mamba(gen, cfg, dtype, device)
    if sub.cross:
        p["cross_norm"] = layers.init_norm(cfg.norm, cfg.d_model, dtype,
                                           device)
        p["cross"] = layers.init_attention(gen, cfg, dtype, device)
    if sub.ffn != "none":
        p["norm2"] = layers.init_norm(cfg.norm, cfg.d_model, dtype, device)
        if sub.ffn == "moe":
            p["moe"] = moe.init_moe(gen, cfg, dtype, device)
        else:
            p["mlp"] = layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act,
                                       dtype, cfg.num_layers, device)
    return p


def _stack(trees: List[Any]):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """Random weights drawn from ``gen`` (on its device), in the
    reference's tree with leaves stacked over blocks, on ``device``."""
    spec = block_spec(cfg)
    dtype = _dtype(cfg.param_dtype)
    nb = num_blocks(cfg)
    params: Dict[str, Any] = {
        "embed": layers.embed_init(gen, (cfg.padded_vocab, cfg.d_model), dtype,
                                   device),
        "final_norm": layers.init_norm(cfg.norm, cfg.d_model, dtype, device),
        "layers": {
            f"sub{j}": _stack([_init_sublayer(gen, sub, cfg, dtype, device)
                               for _ in range(nb)])
            for j, sub in enumerate(spec)
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(
            gen, (cfg.d_model, cfg.padded_vocab), dtype,
            scale=cfg.d_model ** -0.5, device=device)
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "layers": {"sub0": _stack([
                _init_sublayer(gen, ENCODER_SPEC[0], cfg, dtype, device)
                for _ in range(cfg.enc_layers)])},
            "final_norm": layers.init_norm(cfg.norm, cfg.d_model, dtype,
                                           device),
        }
    return params


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    """Decode cache: per sub-layer, stacked over blocks, zeros (the mamba
    state ``h`` float32, the rest in ``dtype``, the config's cache dtype by
    default)."""
    dtype = dtype or _dtype(cfg.cache_dtype)
    nb = num_blocks(cfg)
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    def zeros(*shape, dt=dtype):
        return torch.zeros((nb, batch) + shape, dtype=dt, device=device)

    cache: Dict[str, Any] = {}
    for j, sub in enumerate(block_spec(cfg)):
        c: Dict[str, Any] = {}
        if sub.mixer == "attn":
            c["k"] = zeros(max_len, hkv, hd)
            c["v"] = zeros(max_len, hkv, hd)
        else:
            c["conv"] = zeros(cfg.ssm_conv - 1, cfg.d_inner)
            c["h"] = zeros(cfg.d_inner, cfg.ssm_state, dt=torch.float32)
        if sub.cross:
            c["xk"] = zeros(cfg.enc_seq, hkv, hd)
            c["xv"] = zeros(cfg.enc_seq, hkv, hd)
        cache[f"sub{j}"] = c
    return cache


# ---------------------------------------------------------------------------
# forward machinery
# ---------------------------------------------------------------------------


def _embed_tokens(params, cfg, tokens, extra: Optional[dict]) -> torch.Tensor:
    x = params["embed"][tokens]  # (B, S, D)
    if cfg.num_vision_tokens and extra is not None and "patch_embeds" in extra:
        pe = extra["patch_embeds"]
        x = torch.cat([pe.to(x.dtype), x[:, pe.shape[1]:]], dim=1)
    return x


def _sinusoidal(seq: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def _run_attn(sp, x, cfg, *, positions, causal, cache_kv=None,
              cache_index=None, collect_kv=False, attn_mode=None):
    """One self-attention sub-layer (prefill or decode)."""
    q, k, v = layers.attention_qkv(sp, x, cfg)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    new_kv = None
    if cache_kv is not None:  # decode: write in place, then attend
        ck, cv = cache_kv
        ck[:, cache_index:cache_index + 1] = cache_cast(k, ck.dtype)
        cv[:, cache_index:cache_index + 1] = cache_cast(v, cv.dtype)
        o = layers.attention(q, ck, cv, causal=False, kv_len=cache_index + 1,
                             q_offset=cache_index, mode=attn_mode)
    else:
        o = layers.attention(q, k, v, causal=causal,
                             causal_buckets=cfg.causal_buckets,
                             mode=attn_mode)
        if collect_kv:
            new_kv = (k, v)
    return layers.attention_out(sp, o), new_kv


def _run_cross(sp, x, cfg, kv, attn_mode=None):
    """Cross-attention of x's queries (no RoPE) against the encoder's K/V
    (kernel 7 at prefill, kernel 8 for the one decode token)."""
    o = layers.attention(layers.attention_q(sp, x, cfg), *kv, causal=False,
                         mode=attn_mode)
    return layers.attention_out(sp, o)


def _cross_kv(sp, enc_out, cfg):
    """The encoder's keys and values for one cross-attention sub-layer,
    with NO bias even where ``cfg.use_bias`` holds, as the reference's
    (``repro/models/model.py:181-186``)."""
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    b, s, _ = enc_out.shape
    k = (enc_out @ sp["wk"]).reshape(b, s, hkv, hd)
    v = (enc_out @ sp["wv"]).reshape(b, s, hkv, hd)
    return k, v


def _block_fn(bp, x, cfg, spec, *, mode, positions, block_cache=None,
              cache_index=None, enc_out=None, attn_mode=None):
    """Run one block (all sub-layers).  Returns (x, {sub: prefill cache
    leaves}, aux loss).  In decode mode the block's cache is written in
    place."""
    new_cache: Dict[str, Any] = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for j, sub in enumerate(spec):
        sp = bp[f"sub{j}"]
        sc = block_cache[f"sub{j}"] if block_cache is not None else None
        nc: Dict[str, Any] = {}
        h = layers.apply_norm(cfg.norm, sp["norm1"], x)
        if sub.mixer == "attn":
            out, kv = _run_attn(
                sp["attn"], h, cfg, positions=positions, causal=sub.causal,
                cache_kv=(sc["k"], sc["v"]) if mode == "decode" else None,
                cache_index=cache_index, collect_kv=mode == "prefill",
                attn_mode=attn_mode)
            if mode == "prefill":
                nc["k"], nc["v"] = kv
        elif mode == "decode":
            out, (conv, hstate) = mamba.decode_mamba(sp["mamba"], h, cfg,
                                                     (sc["conv"], sc["h"]))
            sc["conv"].copy_(conv)
            sc["h"].copy_(hstate)
        else:
            out, (conv, hstate) = mamba.apply_mamba(sp["mamba"], h, cfg,
                                                    mode=attn_mode)
            if mode == "prefill":      # bfloat16 even in a float32 run
                nc["conv"], nc["h"] = conv.to(torch.bfloat16), hstate
        x = x + out

        if sub.cross:
            hc = layers.apply_norm(cfg.norm, sp["cross_norm"], x)
            if mode == "decode":
                kv = (sc["xk"], sc["xv"])
            else:
                kv = _cross_kv(sp["cross"], enc_out, cfg)
                if mode == "prefill":
                    nc["xk"], nc["xv"] = kv
            x = x + _run_cross(sp["cross"], hc, cfg, kv, attn_mode)

        if sub.ffn != "none":
            h2 = layers.apply_norm(cfg.norm, sp["norm2"], x)
            if sub.ffn == "moe":
                out = moe.apply_moe(sp["moe"], h2, cfg)
                if mode == "train":
                    aux = aux + moe.load_balance_loss(sp["moe"]["router"], h2,
                                                      cfg.moe_top_k)
            else:
                out = layers.apply_mlp(sp["mlp"], h2, cfg.act)
            x = x + out
        new_cache[f"sub{j}"] = nc
    return x, new_cache, aux


def _index(tree, i: int):
    """Block ``i`` of a tree stacked over blocks (views, no copies), or
    entry ``i`` of a list of per-block trees."""
    if isinstance(tree, list):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# the products with no batch dimensions: the projections reach these
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in DOT_OPS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_policy(cfg: ModelConfig) -> Optional[str]:
    """The reference's ``_remat_policy``: None for "none" (no checkpoint),
    "dots" for "dots", "full" (nothing saved) for every other value."""
    if cfg.remat == "none":
        return None
    return "dots" if cfg.remat == "dots" else "full"


def checkpointed(policy: Optional[str], fn, *args):
    """``fn(*args)`` under ``policy``'s checkpoint (None: none).  The
    blocks draw no random numbers, so no generator state is kept for the
    recompute."""
    if policy is None:
        return fn(*args)
    context = {} if policy == "full" else {"context_fn": functools.partial(
        _ckpt.create_selective_checkpoint_contexts, _save_dots)}
    return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                            preserve_rng_state=False, **context)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _encode(params, cfg: ModelConfig, frames: torch.Tensor,
            attn_mode=None, policy: Optional[str] = None) -> torch.Tensor:
    """The whisper encoder over precomputed (stub) frame embeddings
    (B, enc_seq, D): sinusoidal positions added in the frames' dtype, then
    the stack in the weights' dtype, non-causal (kernel 7), each layer
    under ``policy``'s checkpoint."""
    x = frames + _sinusoidal(frames.shape[1], cfg.d_model,
                             frames.device).to(frames.dtype)
    x = x.to(params["embed"].dtype)
    positions = torch.arange(frames.shape[1], device=x.device)
    enc = params["encoder"]
    for i in range(cfg.enc_layers):
        x, _, _ = checkpointed(policy, functools.partial(
            _block_fn, _index(enc["layers"], i), cfg=cfg, spec=ENCODER_SPEC,
            mode="train", positions=positions, attn_mode=attn_mode), x)
    return layers.apply_norm(cfg.norm, enc["final_norm"], x)


def _stack_cache(blocks: List[dict]) -> dict:
    """[{sub: {leaf: (B, ...)}} per block] -> {sub: {leaf: (nb, B, ...)}}."""
    return {sub: {leaf: torch.stack([blk[sub][leaf] for blk in blocks])
                  for leaf in blocks[0][sub]}
            for sub in blocks[0]}


def forward(params, cfg: ModelConfig, tokens: torch.Tensor,
            extra: Optional[dict] = None, *, mode: str = "train", cache=None,
            cache_index: Optional[int] = None, attn_mode: Optional[str] = None):
    """Returns (hidden_states, cache, aux_loss).

    ``mode`` "train" runs the prompt, "prefill" also returns its cache
    (K/V (nb, B, S, Hkv, hd), the mamba states, the encoder's K/V), and
    "decode" runs one token per row at position ``cache_index`` against
    ``cache``, written in place and returned.  An encoder-decoder arch
    takes its encoder input as ``extra["frames"]`` (B, enc_seq, D) in
    train and prefill.  ``attn_mode`` picks the kernels' mode
    (``kernels.ops``) for attention and the selective scan alike.  A
    "train" forward under grad mode runs each block under ``cfg.remat``'s
    checkpoint (the module's docstring).
    """
    spec = block_spec(cfg)
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got {mode!r}")
    policy = (_remat_policy(cfg) if mode == "train" and torch.is_grad_enabled()
              else None)
    x = _embed_tokens(params, cfg, tokens, extra)
    enc_out = None
    if cfg.is_encoder_decoder and mode != "decode":
        if not extra or "frames" not in extra:
            raise ValueError(
                f"{cfg.name} is an encoder-decoder: {mode} needs the encoder "
                f"input extra['frames'] (B, {cfg.enc_seq}, {cfg.d_model})")
        enc_out = _encode(params, cfg, extra["frames"], attn_mode, policy)
    if mode == "decode":
        cache_index = int(cache_index)
        positions = torch.full((1,), cache_index, device=x.device)
    else:
        positions = torch.arange(tokens.shape[1], device=x.device)
    blocks = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(num_blocks(cfg)):
        x, nc, a = checkpointed(policy, functools.partial(
            _block_fn, _index(params["layers"], i), cfg=cfg, spec=spec,
            mode=mode, positions=positions,
            block_cache=_index(cache, i) if mode == "decode" else None,
            cache_index=cache_index, enc_out=enc_out, attn_mode=attn_mode), x)
        aux = aux + a
        blocks.append(nc)
    x = layers.apply_norm(cfg.norm, params["final_norm"], x)
    new_cache = (cache if mode == "decode" else
                 _stack_cache(blocks) if mode == "prefill" else None)
    return x, new_cache, aux


class _Float32Product(torch.autograd.Function):
    """x2 (T, D) @ head (D, V) in x's dtype with a float32 result, not
    rounded to x's dtype (``torch.mm``'s ``out_dtype``, which has no
    derivative): the backward's two products take the float32 output
    gradient rounded to x's dtype, as mixed-precision training does."""

    @staticmethod
    def forward(ctx, x2, head):
        ctx.save_for_backward(x2, head)
        return torch.mm(x2, head, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        x2, head = ctx.saved_tensors
        grad = grad.to(x2.dtype)
        dx = grad @ head.t() if ctx.needs_input_grad[0] else None
        dhead = x2.t() @ grad if ctx.needs_input_grad[1] else None
        return dx, dhead


def logits_from_hidden(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, S, Vp) float32 logits: the product accumulates in float32 and is
    not rounded to the weights' dtype (``preferred_element_type``)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    if x.dtype == torch.float32 or not kernels.on_card(x.device):
        out = x2.to(torch.float32) @ head.to(torch.float32)
    else:
        out = _Float32Product.apply(x2, head)
    return out.reshape(b, s, -1)


def loss_and_metrics(params, cfg: ModelConfig, batch: dict, *,
                     q_chunk: int = 512, mamba_chunk: int = 64,
                     aux_weight: float = 0.01, z_weight: float = 1e-4,
                     act_sharding=None, attn_mode: Optional[str] = None):
    """Causal-LM loss and its metrics.  ``batch``: ``tokens`` and
    ``targets`` (B, S) int64, optionally ``loss_mask`` (B, S) float32 and
    the encoder's ``frames`` or the vlm's ``patch_embeds``.  Returns (loss,
    {"loss", "ce", "zloss", "aux", "accuracy"}), () float32 tensors: the
    masked mean cross-entropy of the float32 logits, plus ``z_weight``
    times the mean squared log-partition and ``aux_weight`` times the MoE
    load-balancing loss summed over the blocks.  ``q_chunk``,
    ``mamba_chunk`` and ``act_sharding`` set the reference's memory and
    layout, not its result; the port takes and ignores them."""
    del q_chunk, mamba_chunk, act_sharding
    x, _, aux = forward(params, cfg, batch["tokens"], batch, mode="train",
                        attn_mode=attn_mode)
    logits = logits_from_hidden(params, cfg, x)            # (B, S, Vp) f32
    targets = batch["targets"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    nll = logz - gold
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(nll)
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = (nll * mask).sum() / denom
    zloss = (torch.square(logz) * mask).sum() / denom
    loss = ce + z_weight * zloss + aux_weight * aux
    correct = (logits.argmax(dim=-1) == targets).to(mask.dtype)
    metrics = {"loss": loss, "ce": ce, "zloss": zloss, "aux": aux,
               "accuracy": (correct * mask).sum() / denom}
    return loss, metrics


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor,
            extra: Optional[dict] = None, *, attn_mode: Optional[str] = None):
    """Run the prompt, return (last-token logits (B, Vp) float32, the
    prompt's cache: K/V (nb, B, S, Hkv, hd), mamba ``conv`` (bfloat16) and
    ``h``, cross-attention ``xk`` / ``xv``)."""
    x, cache, _ = forward(params, cfg, tokens, extra, mode="prefill",
                          attn_mode=attn_mode)
    return logits_from_hidden(params, cfg, x[:, -1:])[:, 0], cache


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache,
                cache_index: int, *, attn_mode: Optional[str] = None):
    """One token: tokens (B, 1), ``cache_index`` = #tokens already cached.
    Writes the token's K/V and the mamba states into ``cache`` in place.  Returns (logits
    (B, Vp) float32, cache)."""
    x, cache, _ = forward(params, cfg, tokens, mode="decode", cache=cache,
                          cache_index=cache_index, attn_mode=attn_mode)
    return logits_from_hidden(params, cfg, x[:, -1:])[:, 0], cache
