"""Stand-ins for every model input of an (arch x shape) cell (port of
``repro.launch.shapes``): fake tensors, with shapes and dtypes and no
storage, in place of the reference's ``ShapeDtypeStruct``s.

Each function builds under ``mode``, a
``torch._subclasses.fake_tensor.FakeTensorMode`` (a fresh one when none is
given), so that a dry run can trace a step on the tensors it returns
(``launch.dryrun``).  The trees are the model's own: ``params_specs`` runs
``models.model.init_params`` and ``decode_specs`` ``init_cache`` on fake
tensors, so no second description of the model can drift from it;
llama3-405b's 405.85 B parameters cost no storage.  The modality frontends
are stubs, as in the reference: whisper takes precomputed frame
embeddings (``frames``), internvl precomputed patch embeddings
(``patch_embeds``), both bfloat16.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as mdl


def _under(mode: Optional[FakeTensorMode]):
    return mode if mode is not None else FakeTensorMode()


def _sds(shape, dtype) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` on the CPU (fake under a
    ``FakeTensorMode``)."""
    return torch.empty(shape, dtype=dtype)


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                      mode: Optional[FakeTensorMode] = None) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    with _under(mode):
        batch = {
            "tokens": _sds((b, s), torch.int32),
            "targets": _sds((b, s), torch.int32),
            "loss_mask": _sds((b, s), torch.float32),
        }
        if cfg.is_encoder_decoder:
            batch["frames"] = _sds((b, cfg.enc_seq, cfg.d_model),
                                   torch.bfloat16)
        if cfg.num_vision_tokens:
            batch["patch_embeds"] = _sds((b, cfg.num_vision_tokens,
                                          cfg.d_model), torch.bfloat16)
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                        mode: Optional[FakeTensorMode] = None
                        ) -> Dict[str, Any]:
    batch = train_batch_specs(cfg, shape, mode)
    del batch["targets"], batch["loss_mask"]
    return batch


def decode_specs(cfg: ModelConfig, shape: ShapeConfig,
                 mode: Optional[FakeTensorMode] = None
                 ) -> Tuple[Dict[str, Any], Any, Any]:
    """(token specs, cache specs, index spec) for one decode step with a
    KV/SSM cache of seq_len."""
    b, s = shape.global_batch, shape.seq_len
    with _under(mode):
        tokens = {"tokens": _sds((b, 1), torch.int32)}
        cache = mdl.init_cache(cfg, b, s, device="cpu")
        index = _sds((), torch.int32)
    return tokens, cache, index


def params_specs(cfg: ModelConfig,
                 mode: Optional[FakeTensorMode] = None) -> Any:
    """``init_params``' tree on fake tensors: its keys, shapes and dtypes,
    with no storage and no draw made."""
    with _under(mode):
        return mdl.init_params(torch.Generator(), cfg, device="cpu")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, kind: str = None,
                mode: Optional[FakeTensorMode] = None) -> Dict[str, Any]:
    """The public entry: all model inputs for an (arch, shape) cell."""
    kind = kind or shape.kind
    if kind == "train":
        return {"batch": train_batch_specs(cfg, shape, mode)}
    if kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, shape, mode)}
    tokens, cache, index = decode_specs(cfg, shape, mode)
    return {"batch": tokens, "cache": cache, "index": index}

