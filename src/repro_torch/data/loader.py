"""Data loading with background prefetch (port of ``repro.data.loader``).

Two sources: the synthetic stream (default) and a memmapped token file
(``.bin`` of uint16 / uint32 tokens), whose batch order is the
reference's ``np.random.RandomState(seed).permutation``, so the port reads
the reference's batches exactly.  Each host keeps its slice of the global
batch (``host_index`` of ``host_count``).  A background thread keeps a
small queue full; batches are CPU tensors (pinned with ``pin``), and the
train loop copies them to the card.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.data.synthetic import synthetic_batches


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch: int = 8
    seq_len: int = 512
    vocab: int = 50304
    seed: int = 0
    token_file: Optional[str] = None
    token_dtype: str = "uint16"
    prefetch: int = 2
    host_index: int = 0
    host_count: int = 1


def _memmap_batches(cfg: DataConfig, start_step: int
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    data = np.memmap(cfg.token_file, dtype=np.dtype(cfg.token_dtype),
                     mode="r")
    tokens_per_batch = cfg.batch * (cfg.seq_len + 1)
    n_batches = len(data) // tokens_per_batch
    order = np.random.RandomState(cfg.seed).permutation(n_batches)
    step = start_step
    while True:
        idx = order[step % n_batches]
        flat = np.asarray(data[idx * tokens_per_batch:
                               (idx + 1) * tokens_per_batch])
        toks = torch.from_numpy(
            flat.reshape(cfg.batch, cfg.seq_len + 1).astype(np.int64))
        yield {"tokens": toks[:, :-1], "targets": toks[:, 1:],
               "loss_mask": torch.ones((cfg.batch, cfg.seq_len),
                                       dtype=torch.float32)}
        step += 1


def _host_slice(batch: Dict[str, torch.Tensor], cfg: DataConfig
                ) -> Dict[str, torch.Tensor]:
    if cfg.host_count == 1:
        return batch
    per_host = batch["tokens"].shape[0] // cfg.host_count
    lo = cfg.host_index * per_host
    return {k: x[lo:lo + per_host] for k, x in batch.items()}


def make_loader(cfg: DataConfig, model_cfg=None, start_step: int = 0,
                pin: bool = False) -> Iterator[dict]:
    """Prefetching iterator over this host's training batches from
    ``start_step`` on; ``pin`` pins each batch's tensors (for an
    asynchronous copy to the card).  ``close()`` stops the thread."""
    if cfg.token_file:
        source = _memmap_batches(cfg, start_step)
    else:
        source = synthetic_batches(cfg.seed, cfg.batch, cfg.seq_len,
                                   cfg.vocab, cfg=model_cfg,
                                   start_step=start_step)

    q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)
    stop = threading.Event()

    def worker():
        try:
            for item in source:
                item = _host_slice(item, cfg)
                if pin:
                    item = {k: x.contiguous().pin_memory()
                            for k, x in item.items()}
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 - surface to the consumer
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            return item

        def close(self):
            stop.set()
            t.join()

    return _Iter()
