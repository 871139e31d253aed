"""On-device circular replay buffer (port of ``repro.core.replay``).

The store is ONE fused ``(..., n_slots, lane, n_features + 2)`` ring:
every transition's feature row, regression target and sample weight live
in a single tensor (``[feats | target | weight]``), so a training step
touches the buffer with one write and one gather.  Leading dimensions hold
independent rings (one per candidate seed) that advance together.

``lane`` is the caller's add width (``n_envs`` for the RL loop): with
``lane > 1`` every add is one whole slot and the write is a slice copy;
``lane = 1`` is the general transition-at-a-time ring.  Linear index ``i``
always means the ``i``-th stored transition, row-major over ``(slot,
lane)``, whatever the lane.

Differences from the reference: the write pointer and the live size are
host integers (every add's width is known on the host, so they never need
a device read), and the ring is written IN PLACE: the returned ``Replay``
shares its data tensor with the one passed in.  ``replay_sample`` takes
its indices from the caller (``core.draws``), not from a PRNG key.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.types import FEATURE_DIM
from repro_torch.device import resolve_device


class Replay(NamedTuple):
    data: torch.Tensor   # (..., n_slots, lane, n_features + 2)
    ptr: int             # next write position, in transitions
    size: int            # live transitions (<= capacity)

    @property
    def capacity(self) -> int:
        return self.data.shape[-3] * self.data.shape[-2]

    @property
    def lane(self) -> int:
        return self.data.shape[-2]

    @property
    def n_features(self) -> int:
        return self.data.shape[-1] - 2

    def flat(self) -> torch.Tensor:
        """(..., capacity, n_features + 2) view of the ring."""
        return self.data.reshape(self.data.shape[:-3] + (self.capacity, -1))

    @property
    def feats(self) -> torch.Tensor:
        return self.flat()[..., : self.n_features]

    @property
    def targets(self) -> torch.Tensor:
        return self.flat()[..., self.n_features]

    @property
    def weights(self) -> torch.Tensor:
        return self.flat()[..., self.n_features + 1]


def replay_init(capacity: int, n_features: int = FEATURE_DIM, lane: int = 1,
                batch: Tuple[int, ...] = (), device=None) -> Replay:
    """Empty ring of ``capacity`` transitions (``batch``: leading ring
    dimensions).  ``lane`` must divide ``capacity``, and every later add
    must be a multiple of it."""
    if lane < 1 or capacity % lane != 0:
        raise ValueError(f"lane {lane} must divide capacity {capacity}")
    device = resolve_device(device)
    data = torch.zeros(tuple(batch) + (capacity // lane, lane, n_features + 2),
                       dtype=torch.float32, device=device)
    return Replay(data=data, ptr=0, size=0)


def replay_add(buf: Replay, feats: torch.Tensor, targets: torch.Tensor,
               weights: Optional[torch.Tensor] = None,
               n_valid: Optional[int] = None) -> Replay:
    """feats: (..., B, F); targets: (..., B); weights: (..., B) or None
    (= all 1).  A zero weight stores a transition that never trains (a
    dropped arrival).

    ``B == lane`` writes one whole slot (the pointer is lane-aligned, so
    it never straddles the wrap); any other multiple of the lane scatters
    to the same linear positions, and an add wider than the ring keeps its
    last ``capacity`` rows.  ``n_valid`` (a host int, lane-1 rings only)
    stores the first ``n_valid`` rows and leaves the rest of the ring
    untouched."""
    b = feats.shape[-2]
    lane, cap = buf.lane, buf.capacity
    if b % lane != 0:
        raise ValueError(
            f"add of {b} transitions into a lane-{lane} ring (adds must be "
            f"multiples of the lane to keep the write pointer aligned)")
    if weights is None:
        weights = torch.ones(feats.shape[:-1], dtype=torch.float32,
                             device=feats.device)
    rows = torch.cat([feats.to(torch.float32),
                      targets.to(torch.float32)[..., None],
                      weights.to(torch.float32)[..., None]], dim=-1)
    flat = buf.flat()
    if n_valid is not None:
        if lane != 1:
            raise ValueError("n_valid masked adds require a lane-1 ring")
        if b > cap:
            raise ValueError(f"masked add of {b} rows exceeds capacity {cap}")
        n_valid = int(n_valid)
        idx = (buf.ptr + torch.arange(n_valid, device=flat.device)) % cap
        flat[..., idx, :] = rows[..., :n_valid, :]
        return Replay(buf.data, (buf.ptr + n_valid) % cap,
                      min(buf.size + n_valid, cap))
    if b == lane and lane > 1:
        slot = (buf.ptr // lane) % buf.data.shape[-3]
        buf.data[..., slot, :, :] = rows
    else:
        # an add wider than the ring keeps only its last `cap` transitions,
        # so every index is written once
        skip = max(b - cap, 0)
        idx = (buf.ptr + skip + torch.arange(b - skip, device=flat.device)) % cap
        flat[..., idx, :] = rows[..., skip:, :]
    return Replay(buf.data, (buf.ptr + b) % cap, min(buf.size + b, cap))


def replay_sample(buf: Replay, idx: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rows ``idx (..., batch)`` (uniform draws from ``[0, max(size, 1))``,
    ``draws.replay_indices``) as ``(feats, targets, weights)``; the weights
    are zero while the ring is empty.  One gather for all three."""
    nf = buf.n_features
    flat = buf.flat()
    rows = torch.take_along_dim(flat, idx.to(torch.int64)[..., None], dim=-2)
    valid = rows[..., nf + 1] * float(buf.size > 0)
    return rows[..., :nf], rows[..., nf], valid
