"""Fleet-axis layout planning for two-stage sharded scoring (port).

Counterpart of ``FleetLayout`` / ``plan_fleet_layout`` in
``repro.launch.mesh``, as pure planning: the port targets one card, so a
layout carries no device mesh and the two-stage program (per-shard top-k,
then a merge over ``shards × k`` candidates, ``sched.shard``) runs on that
card with a forced shard count.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class FleetLayout:
    """The fleet's N node columns as ``shards`` contiguous slices of
    ``shard_size`` nodes; the last slice is ragged when ``shards`` does not
    divide N (``padded = shards * shard_size`` >= N).  Hashable."""

    shards: int
    shard_size: int
    n_nodes: int

    @property
    def padded(self) -> int:
        return self.shards * self.shard_size


def plan_fleet_layout(n_nodes: int, *,
                      shards: Optional[int] = None) -> Optional[FleetLayout]:
    """The node-column split for ``shards`` shards of ``ceil(n / shards)``.

    ``None`` (run the unsharded program) for no forced count, a single
    shard, or a fleet smaller than the shard count — the reference's rules
    with no mesh."""
    if shards is None or shards <= 1 or n_nodes < shards:
        return None
    return FleetLayout(shards=shards, shard_size=-(-n_nodes // shards),
                       n_nodes=n_nodes)
