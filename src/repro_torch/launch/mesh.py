"""Layout planning (port of ``repro.launch.mesh``): the fleet axis for
two-stage sharded scoring and the seed x env split of the training
engine's batch.

Both are pure planning.  The port targets one card, so a layout carries no
device mesh: the two-stage program (per-shard top-k, then a merge over
``shards × k`` candidates, ``sched.shard``) runs on that card with a forced
shard count, and ``train.engine.train_seeds`` runs its (seeds, envs) batch
unsharded, as the reference does under a one-device mesh.  The
reference's ``make_production_mesh``, ``make_host_mesh`` and
``make_train_mesh`` have no counterpart: one card runs no mesh.
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


@dataclasses.dataclass(frozen=True)
class SeedEnvLayout:
    """How ``train_seeds``'s (n_seeds, n_envs) batch splits over devices:
    the seed ladder over ``seed_shards`` device groups, each holding whole
    training replicas, and inside each group the per-seed env batch over
    ``env_shards`` devices.  Hashable."""

    seed_shards: int
    env_shards: int


def _split_seed_env(n_seeds: int, n_envs: int, n_dev: int) -> Optional[tuple]:
    """Factor ``n_dev = s * e`` with ``s | n_seeds`` and ``e | n_envs``,
    maximizing ``s`` (whole replicas per device are the cheapest layout:
    zero cross-device traffic until selection).  Returns ``None`` when the
    device count does not divide the total ``n_seeds * n_envs`` batch.

    Such a split always exists when ``n_seeds * n_envs % n_dev == 0``: for
    every prime power ``p^k`` of ``n_dev``, the seed axis takes
    ``min(k, multiplicity of p in n_seeds)`` factors and the env axis covers
    the remainder (which it can, since the product divides).
    """
    if n_dev <= 0 or (n_seeds * n_envs) % n_dev != 0:
        return None
    s, rem, p = 1, n_dev, 2
    while rem > 1:
        while rem % p == 0:
            if n_seeds % (s * p) == 0:
                s *= p
            rem //= p
        p += 1 if p == 2 else 2
    e = n_dev // s
    if n_envs % e != 0:  # unreachable when the product divides; kept as a guard
        return None
    return s, e


def plan_seed_env_layout(n_seeds: int, n_envs: int,
                         n_devices: Optional[int] = None
                         ) -> Optional[SeedEnvLayout]:
    """The joint seed x env split of a ``train_seeds`` launch over
    ``n_devices``: every device busy whenever the count divides ``n_seeds
    * n_envs``.  ``None`` means run unsharded: no device count, a single
    device, or an indivisible batch."""
    if n_devices is None or n_devices <= 1:
        return None
    split = _split_seed_env(n_seeds, n_envs, n_devices)
    if split is None:
        return None
    return SeedEnvLayout(*split)
