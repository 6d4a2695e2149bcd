"""Device mesh construction for sharded rendering.

The reference has zero parallelism (one CPU thread, SURVEY.md §2.2); this
framework's scaling axes are data-parallel **tiles** (pixel blocks) and
**spp** (samples-per-pixel shards) over a ``jax.sharding.Mesh``
[BASELINE.json:5 "rays/tiles sharded over the device mesh"].  Scene SoA and
BVH are replicated.  The communication backend is XLA collectives (NCCL on
GPUs) — never hand-rolled transport (SURVEY.md §5.8).  The cards of one
host are joined all to all, so the mesh shape follows the algorithm, not
the wiring.

Multi-host: ``initialize_distributed`` wraps ``jax.distributed.initialize``;
each process contributes its local devices to the same global mesh and the
identical ``shard_map`` program runs unchanged.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_render_mesh", "initialize_distributed", "TILE_AXIS",
           "SPP_AXIS"]

TILE_AXIS = "tiles"
SPP_AXIS = "spp"


def make_render_mesh(num_tile_shards: Optional[int] = None,
                     num_spp_shards: int = 1,
                     devices: Optional[Sequence] = None) -> Mesh:
    """2D (tiles, spp) mesh; defaults to all devices on the tile axis."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if num_tile_shards is None:
        num_tile_shards = n // num_spp_shards
    if num_tile_shards * num_spp_shards != n:
        raise ValueError(
            f"mesh {num_tile_shards}x{num_spp_shards} != {n} devices")
    arr = np.asarray(devices).reshape(num_tile_shards, num_spp_shards)
    return Mesh(arr, (TILE_AXIS, SPP_AXIS))


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host init (jax.distributed).  No-op for single-process runs."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
