"""Mesh-sharded rendering: explicit SPMD with XLA collectives.

The reference renders one pixel at a time on one thread [E: main.cpp]; here
the whole ray population is laid out as an ``(npix, spp)`` id grid and
sharded over a (tiles, spp) mesh (SURVEY.md §2.2): pixels across the
``tiles`` axis (pure data parallel), samples-per-pixel across the ``spp``
axis — the path tracer's sequence-parallel analog (SURVEY.md §5.7) — whose
partial pixel sums are combined with one ``psum``.  Scene, BVH, and camera
are replicated.  Because the RNG is keyed by global ray id (core/rng.py),
the sharded render is invariant to the mesh layout: same seed => same image
as the single-device path.

Two styles are provided:

- ``render_image_sharded``: ``shard_map`` with explicit PartitionSpecs and
  an explicit ``psum`` — collectives visible in the program.
- ``render_image_auto``: ``jit`` + ``NamedSharding`` constraints only —
  GSPMD chooses the collectives.

Gradient all-reduce (BASELINE.json:5 "parameter gradients all-reduced") is
*not* hand-written anywhere: differentiating through this sharded render
makes XLA transpose the replicated-parameter broadcast into a cross-mesh
``psum`` of gradients automatically, overlapped with the backward wavefront
by the XLA scheduler (see diff/grad.py and tests/test_sharding.py).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from jax import shard_map

from ..core import rng
from ..render.camera import generate_rays
from ..render.integrator import RenderConfig, trace_rays
from .mesh import SPP_AXIS, TILE_AXIS

__all__ = ["render_image_sharded", "render_image_auto",
           "render_image_distributed", "ray_id_grid"]


def ray_id_grid(cfg: RenderConfig):
    """(npix, spp) i32 grid of global ray ids (pixel-major)."""
    return jnp.arange(cfg.num_rays, dtype=jnp.int32).reshape(
        cfg.num_pixels, cfg.spp)


def _trace_ids(scene, camera, cfg, key, ids_flat, accel, intersect_fn):
    cam_u = rng.camera_uniforms(key, ids_flat)
    o, d = generate_rays(camera, cfg.nx, cfg.ny, cfg.spp, ids_flat, cam_u)
    return trace_rays(scene, o, d, ids_flat, key, cfg, accel=accel,
                      intersect_fn=intersect_fn)


@partial(jax.jit,
         static_argnames=("cfg", "mesh", "intersect_fn"))
def _render_sharded_jit(scene, camera, cfg, mesh, key, ids, accel,
                        intersect_fn):
    spp_shards = mesh.shape[SPP_AXIS]

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(), P(), P(TILE_AXIS, SPP_AXIS), P()),
             out_specs=P(TILE_AXIS),
             check_vma=False)
    def fn(scene, camera, key, ids_block, accel):
        npix_loc, spp_loc = ids_block.shape
        rad = _trace_ids(scene, camera, cfg, key, ids_block.reshape(-1),
                         accel, intersect_fn)
        pixel_part = rad.reshape(npix_loc, spp_loc, 3).mean(axis=1)
        # spp-split combine [SURVEY.md §2.2 SP row]: one psum over the spp
        # axis of per-shard partial means.
        if spp_shards > 1:
            pixel_part = jax.lax.psum(pixel_part, SPP_AXIS) / spp_shards
        return pixel_part

    return fn(scene, camera, key, ids, accel)


def render_image_sharded(scene, camera, cfg: RenderConfig, mesh,
                         seed: int = 0, accel=None,
                         intersect_fn: Optional[Callable] = None):
    """Full-image render sharded over ``mesh``; (ny, nx, 3), row 0 = top."""
    tile_shards = mesh.shape[TILE_AXIS]
    spp_shards = mesh.shape[SPP_AXIS]
    if cfg.num_pixels % tile_shards:
        raise ValueError(f"{cfg.num_pixels} pixels not divisible by "
                         f"{tile_shards} tile shards")
    if cfg.spp % spp_shards:
        raise ValueError(f"spp={cfg.spp} not divisible by {spp_shards}")
    key = rng.base_key(seed)
    ids = ray_id_grid(cfg)
    img = _render_sharded_jit(scene, camera, cfg, mesh, key, ids, accel,
                              intersect_fn)
    return img.reshape(cfg.ny, cfg.nx, 3)[::-1]


def render_image_distributed(scene, camera, cfg: RenderConfig, mesh,
                             seed: int = 0, accel=None,
                             intersect_fn: Optional[Callable] = None):
    """Multi-process-safe sharded render (SURVEY.md §5.8 multi-host path).

    Same program as ``render_image_sharded`` over a process-spanning mesh
    (after ``mesh.initialize_distributed``); the only difference is image
    assembly: the sharded output is not fully addressable on any single
    process, so every process all-gathers the pixel shards (one DCN/ICI
    ``all_gather``, SURVEY.md §2.2 comm row) and returns the complete
    host-local (ny, nx, 3) ndarray.  Also valid single-process (the gather
    degenerates to a device_get).
    """
    import numpy as np

    tile_shards = mesh.shape[TILE_AXIS]
    spp_shards = mesh.shape[SPP_AXIS]
    if cfg.num_pixels % tile_shards:
        raise ValueError(f"{cfg.num_pixels} pixels not divisible by "
                         f"{tile_shards} tile shards")
    if cfg.spp % spp_shards:
        raise ValueError(f"spp={cfg.spp} not divisible by {spp_shards}")
    key = rng.base_key(seed)
    ids = ray_id_grid(cfg)
    img = _render_sharded_jit(scene, camera, cfg, mesh, key, ids, accel,
                              intersect_fn)
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        img = multihost_utils.process_allgather(img, tiled=True)
    img = np.asarray(jax.device_get(img))
    return img.reshape(cfg.ny, cfg.nx, 3)[::-1]


def render_image_auto(scene, camera, cfg: RenderConfig, mesh, seed: int = 0,
                      accel=None, intersect_fn: Optional[Callable] = None):
    """GSPMD variant: shard the id grid, replicate params, let XLA partition."""
    key = rng.base_key(seed)
    ids = jax.device_put(
        ray_id_grid(cfg), NamedSharding(mesh, P(TILE_AXIS, SPP_AXIS)))
    repl = NamedSharding(mesh, P())
    scene = jax.device_put(scene, repl)
    camera = jax.device_put(camera, repl)
    if accel is not None:
        accel = jax.device_put(accel, repl)

    @partial(jax.jit, static_argnames=())
    def fn(scene, camera, key, ids):
        rad = _trace_ids(scene, camera, cfg, key, ids.reshape(-1), accel,
                         intersect_fn)
        return rad.reshape(cfg.num_pixels, cfg.spp, 3).mean(axis=1)

    img = fn(scene, camera, key, ids)
    return img.reshape(cfg.ny, cfg.nx, 3)[::-1]
