"""Top-level render API: chunked wavefront rendering to an image.

Data-parallel counterpart of the reference's ``main()`` pixel/sample loops
[E: main.cpp] (SURVEY.md §3.1): instead of three nested scalar loops, the
whole ``nx * ny * spp`` ray population is a flat id range, processed in
fixed-size chunks (one jit compilation, static shapes) on device; per-pixel
averaging over spp and the bottom-up -> top-down flip happen at the end.

Chunking bounds the wavefront's per-ray state in device memory; the dense
intersect's (chunk, Np) distance matrix is fused into its reduction and
never written out.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..core import rng
from .camera import Camera, generate_rays
from .integrator import RenderConfig, trace_rays

__all__ = ["render_ray_batch", "render_image", "DEFAULT_CHUNK"]

DEFAULT_CHUNK = 1 << 17


@partial(jax.jit, static_argnames=("cfg", "intersect_fn"))
def render_ray_batch(scene, camera: Camera, cfg: RenderConfig, key, ray_ids,
                     accel=None, intersect_fn: Optional[Callable] = None):
    """Radiance for one batch of global ray ids; (R,) i32 -> (R, 3) f32."""
    cam_u = rng.camera_uniforms(key, ray_ids)
    origin, direction = generate_rays(
        camera, cfg.nx, cfg.ny, cfg.spp, ray_ids, cam_u)
    return trace_rays(scene, origin, direction, ray_ids, key, cfg,
                      accel=accel, intersect_fn=intersect_fn)


def render_image(scene, camera: Camera, cfg: RenderConfig, seed: int = 0,
                 accel=None, intersect_fn: Optional[Callable] = None,
                 chunk: Optional[int] = None, mode: str = "wavefront",
                 pool_size: int = 1 << 16):
    """Render the full image; returns (ny, nx, 3) linear radiance, row 0 = top.

    mode: "wavefront" (chunked fixed-depth masked loop) or "regenerative"
    (compacted ray pool with path regeneration — same per-ray math, higher
    lane occupancy; see render/regenerative.py).

    Gamma correction and quantization are in ``render.image`` (the reference
    applies ``sqrt`` + ``int(255.99 * c)`` at output time [E: main.cpp]).
    """
    key = rng.base_key(seed)
    total = cfg.num_rays
    if mode == "regenerative":
        from .regenerative import render_rays_regenerative
        radiance = render_rays_regenerative(
            scene, camera, cfg, key, jnp.int32(0), total, accel,
            intersect_fn, pool_size=min(pool_size, max(total, 256)))
    elif mode == "wavefront":
        chunk = min(total, chunk or DEFAULT_CHUNK)
        pieces = []
        for start in range(0, total, chunk):
            ids = jnp.arange(start, start + chunk, dtype=jnp.int32)
            # The trailing partial chunk keeps its static shape; out-of-range
            # ids render garbage rays that are sliced off below.
            ids = jnp.minimum(ids, total - 1)
            pieces.append(render_ray_batch(
                scene, camera, cfg, key, ids, accel, intersect_fn))
        radiance = jnp.concatenate(pieces, axis=0)[:total]
    else:
        raise ValueError(f"unknown mode {mode!r}")
    img = radiance.reshape(cfg.ny, cfg.nx, cfg.spp, 3).mean(axis=2)
    return img[::-1]  # bottom-up scanlines -> conventional top-down
