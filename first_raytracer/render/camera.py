"""Thin-lens camera: vectorized primary-ray generation.

Data-parallel counterpart of [E: camera.h] (SURVEY.md §2.1 "camera"): the
orthonormal basis ``w = unit(lookfrom - lookat)``, ``u = unit(cross(vup, w))``,
``v = cross(w, u)``, focus-plane-scaled film vectors, and ``get_ray(s, t)``
with lens-disk defocus sampling (BASELINE.json:10).  Instead of one ray per
call, ``generate_rays`` produces a whole wavefront from integer ray ids plus
their counter-RNG camera uniforms; jittered anti-aliasing (the reference's
``(i + drand48()) / nx`` in [E: main.cpp]) lives here too.

Pixel convention: ``pixel = j * nx + i`` with ``j`` counted from the *bottom*
row, matching the reference's bottom-up scanline loop; image writers flip.
Directions are normalized (deviation shared with the oracle; see
geometry/sphere.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from ..core.rng import unit_disk_sample
from ..core.vecmath import normalize

__all__ = ["Camera", "make_camera", "generate_rays"]


@jax.tree_util.register_dataclass
@dataclass
class Camera:
    """Precomputed camera frame (a small pytree of f32 arrays)."""

    origin: jax.Array       # (3,)
    lower_left: jax.Array   # (3,)
    horizontal: jax.Array   # (3,)
    vertical: jax.Array     # (3,)
    u: jax.Array            # (3,) lens-plane basis
    v: jax.Array            # (3,)
    lens_radius: jax.Array  # ()


def make_camera(lookfrom, lookat, vup, vfov_deg, aspect,
                aperture=0.0, focus_dist=None) -> Camera:
    """[E: camera.h camera::camera] — focus_dist defaults to |lookfrom-lookat|."""
    lookfrom = jnp.asarray(lookfrom, jnp.float32)
    lookat = jnp.asarray(lookat, jnp.float32)
    vup = jnp.asarray(vup, jnp.float32)
    if focus_dist is None:
        focus_dist = float(jnp.linalg.norm(lookfrom - lookat))
    theta = vfov_deg * math.pi / 180.0
    half_height = math.tan(theta / 2.0)
    half_width = aspect * half_height
    w = normalize(lookfrom - lookat)
    u = normalize(jnp.cross(vup, w))
    v = jnp.cross(w, u)
    lower_left = (lookfrom - half_width * focus_dist * u
                  - half_height * focus_dist * v - focus_dist * w)
    return Camera(
        origin=lookfrom,
        lower_left=lower_left,
        horizontal=2.0 * half_width * focus_dist * u,
        vertical=2.0 * half_height * focus_dist * v,
        u=u,
        v=v,
        lens_radius=jnp.float32(aperture / 2.0),
    )


def generate_rays(camera: Camera, nx: int, ny: int, spp: int,
                  ray_ids, cam_uniforms):
    """Primary rays for a batch of ray ids.

    Args:
      camera: Camera frame.
      nx, ny, spp: static image config (decode ray_id -> pixel, sample).
      ray_ids: (R,) i32 global ray ids (pixel * spp + sample).
      cam_uniforms: (R, 4) camera-domain uniforms
        (AA jitter u,v then lens-disk u1,u2) from core.rng.camera_uniforms.

    Returns:
      (origin, direction): (R, 3) each, direction unit-length.
    """
    pixel = ray_ids // spp
    i = (pixel % nx).astype(jnp.float32)
    j = (pixel // nx).astype(jnp.float32)  # bottom-up row
    s = (i + cam_uniforms[:, 0]) / nx
    t = (j + cam_uniforms[:, 1]) / ny
    rd = camera.lens_radius * unit_disk_sample(
        cam_uniforms[:, 2], cam_uniforms[:, 3])  # (R, 2)
    offset = rd[:, 0:1] * camera.u + rd[:, 1:2] * camera.v
    origin = camera.origin + offset
    direction = (camera.lower_left
                 + s[:, None] * camera.horizontal
                 + t[:, None] * camera.vertical
                 - camera.origin - offset)
    return origin, normalize(direction)
