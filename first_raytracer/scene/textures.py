"""Procedural textures as branch-free lookups.

Data-parallel counterpart of [E: texture.h] (SURVEY.md §2.1 "texture"):
``constant_texture`` returns a color; ``checker_texture`` selects odd/even
sub-colors by the sign of ``sin(10x) * sin(10y) * sin(10z)``.  Virtual
``texture::value(u, v, p)`` dispatch becomes a masked select on a per-material
texture-type id, evaluated on every lane.
"""
from __future__ import annotations

import jax.numpy as jnp

from .soa import TEX_CHECKER

__all__ = ["texture_value", "texture_from_params"]


def texture_value(scene, mat_id, p):
    """Color of each hit's material texture at hit point ``p``.

    Args:
      scene: Scene SoA.
      mat_id: (R,) i32 material ids.
      p: (R, 3) hit points.

    Returns:
      (R, 3) colors.
    """
    return texture_from_params(scene.tex_type[mat_id], scene.albedo[mat_id],
                               scene.albedo2[mat_id],
                               scene.tex_scale[mat_id], p)


def texture_from_params(tex, base, alt, scale, p):
    """``texture_value`` with the (R,)-shaped texture rows pre-gathered
    (the replay path extracts them by one-hot matmul, diff/replay.py)."""
    sines = jnp.prod(jnp.sin(scale[:, None] * p), axis=-1)
    checker = jnp.where((sines < 0.0)[:, None], alt, base)
    return jnp.where((tex == TEX_CHECKER)[:, None], checker, base)
