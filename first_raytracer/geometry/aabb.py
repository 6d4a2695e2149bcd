"""Axis-aligned bounding boxes: slab test + box combine.

Data-parallel counterpart of [E: aabb.h] (SURVEY.md §2.1 "aabb"): the per-axis
``(min - O) / d`` interval-intersection slab test with direction-sign swap,
and ``surrounding_box``.  Division by zero direction components follows IEEE
(inf), which the min/max formulation handles correctly — the standard robust
variant of the reference's explicit swap.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = ["aabb_hit", "surrounding_box_np", "sphere_aabb_np", "triangle_aabb_np"]


def aabb_hit(origin, inv_direction, box_min, box_max, t_min, t_max):
    """Slab test, broadcast over leading axes.

    Args:
      origin, inv_direction: (..., 3) — pass precomputed ``1/d``.
      box_min, box_max: (..., 3).
      t_min, t_max: (...,) current ray interval.

    Returns:
      (...,) bool — True where the box overlaps (t_min, t_max).
    """
    t0 = (box_min - origin) * inv_direction
    t1 = (box_max - origin) * inv_direction
    near = jnp.minimum(t0, t1)
    far = jnp.maximum(t0, t1)
    tn = jnp.maximum(jnp.max(near, axis=-1), t_min)
    tf = jnp.minimum(jnp.min(far, axis=-1), t_max)
    return tn <= tf


# --- Host-side (NumPy) box construction for the BVH builder -----------------

def surrounding_box_np(min_a, max_a, min_b, max_b):
    """[E: aabb.h surrounding_box] — union of two boxes (NumPy)."""
    return np.minimum(min_a, min_b), np.maximum(max_a, max_b)


def sphere_aabb_np(center, radius):
    """Per-sphere boxes; |radius| handles the negative-radius hollow glass.

    center: (N, 3), radius: (N,) -> (N, 3) mins, (N, 3) maxs.
    """
    r = np.abs(radius)[:, None]
    return center - r, center + r


def triangle_aabb_np(v0, v1, v2, pad: float = 1e-4):
    """Per-triangle boxes, padded so axis-aligned triangles have volume."""
    mn = np.minimum(np.minimum(v0, v1), v2) - pad
    mx = np.maximum(np.maximum(v0, v1), v2) + pad
    return mn, mx
