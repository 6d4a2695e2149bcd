"""Batched ray-triangle intersection (Möller-Trumbore).

Data-parallel counterpart of the reference's triangle extension
[E: triangle.h / main.cpp, BASELINE.json:9] (SURVEY.md §2.1 "triangle"):
edge/cross/determinant test with barycentric bounds.  Evaluated densely over
all (ray, triangle) pairs — no virtual dispatch, no early out; dead lanes are
masked to BIG.

The geometric normal is ``normalize(cross(e1, e2))``, un-flipped: triangle
winding defines the outward side, consistent between oracle and device path.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.vecmath import cross, dot, normalize

__all__ = ["triangle_hit_all", "triangle_hit_one", "triangle_normal"]

# np (not jnp) scalars: module import must not initialize the XLA
# backend (jax.distributed.initialize comes first on multi-host).
BIG = np.float32(1e30)
_DET_EPS = np.float32(1e-9)


def _moller_trumbore(origin, direction, v0, v1, v2, t_min, t_max):
    """Core MT test on broadcast-compatible shapes; returns (t, hit)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(direction, e2)
    det = dot(e1, pvec)
    ok = jnp.abs(det) > _DET_EPS
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    tvec = origin - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(direction, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max)
    return jnp.where(hit, t, BIG), hit


def triangle_hit_all(origin, direction, v0, v1, v2, t_min, t_max):
    """Hit distances of R rays against all Nt triangles.

    origin/direction: (R, 3); v0/v1/v2: (Nt, 3); returns (R, Nt).
    """
    t, _ = _moller_trumbore(
        origin[:, None, :], direction[:, None, :],
        v0[None, :, :], v1[None, :, :], v2[None, :, :],
        jnp.asarray(t_min)[..., None], jnp.asarray(t_max)[..., None],
    )
    return t


def triangle_hit_one(origin, direction, v0, v1, v2, t_min, t_max):
    """Per-ray gathered-triangle test; all (R, ...)-shaped, returns (R,)."""
    t, _ = _moller_trumbore(origin, direction, v0, v1, v2, t_min, t_max)
    return t


def triangle_normal(v0, v1, v2):
    """Unit geometric normal from winding; (R, 3) -> (R, 3)."""
    return normalize(cross(v1 - v0, v2 - v0))
