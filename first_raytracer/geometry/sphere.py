"""Batched ray-sphere intersection.

Data-parallel counterpart of ``sphere::hit`` [E: sphere.h] (SURVEY.md §2.1):
the quadratic ``oc = O - C``, ``b = dot(oc, d)``, ``disc = b^2 - c`` test with
near-root-then-far-root selection against ``(t_min, t_max)``.

Design deviations from the reference, shared with the oracle:

- Ray directions are unit-length everywhere (the camera and the scatter code
  normalize), so the quadratic's ``a`` coefficient is 1 and drops out.  The
  reference leaves directions unnormalized; this changes ``t`` parametrization
  but not the image.
- Instead of an early-out virtual call per object, we evaluate *all* spheres
  against *all* rays as one dense ``(R, Ns)`` computation, which XLA fuses
  into the min/argmin reduction (kernels/megakernel.py loops over the
  spheres per ray instead).

Outward normal is ``(p - C) / radius`` with the *signed* radius, preserving
the reference's hollow-glass negative-radius trick [E: main.cpp ch.13 scene].
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.vecmath import dot, point_at

__all__ = ["sphere_hit_all", "sphere_hit_one", "sphere_normal"]

# np (not jnp) scalar: module import must not initialize the XLA
# backend (jax.distributed.initialize comes first on multi-host).
BIG = np.float32(1e30)


def sphere_hit_all(origin, direction, center, radius, t_min, t_max):
    """Hit distances of R rays against all Ns spheres.

    Args:
      origin, direction: (R, 3) rays, direction unit-length.
      center: (Ns, 3); radius: (Ns,).
      t_min, t_max: scalars or (R,) per-ray bounds.

    Returns:
      t: (R, Ns) hit distance, BIG where no hit in (t_min, t_max).

    Numerics: this deliberately uses the same ``oc = o - c`` formulation as
    ``sphere_hit_one`` (broadcast to (R, Ns, 3); XLA fuses the elementwise
    products into the reduction, nothing (R, Ns, 3)-sized is materialized).
    An algebraically equivalent matmul formulation — ``b = o.d - d @ c^T`` with
    ``|c|^2`` precomputed — loses ~1e-2 of precision on large far-from-origin
    spheres (the final scene's r=1000 ground sphere) through catastrophic
    cancellation in f32, which breaks hit-mask consistency with the
    recompute path and oracle parity.  Keep the formulas identical.
    """
    t_min = jnp.asarray(t_min)[..., None]
    t_max = jnp.asarray(t_max)[..., None]
    oc = origin[:, None, :] - center[None, :, :]          # (R, Ns, 3) fused
    b = jnp.sum(oc * direction[:, None, :], axis=-1)      # (R, Ns)
    c_coef = jnp.sum(oc * oc, axis=-1) - (radius * radius)[None, :]
    disc = b * b - c_coef
    has_root = disc > 0
    sqrt_disc = jnp.sqrt(jnp.where(has_root, disc, 0.0))
    t_near = -b - sqrt_disc
    t_far = -b + sqrt_disc
    near_ok = has_root & (t_near > t_min) & (t_near < t_max)
    far_ok = has_root & (t_far > t_min) & (t_far < t_max)
    # Reference semantics: try the near root first, then the far root
    # [E: sphere.h hit()].
    t = jnp.where(near_ok, t_near, jnp.where(far_ok, t_far, BIG))
    return t


def sphere_hit_one(origin, direction, center, radius, t_min, t_max):
    """Hit distance of R rays against R per-ray spheres (gathered params).

    Used by BVH traversal (one candidate primitive per ray per step) and by
    the differentiable hit-recompute path (SURVEY.md §7 step 6).
    All args (R, ...)-shaped; returns (R,) with BIG for miss.
    """
    oc = origin - center
    b = dot(oc, direction)
    c_coef = dot(oc, oc) - radius * radius
    disc = b * b - c_coef
    has_root = disc > 0
    sqrt_disc = jnp.sqrt(jnp.where(has_root, disc, 0.0))
    t_near = -b - sqrt_disc
    t_far = -b + sqrt_disc
    near_ok = has_root & (t_near > t_min) & (t_near < t_max)
    far_ok = has_root & (t_far > t_min) & (t_far < t_max)
    return jnp.where(near_ok, t_near, jnp.where(far_ok, t_far, BIG))


def sphere_normal(origin, direction, t, center, radius):
    """Outward normal at the hit point: ``(p - C) / radius`` [E: sphere.h].

    Signed radius: negative radius flips the normal inward (hollow glass).
    Returns (point, normal), both (R, 3).
    """
    p = point_at(origin, direction, t)
    n = (p - center) / radius[..., None]
    return p, n
