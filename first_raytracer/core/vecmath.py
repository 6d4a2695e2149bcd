"""Vector math on ``(..., 3)`` arrays.

Data-parallel counterpart of the reference's ``vec3``/``ray`` value types
(reference layout [E: vec3.h, ray.h] — see SURVEY.md §2.1).  Instead of a
3-float class with operator overloads, every helper here operates on arrays
whose trailing axis has length 3, so the same code is a scalar ray in the
oracle and a million-ray batch on the device.  Rays are represented as a pair of
arrays ``(origin, direction)`` rather than a class; ``point_at`` is the
reference's ``ray::point_at_parameter``.

All functions are pure and jit/vmap/grad-safe.
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "dot",
    "cross",
    "length",
    "squared_length",
    "normalize",
    "point_at",
    "reflect",
    "refract",
    "schlick",
]


def dot(a, b):
    """Batched 3-vector dot product -> (...,) array. [E: vec3.h dot]"""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    """Batched cross product on the trailing axis. [E: vec3.h cross]"""
    return jnp.cross(a, b)


def squared_length(v):
    """[E: vec3.h squared_length]"""
    return jnp.sum(v * v, axis=-1)


def length(v):
    """[E: vec3.h length]"""
    return jnp.sqrt(squared_length(v))


def normalize(v, eps: float = 0.0):
    """Unit vector. [E: vec3.h unit_vector]

    ``eps`` guards against division by zero for padded/dead lanes; the
    reference never needs this because it only normalizes live rays.
    """
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    if eps:
        n2 = jnp.maximum(n2, eps)
    return v * jnp.where(n2 > 0, 1.0 / jnp.sqrt(jnp.where(n2 > 0, n2, 1.0)), 0.0)


def point_at(origin, direction, t):
    """``A + t*B`` — the reference ray's point_at_parameter. [E: ray.h]"""
    return origin + t[..., None] * direction


def reflect(v, n):
    """``v - 2*dot(v,n)*n``. [E: material.h reflect]"""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(v, n, ni_over_nt):
    """Snell refraction with total-internal-reflection mask.

    Mirrors the reference's ``refract(v, n, ni_over_nt, refracted&)``
    [E: material.h]: normalizes ``v``, computes the discriminant, and returns
    ``(refracted, ok)`` where ``ok`` is the bool the reference returns.  The
    refracted direction is well-defined garbage (zeros) when ``ok`` is False;
    callers must select on ``ok``.
    """
    uv = normalize(v)
    dt = dot(uv, n)
    discriminant = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
    ok = discriminant > 0
    safe_disc = jnp.where(ok, discriminant, 0.0)
    refracted = (
        ni_over_nt[..., None] * (uv - n * dt[..., None])
        - n * jnp.sqrt(safe_disc)[..., None]
    )
    return jnp.where(ok[..., None], refracted, 0.0), ok


def schlick(cosine, ref_idx):
    """Schlick's reflectance approximation ``r0 + (1-r0)(1-cos)^5``.

    [E: material.h schlick]
    """
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    one_minus = 1.0 - cosine
    return r0 + (1.0 - r0) * one_minus ** 5
