"""Wavefront path-tracing integrator.

This is the data-parallel re-architecture of the reference's recursive
``color(ray, world, depth)`` [E: main.cpp] (SURVEY.md §3.2): the depth-50
recursion becomes at most ``max_depth + 1`` breadth-wise passes over the whole
ray population (``lax.while_loop`` with an any-alive early exit, or a
``lax.scan`` with identical masked semantics for the reverse-differentiable
path), per-ray divergent branching becomes ``alive`` masks, and virtual
material dispatch becomes the masked select in ``materials.scatter``.

Radiance recurrence: the recursive ``attenuation * color(scattered, d+1)``
becomes a carried ``throughput`` product; a ray that misses adds
``throughput * sky`` (the reference's white->(0.5,0.7,1.0) vertical lerp) and
dies; a metal-absorbed ray or a ray still alive at the depth cap adds black.
Hit epsilon ``t_min = 1e-3`` is the reference's shadow-acne bound
[E: main.cpp color()].

Intersection is pluggable (SURVEY.md §7 steps 2-4): ``intersect_brute`` is
the dense all-pairs closest hit; ``accel.traverse`` provides the BVH walk.
Both return
``(prim_id, t, hit)`` and the integrator *recomputes* the hit point/normal
from the primitive's parameters, so gradients w.r.t. scene geometry flow
through the hit equation regardless of how the primitive was found
(SURVEY.md §7 step 6 "differentiate the hit equation, not the traversal").
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..core import rng
from ..core.vecmath import point_at
from ..geometry.sphere import BIG, sphere_hit_all, sphere_hit_one, sphere_normal
from ..geometry.triangle import (triangle_hit_all, triangle_hit_one,
                                 triangle_normal)
from ..materials.scatter import scatter

__all__ = ["RenderConfig", "intersect_brute", "recompute_hit", "sky_color",
           "trace_rays"]


@dataclass(frozen=True)
class RenderConfig:
    """Static render settings (hashable; safe to close over under jit).

    Defaults follow the reference's canonical first config
    [E: main.cpp nx/ny/ns, BASELINE.json:7].
    """

    nx: int = 200
    ny: int = 100
    spp: int = 100
    max_depth: int = 50
    t_min: float = 1e-3
    # Differentiable path: scan (fixed trip count, reverse-mode safe).
    # Forward path: while_loop with any-alive early exit.
    differentiable: bool = False

    @property
    def num_pixels(self) -> int:
        return self.nx * self.ny

    @property
    def num_rays(self) -> int:
        return self.num_pixels * self.spp


def sky_color(direction):
    """Miss shader: vertical white->blue lerp [E: main.cpp color() MISS]."""
    t = 0.5 * (direction[:, 1] + 1.0)
    white = jnp.array([1.0, 1.0, 1.0], jnp.float32)
    blue = jnp.array([0.5, 0.7, 1.0], jnp.float32)
    return (1.0 - t)[:, None] * white + t[:, None] * blue


def default_intersect(scene, accel, origin, direction, t_min):
    """Brute force without an accel structure, the flat-BVH walk with one.

    The BVH walk runs under ``stop_gradient``: it only *finds* the
    primitive; the integrator recomputes the differentiable hit record from
    the id (visibility/silhouette gradients are out of scope by design,
    SURVEY.md §7 step 6), and its while_loop must never see AD tracers.
    """
    if accel is None:
        return intersect_brute(scene, origin, direction, t_min)
    sg = jax.lax.stop_gradient
    from ..accel.traverse import intersect_bvh
    return intersect_bvh(sg(scene), sg(accel), sg(origin), sg(direction),
                         t_min)


def intersect_brute(scene, origin, direction, t_min):
    """Dense closest-hit over every (ray, primitive) pair.

    The data-parallel replacement for ``hitable_list::hit``'s O(n) scan
    [E: hitable_list.h] (SURVEY.md §3.3): no early-out, no pointer chase —
    one (R, Np) distance expression reduced by a single min/argmin, which
    XLA fuses so the matrix is not written to memory.  Returns
    (prim_id, t, hit_mask).
    """
    parts = []
    if scene.num_spheres:
        parts.append(sphere_hit_all(
            origin, direction, scene.sphere_center, scene.sphere_radius,
            t_min, BIG))
    if scene.num_triangles:
        parts.append(triangle_hit_all(
            origin, direction, scene.tri_v0, scene.tri_v1, scene.tri_v2,
            t_min, BIG))
    t_all = jnp.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]
    prim = jnp.argmin(t_all, axis=1).astype(jnp.int32)
    t = jnp.min(t_all, axis=1)
    return prim, t, t < BIG


def recompute_hit(scene, origin, direction, prim, t_min):
    """Differentiable hit data from a primitive id.

    Given the winning primitive, re-solves its hit equation so that
    ``t``, point, normal, and material are smooth functions of the scene
    parameters (centers/radii/vertices) even when the primitive was found by
    a non-differentiable traversal.  Returns (t, p, n, mat_id).
    """
    ns, nt = scene.num_spheres, scene.num_triangles
    if nt == 0:
        si = jnp.clip(prim, 0, ns - 1)
        c = scene.sphere_center[si]
        r = scene.sphere_radius[si]
        t = sphere_hit_one(origin, direction, c, r, t_min, BIG)
        p, n = sphere_normal(origin, direction, t, c, r)
        return t, p, n, scene.sphere_mat[si]
    if ns == 0:
        ti = jnp.clip(prim, 0, nt - 1)
        v0, v1, v2 = scene.tri_v0[ti], scene.tri_v1[ti], scene.tri_v2[ti]
        t = triangle_hit_one(origin, direction, v0, v1, v2, t_min, BIG)
        p = point_at(origin, direction, t)
        return t, p, triangle_normal(v0, v1, v2), scene.tri_mat[ti]

    is_sph = prim < ns
    si = jnp.clip(prim, 0, ns - 1)
    ti = jnp.clip(prim - ns, 0, nt - 1)
    c = scene.sphere_center[si]
    r = scene.sphere_radius[si]
    t_s = sphere_hit_one(origin, direction, c, r, t_min, BIG)
    v0, v1, v2 = scene.tri_v0[ti], scene.tri_v1[ti], scene.tri_v2[ti]
    t_t = triangle_hit_one(origin, direction, v0, v1, v2, t_min, BIG)
    t = jnp.where(is_sph, t_s, t_t)
    p = point_at(origin, direction, t)
    _, n_s = sphere_normal(origin, direction, t, c, r)
    n = jnp.where(is_sph[:, None], n_s, triangle_normal(v0, v1, v2))
    mat = jnp.where(is_sph, scene.sphere_mat[si], scene.tri_mat[ti])
    return t, p, n, mat


def trace_rays(scene, origin, direction, ray_ids, key, cfg: RenderConfig,
               accel=None, intersect_fn: Optional[Callable] = None,
               return_stats: bool = False,
               resolve_fn: Optional[Callable] = None,
               sync_axis: Optional[str] = None):
    """Trace R primary rays to completion; returns (R, 3) radiance.

    ``intersect_fn(scene, accel, origin, direction, t_min) ->
    (prim, t, hit)`` defaults to ``default_intersect`` (brute force without
    an accel pytree, flat-BVH walk with one).

    ``resolve_fn(scene, accel, origin, direction, t_min) ->
    (t, p, n, mat, hit)`` overrides the whole closest-hit resolution
    (intersect + differentiable recompute) — the hook the ring-sharded
    scene mode (parallel/ring.py) uses, where no device holds the full
    geometry and the hit record is assembled over ``ppermute`` hops.

    ``sync_axis``: when tracing inside ``shard_map`` with collectives in
    the bounce body (ring mode), the while_loop's any-alive early exit must
    be *globally* uniform or devices would disagree on the trip count and
    deadlock the collective; pass the mesh axis name to ``psum`` the
    predicate.

    With ``return_stats=True`` also returns ``segments``: (R,) i32 count of
    ray segments traced per path (occupancy/rays-per-second accounting,
    SURVEY.md §5.5).
    """
    if intersect_fn is None:
        intersect_fn = default_intersect
    if resolve_fn is None:
        def resolve_fn(scene, accel, origin, direction, t_min):
            # Selection is non-differentiable by contract (SURVEY.md §7
            # step 6): tangents are cut at the intersector's inputs so
            # *any* intersect_fn — including one without a JVP rule —
            # works under reverse-mode; all gradients come
            # from the recompute below.
            sg = jax.lax.stop_gradient
            prim, _, hit = intersect_fn(sg(scene), accel, sg(origin),
                                        sg(direction), t_min)
            t, p, n, mat = recompute_hit(scene, origin, direction, prim,
                                         t_min)
            return t, p, n, mat, hit
    R = origin.shape[0]
    f32 = jnp.float32

    def bounce(d, state):
        origin, direction, throughput, radiance, alive, segments = state
        segments = segments + alive.astype(jnp.int32)
        t, p, n, mat, hit = resolve_fn(scene, accel, origin, direction,
                                       cfg.t_min)
        # The recompute is the authority on whether the chosen primitive
        # really hits (keeps every intersector consistent with the
        # differentiable path), and dead/miss lanes get sanitized hit data so
        # garbage (t = BIG) points can't breed NaN/Inf — which would also
        # poison reverse-mode gradients through jnp.where.
        hit = hit & (t < BIG)
        p = jnp.where(hit[:, None], p, 0.0)
        n = jnp.where(hit[:, None], n, jnp.array([0.0, 0.0, 1.0], jnp.float32))

        # MISS while alive -> sky contribution, ray dies [E: main.cpp color()].
        miss_now = alive & ~hit
        radiance = radiance + jnp.where(
            miss_now[:, None], throughput * sky_color(direction), 0.0)

        # HIT -> scatter (depth-capped: at d == max_depth the reference's
        # ``depth < 50`` check fails and the path returns black).
        uniforms = rng.bounce_uniforms(key, ray_ids, d)
        new_dir, attenuation, scattered_ok = scatter(
            scene, mat, direction, p, n, uniforms)
        cont = alive & hit & scattered_ok & (d < cfg.max_depth)

        throughput = jnp.where(cont[:, None], throughput * attenuation,
                               throughput)
        origin = jnp.where(cont[:, None], p, origin)
        direction = jnp.where(cont[:, None], new_dir, direction)
        return origin, direction, throughput, radiance, cont, segments

    init = (origin, direction,
            jnp.ones((R, 3), f32), jnp.zeros((R, 3), f32),
            jnp.ones((R,), bool), jnp.zeros((R,), jnp.int32))

    if cfg.differentiable:
        # Fixed-trip scan: reverse-mode differentiable, identical masked math.
        def scan_body(state, d):
            return bounce(d, state), None
        state, _ = jax.lax.scan(
            scan_body, init, jnp.arange(cfg.max_depth + 1), unroll=1)
    else:
        def cond(carry):
            d, state = carry
            any_alive = jnp.any(state[4])
            if sync_axis is not None:
                any_alive = jax.lax.psum(
                    any_alive.astype(jnp.int32), sync_axis) > 0
            return (d <= cfg.max_depth) & any_alive

        def body(carry):
            d, state = carry
            return d + 1, bounce(d, state)

        _, state = jax.lax.while_loop(cond, body, (jnp.int32(0), init))

    if return_stats:
        return state[3], state[5]
    return state[3]
