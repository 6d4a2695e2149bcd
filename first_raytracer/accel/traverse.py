"""Stackless vectorized BVH traversal in pure JAX.

Data-parallel counterpart of ``bvh_node::hit``'s pointer-chasing recursion
[E: bvh.h] (SURVEY.md §3.3): every ray walks the flattened preorder node
array in lockstep inside one ``lax.while_loop`` — box hit on an inner node
steps to ``node + 1`` (preorder left child), box miss or a finished leaf
jumps to ``skip[node]``.  No stack, no recursion; per-ray divergence costs
only masked lanes.  ``t_best`` shrinks the slab-test interval exactly like
the reference's ``closest_so_far``.

Leaf primitives are tested with ``max_leaf`` unrolled masked gathers; a
mixed sphere/triangle scene evaluates both tests per slot and selects —
masked vectorized branching, same policy as material dispatch.

Traversal returns only ``(prim, t, hit)``; the integrator *recomputes* the
differentiable hit record from the winning primitive id
(render/integrator.py), so this walk needs no gradient rules at all
(SURVEY.md §7 step 6).

The walk is the plain path's accelerated closest hit and the
traversal-correctness oracle (closest hit equal to brute force,
tests/test_bvh.py).  As one XLA while_loop over a whole batch, every
iteration waits for the batch's longest walk; render/routing.py decides
from the scene when it is used (the measurements are in PERF.md).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geometry.aabb import aabb_hit
from ..geometry.sphere import BIG, sphere_hit_one
from ..geometry.triangle import triangle_hit_one

__all__ = ["prim_hit_one", "intersect_bvh"]


def prim_hit_one(scene, pid, origin, direction, t_min):
    """Hit distance of R rays against R gathered global primitive ids."""
    ns, nt = scene.num_spheres, scene.num_triangles
    if nt == 0:
        si = jnp.clip(pid, 0, ns - 1)
        return sphere_hit_one(origin, direction, scene.sphere_center[si],
                              scene.sphere_radius[si], t_min, BIG)
    if ns == 0:
        ti = jnp.clip(pid, 0, nt - 1)
        return triangle_hit_one(origin, direction, scene.tri_v0[ti],
                                scene.tri_v1[ti], scene.tri_v2[ti],
                                t_min, BIG)
    is_sph = pid < ns
    si = jnp.clip(pid, 0, ns - 1)
    ti = jnp.clip(pid - ns, 0, nt - 1)
    t_s = sphere_hit_one(origin, direction, scene.sphere_center[si],
                         scene.sphere_radius[si], t_min, BIG)
    t_t = triangle_hit_one(origin, direction, scene.tri_v0[ti],
                           scene.tri_v1[ti], scene.tri_v2[ti], t_min, BIG)
    return jnp.where(is_sph, t_s, t_t)


def intersect_bvh(scene, bvh, origin, direction, t_min, max_leaf: int = 4):
    """Closest hit via the flat BVH; same contract as ``intersect_brute``.

    Args:
      scene: Scene SoA; bvh: FlatBVH; origin/direction: (R, 3).
      max_leaf: static unroll bound for leaf slots (>= builder's max_leaf).

    Returns:
      (prim, t, hit): (R,) i32 global prim id, (R,) f32 distance, (R,) bool.
    """
    n_nodes = bvh.num_nodes
    np_total = bvh.prim_ids.shape[0]
    R = origin.shape[0]
    inv_d = 1.0 / direction

    def cond(state):
        node, _, _ = state
        return jnp.any(node < n_nodes)

    def body(state):
        node, t_best, prim_best = state
        active = node < n_nodes
        nidx = jnp.minimum(node, n_nodes - 1)
        box_ok = active & aabb_hit(
            origin, inv_d, bvh.node_min[nidx], bvh.node_max[nidx],
            t_min, t_best)
        count = bvh.node_count[nidx]
        is_leaf = count > 0
        first = bvh.node_first[nidx]
        test_leaf = box_ok & is_leaf
        for k in range(max_leaf):
            slot_ok = test_leaf & (k < count)
            pid = bvh.prim_ids[jnp.minimum(first + k, np_total - 1)]
            t_k = prim_hit_one(scene, pid, origin, direction, t_min)
            better = slot_ok & (t_k < t_best)
            t_best = jnp.where(better, t_k, t_best)
            prim_best = jnp.where(better, pid, prim_best)
        descend = box_ok & ~is_leaf
        nxt = jnp.where(descend, nidx + 1, bvh.node_skip[nidx])
        nxt = jnp.where(active, nxt, n_nodes)
        return nxt, t_best, prim_best

    init = (jnp.zeros((R,), jnp.int32), jnp.full((R,), BIG),
            jnp.zeros((R,), jnp.int32))
    _, t, prim = jax.lax.while_loop(cond, body, init)
    return prim, t, t < BIG
