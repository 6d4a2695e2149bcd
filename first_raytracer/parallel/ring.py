"""Ring-sharded scene rendering: geometry partitioned across the mesh.

SURVEY.md §2.2/§5.7 document the TP/ring-attention analog of this framework:
when a scene is too large to replicate in every device's HBM, partition the
*primitives* across the mesh and pass scene shards around a ring with
``lax.ppermute`` while each device's rays stay put — exactly the
ring-attention dataflow with (rays ↔ queries, scene shards ↔ key/value
blocks, running closest-hit ↔ running softmax state).  The reference has no
counterpart (single address space [E: main.cpp]); parity only needs the
replicated mode (scene ≈ 500 spheres [BASELINE.json:8]), so this module is
the scale-out extension beyond parity.

Design:

- Geometry leaves (sphere centers/radii/mat-ids, triangle vertices/mat-ids)
  are sharded along the primitive axis over the mesh's ``tiles`` axis; the
  materials table is tiny and stays replicated (it is the analog of
  replicated layer norms, not of the sharded weights).
- Each bounce resolves the global closest hit in ``n_shards`` hops: intersect
  the local ray block against the currently-held geometry shard, fold the
  candidate into a running ``(t, point, normal, mat, global-id)`` best state
  (ties broken toward the lower global primitive id, matching the replicated
  brute-force argmin), then ``ppermute`` the shard to the ring neighbor.
  After a full cycle every device holds its own shard again and its rays
  know their global winner — no device ever held the whole scene.
- The fold carries the winner's *geometry inputs* (center/radius or
  vertices), not its computed hit record: the differentiable hit recompute
  runs ONCE after the ring cycle, outside the ``fori_loop`` body.  This is
  deliberate — the same formula compiled inside a loop body can pick up
  different FMA contractions than the flat program, so recomputing per hop
  would drift from the replicated path by ulps; recomputing post-loop from
  carried inputs reproduces ``render.integrator.recompute_hit``'s graph in
  flat context and is bit-identical for the same winner (tested in
  tests/test_ring.py).
- The bounce loop's any-alive early exit is made globally uniform with a
  ``psum`` (``trace_rays(sync_axis=...)``) — collectives inside a
  ``while_loop`` body require every device to run the same trip count.

Sentinel padding: shards must be equal-sized, so geometry is padded with
never-hit primitives (zero-radius spheres at a far-away center; degenerate
zero-area triangles).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..core import rng
from ..geometry.sphere import BIG
from ..render.camera import generate_rays
from ..render.integrator import RenderConfig, recompute_hit, trace_rays
from ..scene.soa import Scene
from .mesh import TILE_AXIS

__all__ = ["pad_scene_ring", "render_image_ring"]

_GEOM_SPH = ("sphere_center", "sphere_radius", "sphere_mat")
_GEOM_TRI = ("tri_v0", "tri_v1", "tri_v2", "tri_mat")
_FAR = 1e30


def pad_scene_ring(scene: Scene, n_shards: int) -> Scene:
    """Pad primitive counts to multiples of ``n_shards`` with sentinels.

    Sentinel spheres (radius 0 at a far center) and degenerate triangles
    (all vertices coincident -> zero determinant) can never win a closest
    hit, so padding does not change the rendered image.
    """
    s = scene.as_numpy() if not isinstance(scene.sphere_center, np.ndarray) \
        else scene
    ns, nt = s.sphere_center.shape[0], s.tri_v0.shape[0]

    def up(n):
        return -(-max(n, 1) // n_shards) * n_shards

    ns_pad, nt_pad = up(ns), up(nt)
    rep = {}
    if ns_pad != ns:
        pad = ns_pad - ns
        rep["sphere_center"] = np.concatenate(
            [s.sphere_center, np.full((pad, 3), _FAR, np.float32)])
        rep["sphere_radius"] = np.concatenate(
            [s.sphere_radius, np.zeros((pad,), np.float32)])
        rep["sphere_mat"] = np.concatenate(
            [s.sphere_mat, np.zeros((pad,), np.int32)])
    if nt_pad != nt:
        pad = nt_pad - nt
        for f in ("tri_v0", "tri_v1", "tri_v2"):
            rep[f] = np.concatenate(
                [getattr(s, f), np.zeros((pad, 3), np.float32)])
        rep["tri_mat"] = np.concatenate(
            [s.tri_mat, np.zeros((pad,), np.int32)])
    out = dataclasses.replace(s, **rep)
    return jax.tree_util.tree_map(jnp.asarray, out)


def _ring_resolve(axis: str, n_shards: int, ns_total: int):
    """Build the ring closest-hit ``resolve_fn`` for ``trace_rays``.

    ``scene`` as seen inside: geometry leaves are THIS device's shard,
    materials replicated.  ``ns_total`` is the padded global sphere count
    (triangle global ids start there, as in the replicated id space).
    """
    perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]

    def resolve(scene, accel, origin, direction, t_min):
        del accel  # ring mode has no device-resident BVH (shards rotate)
        from ..render.integrator import intersect_brute

        R = origin.shape[0]
        ns_loc = scene.num_spheres
        nt_loc = scene.num_triangles
        me = jax.lax.axis_index(axis)

        geom = {f: getattr(scene, f) for f in _GEOM_SPH + _GEOM_TRI}

        def hop(h, carry):
            geom, best = carry
            block = (me + h) % n_shards
            local = dataclasses.replace(scene, **geom)
            # Selection only: shard-local closest hit (the same
            # ``sphere_hit_all``/``triangle_hit_all`` ordering the
            # replicated argmin uses) + global-id tie-break.  The hit
            # record is NOT computed here (see module docstring).
            lp, lt, _ = intersect_brute(local, origin, direction, t_min)
            gid_c = jnp.where(
                lp < ns_loc,
                block * ns_loc + lp,
                ns_total + block * nt_loc + (lp - ns_loc)).astype(jnp.int32)
            is_sph_c = lp < ns_loc
            si = jnp.clip(lp, 0, ns_loc - 1)
            ti = jnp.clip(lp - ns_loc, 0, nt_loc - 1)
            cand = {
                "t": lt, "gid": gid_c, "is_sph": is_sph_c,
                "c": local.sphere_center[si],
                "r": local.sphere_radius[si],
                "mat": jnp.where(is_sph_c, local.sphere_mat[si],
                                 local.tri_mat[ti]),
                "v0": local.tri_v0[ti], "v1": local.tri_v1[ti],
                "v2": local.tri_v2[ti],
            }
            better = (cand["t"] < best["t"]) | (
                (cand["t"] == best["t"]) & (cand["gid"] < best["gid"]))
            # An all-miss hop reports t = BIG with a *real* primitive id;
            # never let it displace the guaranteed-miss sentinel init (the
            # post-loop recompute would otherwise have to re-prove the miss).
            better &= cand["t"] < BIG
            best = {
                k: jnp.where(better[:, None] if best[k].ndim == 2
                             else better, cand[k], best[k])
                for k in best}
            geom = jax.tree_util.tree_map(
                lambda g: jax.lax.ppermute(g, axis, perm), geom)
            return geom, best

        init = {
            "t": jnp.full((R,), BIG, jnp.float32),
            "gid": jnp.full((R,), jnp.iinfo(jnp.int32).max, jnp.int32),
            # Miss default = the sentinel sphere (far center, zero radius):
            # the post-loop recompute then yields t = BIG -> hit False.
            "is_sph": jnp.ones((R,), bool),
            "c": jnp.full((R, 3), _FAR, jnp.float32),
            "r": jnp.zeros((R,), jnp.float32),
            "mat": jnp.zeros((R,), jnp.int32),
            "v0": jnp.zeros((R, 3), jnp.float32),
            "v1": jnp.zeros((R, 3), jnp.float32),
            "v2": jnp.zeros((R, 3), jnp.float32),
        }
        _, best = jax.lax.fori_loop(0, n_shards, hop, (geom, init))

        # Post-loop hit recompute from the carried winner inputs — the
        # exact graph of ``recompute_hit``'s mixed branch, in flat context.
        t, p, n = _recompute_from_carry(origin, direction, best, t_min)
        return t, p, n, best["mat"], t < BIG

    return resolve


def _recompute_from_carry(origin, direction, best, t_min):
    """``recompute_hit``'s mixed-branch math on carried winner inputs.

    Mirrors render.integrator.recompute_hit (ns>0 and nt>0 branch)
    term-for-term so the ring render is bit-identical to the replicated
    render for the same winning primitive.
    """
    from ..core.vecmath import point_at
    from ..geometry.sphere import sphere_hit_one, sphere_normal
    from ..geometry.triangle import triangle_hit_one, triangle_normal

    is_sph = best["is_sph"]
    c, r = best["c"], best["r"]
    v0, v1, v2 = best["v0"], best["v1"], best["v2"]
    t_s = sphere_hit_one(origin, direction, c, r, t_min, BIG)
    t_t = triangle_hit_one(origin, direction, v0, v1, v2, t_min, BIG)
    t = jnp.where(is_sph, t_s, t_t)
    p = point_at(origin, direction, t)
    _, n_s = sphere_normal(origin, direction, t, c, r)
    n = jnp.where(is_sph[:, None], n_s, triangle_normal(v0, v1, v2))
    return t, p, n


def render_image_ring(scene, camera, cfg: RenderConfig, mesh, seed: int = 0):
    """Full-image render with the scene ring-sharded over ``mesh``.

    Rays: contiguous pixel blocks per device (DP over the ``tiles`` axis,
    all spp on-device).  Scene: geometry sharded over the same axis, passed
    around the ring each bounce.  For the same seed the closest-hit
    *selection* matches the single-device render exactly; radiance matches
    up to FMA-reassociation noise (~1 ulp/bounce — the ring program is
    structurally different XLA code), tested in tests/test_ring.py.
    """
    n = mesh.shape[TILE_AXIS]
    if cfg.num_pixels % n:
        raise ValueError(f"{cfg.num_pixels} pixels not divisible by "
                         f"{n} shards")
    padded = pad_scene_ring(scene, n)
    ns_total = padded.num_spheres
    key = rng.base_key(seed)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32).reshape(
        cfg.num_pixels, cfg.spp)

    geom_fields = set(_GEOM_SPH + _GEOM_TRI)
    scene_spec = Scene(**{
        f.name: P(TILE_AXIS) if f.name in geom_fields else P()
        for f in dataclasses.fields(Scene)})
    resolve = _ring_resolve(TILE_AXIS, n, ns_total)

    @partial(jax.jit, static_argnames=())
    @partial(shard_map, mesh=mesh,
             in_specs=(scene_spec, P(), P(), P(TILE_AXIS, None)),
             out_specs=P(TILE_AXIS),
             check_vma=False)
    def run(scene_shard, camera, key, ids_block):
        npix_loc, spp = ids_block.shape
        ids_flat = ids_block.reshape(-1)
        cam_u = rng.camera_uniforms(key, ids_flat)
        o, d = generate_rays(camera, cfg.nx, cfg.ny, cfg.spp, ids_flat,
                             cam_u)
        rad = trace_rays(scene_shard, o, d, ids_flat, key, cfg,
                         resolve_fn=resolve, sync_axis=TILE_AXIS)
        return rad.reshape(npix_loc, spp, 3).mean(axis=1)

    img = run(padded, camera, key, ids)
    return img.reshape(cfg.ny, cfg.nx, 3)[::-1]
