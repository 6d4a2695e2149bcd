"""Path-replay differentiable rendering: record once, differentiate a replay.

Reverse-mode autodiff straight through the scan-form wavefront loop
(render/integrator.py, ``method="scan"``) re-intersects the full scene (an
O(R x Np) dense sweep) inside the AD graph on every one of the 51 bounce
iterations, and the scan spills each iteration's residuals to device memory.

This module exploits the framework's own gradient contract: primitive
*selection* is non-differentiable by design (SURVEY.md §7 step 6 —
"differentiate the hit equation, not the traversal"; the integrator already
stop_gradients every intersector).  So the expensive intersection work can be
hoisted OUT of the AD graph entirely:

1. **Record** (non-differentiable, fast): trace the paths with any
   intersector, storing only the winning primitive id per (bounce, ray): a
   ``(max_depth + 1, R)`` i32 tape (-1 = miss/dead).  Two recorders, same
   tape bit-for-bit: ``record_paths`` (lockstep early-exit ``while_loop``,
   fully jittable inline) and ``record_paths_pool`` (compacted-pool with
   regeneration, like render/regenerative.py — dead lanes never sweep, so
   small ray counts don't pay the longest path's 50-deep lockstep tail).
   This is in spirit the "path replay" of differentiable-rendering practice
   (Vicini et al. 2021), specialized to reparameterized gradients.
2. **Replay** (differentiable, cheap): a fixed-trip ``scan`` over the tape
   where each bounce recomputes the hit record from the recorded id and
   shades.  No intersection appears in the AD graph at all.  The winner's
   geometry + material payload is extracted with **one-hot matmuls** (at
   ``Precision.HIGHEST``, so float32 and never TF32) rather than ~10
   per-field gathers: the transpose (parameter gradients) is another matmul
   instead of 51 serialized scatter-adds.  ``jax.checkpoint`` on the bounce
   body keeps backward residuals to the carried state only.

Because the record pass runs the *identical* bounce arithmetic (same f32
ops, same RNG draws), the recorded ids are exactly the ids the monolithic
scan would have selected, and the replay's radiance and gradients match
round 2's direct path (tests/test_replay.py proves both).

The reference has no gradients at all (SURVEY.md §3.5); this module is the
differentiable pass [BASELINE.json:5, :11]: the tape can be recorded by the
same path-tracing kernel that renders (kernels/megakernel.py), and the
backward work is the replay's transposed O(R) bounce math.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng
from ..core.vecmath import point_at
from ..geometry.sphere import BIG, sphere_hit_one, sphere_normal
from ..geometry.triangle import (triangle_hit_one, triangle_normal)
from ..materials.scatter import scatter, scatter_from_params
from ..render.camera import generate_rays
from ..render.integrator import (RenderConfig, default_intersect,
                                 recompute_hit, sky_color)
from ..scene.textures import texture_from_params

__all__ = ["record_paths", "record_paths_pool", "trace_rays_replay",
           "live_trips", "plan_buckets"]

# Payload-table material block layout (columns after the geometry block):
# [mtype, fuzz, ref_idx, albedo(3), albedo2(3), tex_scale, tex_type] = 11.
_MAT_COLS = 11


def record_paths(scene, origin, direction, ray_ids, key, cfg: RenderConfig,
                 accel=None, intersect_fn: Optional[Callable] = None):
    """Trace R rays forward and return the (max_depth + 1, R) i32 prim tape.

    Entry ``tape[d, i]`` is the global primitive id ray ``i`` hit at bounce
    ``d`` (after the integrator's recompute-authority check), or -1 when the
    ray missed, was already dead, or the scatter at an earlier bounce
    absorbed it.  Runs under an early-exit ``while_loop`` (all-dead
    wavefronts cost nothing) and is never differentiated — callers wrap it
    in ``stop_gradient``.
    """
    if intersect_fn is None:
        intersect_fn = default_intersect
    R = origin.shape[0]
    D = cfg.max_depth + 1
    tape0 = jnp.full((D, R), -1, jnp.int32)

    def cond(carry):
        d, _, _, alive, _ = carry
        return (d <= cfg.max_depth) & jnp.any(alive)

    def body(carry):
        d, o, dr, alive, tape = carry
        prim, _, hit = intersect_fn(scene, accel, o, dr, cfg.t_min)
        # Recompute is the authority on hits, exactly as in trace_rays —
        # the tape must store the id iff the replay will re-derive hit=True.
        t, p, n, mat = recompute_hit(scene, o, dr, prim, cfg.t_min)
        hit = hit & (t < BIG)
        tape = jax.lax.dynamic_update_index_in_dim(
            tape, jnp.where(alive & hit, prim, -1), d, axis=0)
        p = jnp.where(hit[:, None], p, 0.0)
        n = jnp.where(hit[:, None], n, jnp.array([0.0, 0.0, 1.0],
                                                 jnp.float32))
        uniforms = rng.bounce_uniforms(key, ray_ids, d)
        new_dir, _, scattered_ok = scatter(scene, mat, dr, p, n, uniforms)
        cont = alive & hit & scattered_ok & (d < cfg.max_depth)
        o = jnp.where(cont[:, None], p, o)
        dr = jnp.where(cont[:, None], new_dir, dr)
        return d + 1, o, dr, cont, tape

    _, _, _, _, tape = jax.lax.while_loop(
        cond, body, (jnp.int32(0), origin, direction,
                     jnp.ones((R,), bool), tape0))
    return tape


def record_paths_pool(scene, camera, cfg: RenderConfig, key, ray_ids,
                      accel=None, intersect_fn: Optional[Callable] = None,
                      pool_size: int = 8192):
    """``record_paths`` via a compacted regenerating pool (same tape).

    The lockstep recorder iterates until the *longest* path dies with every
    lane sweeping; here a fixed ``pool_size`` pool stays near-full
    occupancy (compact survivors, refill from the ``ray_ids`` stream,
    exactly render/regenerative.py's scheme), so recording cost tracks the
    *total segment count* instead of R x longest-path.  Generates its own
    camera rays (RNG contract: domain 0 per ray id).  ``pool_size`` and
    the shape of ``ray_ids`` are static.
    """
    if intersect_fn is None:
        intersect_fn = default_intersect
    R = ray_ids.shape[0]
    C = pool_size
    D = cfg.max_depth + 1
    f32, i32 = jnp.float32, jnp.int32

    def fresh_rays(stream_idx):
        ids = ray_ids[jnp.clip(stream_idx, 0, R - 1)]
        cam_u = rng.camera_uniforms(key, ids)
        o, d = generate_rays(camera, cfg.nx, cfg.ny, cfg.spp, ids, cam_u)
        return ids, o, d

    def state_init():
        n0 = min(C, R)
        slot = jnp.arange(C, dtype=i32)
        ids, o, d = fresh_rays(slot)
        return dict(o=o, d=d, ids=ids, col=slot,
                    depth=jnp.zeros((C,), i32), alive=slot < n0,
                    cursor=jnp.asarray(n0, i32),
                    tape=jnp.full((D * R,), -1, i32))

    def cond(s):
        return jnp.any(s["alive"])

    def body(s):
        o, d, ids, col, depth, alive = (s["o"], s["d"], s["ids"], s["col"],
                                        s["depth"], s["alive"])
        prim, _, hit = intersect_fn(scene, accel, o, d, cfg.t_min)
        t, p, n, mat = recompute_hit(scene, o, d, prim, cfg.t_min)
        hit = hit & (t < BIG)
        # Tape write: only real hits (the -1 default covers miss/dead).
        # Flat 1D scatter (depth * R + col) — cheaper lowering than a 2D
        # scatter; invalid lanes are pushed past the end and dropped.
        write = alive & hit
        flat_idx = jnp.where(write, depth * R + col, D * R)
        tape = s["tape"].at[flat_idx].set(prim, mode="drop")
        p = jnp.where(hit[:, None], p, 0.0)
        n = jnp.where(hit[:, None], n, jnp.array([0, 0, 1], f32))

        uniforms = rng.bounce_uniforms_var(key, ids, depth)
        new_dir, _, ok = scatter(scene, mat, d, p, n, uniforms)
        cont = alive & hit & ok & (depth < cfg.max_depth)
        o = jnp.where(cont[:, None], p, o)
        d = jnp.where(cont[:, None], new_dir, d)
        depth = depth + cont.astype(i32)

        # Compaction (stable partition) + regeneration from the stream —
        # same scheme as render/regenerative.py.
        n_alive = jnp.sum(cont.astype(i32))
        pos_alive = jnp.cumsum(cont.astype(i32)) - 1
        dest = jnp.where(cont, pos_alive, C - 1)

        def compact(x):
            return jnp.zeros_like(x).at[dest].set(
                jnp.where(cont.reshape((-1,) + (1,) * (x.ndim - 1)), x,
                          jnp.zeros_like(x)))

        o, d, ids, col, depth = map(compact, (o, d, ids, col, depth))

        slot = jnp.arange(C, dtype=i32)
        is_tail = slot >= n_alive
        fresh_idx = s["cursor"] + (slot - n_alive)
        fresh_valid = is_tail & (fresh_idx < R)
        f_ids, fo, fd = fresh_rays(fresh_idx)
        sel = is_tail[:, None]
        o = jnp.where(sel, fo, o)
        d = jnp.where(sel, fd, d)
        ids = jnp.where(is_tail, f_ids, ids)
        col = jnp.where(is_tail, jnp.clip(fresh_idx, 0, R - 1), col)
        depth = jnp.where(is_tail, 0, depth)
        alive = jnp.where(is_tail, fresh_valid, slot < n_alive)
        n_taken = jnp.minimum(C - n_alive,
                              jnp.maximum(R - s["cursor"], 0))
        return dict(o=o, d=d, ids=ids, col=col, depth=depth, alive=alive,
                    cursor=s["cursor"] + n_taken, tape=tape)

    final = jax.lax.while_loop(cond, body, state_init())
    return final["tape"].reshape(D, R)


def live_trips(tape) -> int:
    """Host-side: number of replay trips the tape actually needs.

    The last row with any recorded hit, plus one trip for the misses of the
    rays scattered there (a miss at depth d implies a hit at d-1, so no
    contribution lies deeper).  Replaying ``tape[:live_trips(tape)]`` is
    exact; the rest of the rows are all -1.
    """
    rows = np.asarray(jax.device_get((tape >= 0).any(axis=1)))
    if not rows.any():
        return 1
    return min(int(np.nonzero(rows)[0].max()) + 2, tape.shape[0])


def plan_buckets(tape, max_groups: int = 6, quantum: int = 1024):
    """Host-side replay plan: rays sorted by recorded path length, split
    into depth-ladder buckets.

    The lockstep replay runs EVERY ray for the deepest ray's trip count —
    on the final scene one 50-bounce glass path makes 9.6M rays replay 51
    trips while the mean path is ~2.6.  Sorting rays by their tape depth
    and replaying each bucket only to its own (power-of-two-rounded, so
    jit retraces stay bounded) trip count cuts replay work to
    ~R x mean_len instead of R x max_len, with bit-identical per-ray
    radiance (replay is per-ray independent).

    Bucket boundaries follow the DEPTH LADDER (one bucket per distinct
    power-of-two trip level), not equal ray counts: deep paths are rare
    (geometric tail), and an equal-count split made the deepest quartile
    replay ~25% of rays at the full 51 trips — ~4x the ladder's total
    replay work (r5).  ``max_groups`` is enforced by greedily merging the
    pair with the smallest extra-work penalty (merging a bucket upward
    into the next trip level is always radiance-preserving: rays just
    replay rows their tape marks dead).  Boundaries are floor-quantized
    to ``quantum`` rays — moving a boundary down only promotes rays into
    the deeper bucket — so jit sees a bounded set of bucket shapes.

    Returns ``(order, groups)``: ``order`` is the (R,) i32 permutation,
    ``groups`` a tuple of ``(start, size, trips)`` covering ``order``.
    """
    t = np.asarray(jax.device_get(tape))
    D, R = t.shape
    if R == 0:
        return jnp.zeros((0,), jnp.int32), ((0, 0, 1),)
    hit_any = t >= 0
    # Trips ray i needs: one past its deepest hit (the miss that follows),
    # capped at D; no-hit rays need exactly 1 (the sky trip).
    deepest = np.where(hit_any.any(axis=0),
                       (D - 1) - np.argmax(hit_any[::-1], axis=0), -1)
    need = np.minimum(deepest + 2, D).astype(np.int64)
    need = np.maximum(need, 1)
    order = np.argsort(need, kind="stable").astype(np.int32)
    sorted_need = need[order]
    # Tiny tapes (tests, small fits) still deserve multiple buckets.
    quantum = max(1, min(quantum, R // 16))

    def pow2_trips(n):
        return min(1 << max(int(n) - 1, 0).bit_length(), D)

    levels = sorted({pow2_trips(n) for n in
                     np.unique(sorted_need).tolist()})
    groups = []
    start = 0
    for lv in levels:
        end = int(np.searchsorted(sorted_need, lv, side="right"))
        if lv != levels[-1]:
            end = max((end // quantum) * quantum, start)
        if end > start:
            groups.append([start, end - start, lv])
            start = end
    if start < R:  # quantization left a tail for the deepest level
        if groups and groups[-1][2] == levels[-1]:
            groups[-1][1] += R - start
        else:
            groups.append([start, R - start, levels[-1]])
    # Enforce max_groups: merge the adjacent pair whose merge costs the
    # least extra replay work (size_lo x (trips_hi - trips_lo)).
    while len(groups) > max_groups:
        pen = [groups[i][1] * (groups[i + 1][2] - groups[i][2])
               for i in range(len(groups) - 1)]
        i = int(np.argmin(pen))
        groups[i + 1] = [groups[i][0], groups[i][1] + groups[i + 1][1],
                         groups[i + 1][2]]
        del groups[i]
    return jnp.asarray(order), tuple(tuple(g) for g in groups)


def _mat_block(scene, mat_ids):
    """(N, 11) f32 material payload rows for per-primitive material ids."""
    f32 = jnp.float32
    return jnp.concatenate([
        scene.mat_type[mat_ids].astype(f32)[:, None],
        scene.fuzz[mat_ids][:, None],
        scene.ref_idx[mat_ids][:, None],
        scene.albedo[mat_ids],
        scene.albedo2[mat_ids],
        scene.tex_scale[mat_ids][:, None],
        scene.tex_type[mat_ids].astype(f32)[:, None],
    ], axis=1)


def _payload_tables(scene):
    """Per-primitive payload tables: (Ns, 4+11) spheres, (Nt, 9+11) tris.

    Geometry + the winner's material row in one table, so the replay
    extracts everything a bounce needs with a single one-hot matmul per
    primitive type.  Differentiable in every scene leaf (built by concat +
    Np-sized gathers).
    """
    sph = tri = None
    if scene.num_spheres:
        sph = jnp.concatenate([
            scene.sphere_center, scene.sphere_radius[:, None],
            _mat_block(scene, scene.sphere_mat)], axis=1)
    if scene.num_triangles:
        tri = jnp.concatenate([
            scene.tri_v0, scene.tri_v1, scene.tri_v2,
            _mat_block(scene, scene.tri_mat)], axis=1)
    return sph, tri


# Above this primitive count the (R, N) one-hot materialization costs
# more HBM traffic than the scatter-add it avoids (at 20k primitives it
# is gigabytes per trip); large scenes fall back to a plain gather.
_ONEHOT_MAX = 4096


def _extract(table, idx):
    """Payload extraction: rows ``table[idx]``.

    Small tables: a one-hot matmul — (R, N) one-hot @ (N, C), exact at
    HIGHEST precision (float32, not TF32) since each output is a single
    1.0 x value product — whose backward transposes to
    another matmul instead of R scatter-adds per field per bounce.
    Tables above ``_ONEHOT_MAX`` rows: a plain gather (backward is a
    scatter-add, which at that scale is cheaper than materializing the
    (R, N) one-hot).
    """
    if table.shape[0] > _ONEHOT_MAX:
        return table[idx]
    iota = jnp.arange(table.shape[0], dtype=idx.dtype)
    onehot = (idx[:, None] == iota[None, :]).astype(table.dtype)
    return jnp.matmul(onehot, table,
                      precision=jax.lax.Precision.HIGHEST)


def _resolve_from_tape(scene, sph_t, tri_t, o, dr, rec, t_min):
    """Differentiable hit record + material payload from recorded ids.

    Mirrors render.integrator.recompute_hit branch-for-branch (clipped ids,
    masked mixed select) with gathers replaced by payload matmuls.
    Returns (t, p, n, mat_payload) — mat_payload is the (R, 11) block.
    """
    ns, nt = scene.num_spheres, scene.num_triangles
    rec0 = jnp.maximum(rec, 0)
    if nt == 0:
        pay = _extract(sph_t, jnp.minimum(rec0, ns - 1))
        c, r = pay[:, 0:3], pay[:, 3]
        t = sphere_hit_one(o, dr, c, r, t_min, BIG)
        p, n = sphere_normal(o, dr, t, c, r)
        return t, p, n, pay[:, 4:]
    if ns == 0:
        pay = _extract(tri_t, jnp.minimum(rec0, nt - 1))
        v0, v1, v2 = pay[:, 0:3], pay[:, 3:6], pay[:, 6:9]
        t = triangle_hit_one(o, dr, v0, v1, v2, t_min, BIG)
        return t, point_at(o, dr, t), triangle_normal(v0, v1, v2), pay[:, 9:]
    is_sph = rec0 < ns
    pay_s = _extract(sph_t, jnp.clip(rec0, 0, ns - 1))
    pay_t = _extract(tri_t, jnp.clip(rec0 - ns, 0, nt - 1))
    c, r = pay_s[:, 0:3], pay_s[:, 3]
    v0, v1, v2 = pay_t[:, 0:3], pay_t[:, 3:6], pay_t[:, 6:9]
    t_s = sphere_hit_one(o, dr, c, r, t_min, BIG)
    t_t = triangle_hit_one(o, dr, v0, v1, v2, t_min, BIG)
    t = jnp.where(is_sph, t_s, t_t)
    p = point_at(o, dr, t)
    _, n_s = sphere_normal(o, dr, t, c, r)
    n = jnp.where(is_sph[:, None], n_s, triangle_normal(v0, v1, v2))
    mat = jnp.where(is_sph[:, None], pay_s[:, 4:], pay_t[:, 9:])
    return t, p, n, mat


def trace_rays_replay(scene, origin, direction, ray_ids, key,
                      cfg: RenderConfig, tape, unroll: int = 2):
    """Differentiable radiance from a recorded primitive tape.

    Identical masked math to ``trace_rays`` with the intersector replaced
    by a tape lookup; trips = ``tape.shape[0]`` (slice the tape with
    ``live_trips`` to skip all-dead rows).  The bounce body is
    rematerialized (``jax.checkpoint``) so the backward sweep recomputes
    the O(R) bounce math instead of storing one residual set per trip.
    ``unroll`` packs several bounces per XLA loop step — per-step dispatch
    overhead, not compute, dominates small-batch replays.
    """
    R = origin.shape[0]
    f32 = jnp.float32
    i32 = jnp.int32
    sph_t, tri_t = _payload_tables(scene)

    def bounce(state, inputs):
        d, rec = inputs
        o, dr, throughput, radiance, alive = state
        t, p, n, matp = _resolve_from_tape(scene, sph_t, tri_t, o, dr, rec,
                                           cfg.t_min)
        hit = (rec >= 0) & (t < BIG)
        p = jnp.where(hit[:, None], p, 0.0)
        n = jnp.where(hit[:, None], n, jnp.array([0.0, 0.0, 1.0], f32))

        miss_now = alive & ~hit
        radiance = radiance + jnp.where(
            miss_now[:, None], throughput * sky_color(dr), 0.0)

        uniforms = rng.bounce_uniforms(key, ray_ids, d)
        tex = texture_from_params(matp[:, 10].astype(i32), matp[:, 3:6],
                                  matp[:, 6:9], matp[:, 9], p)
        new_dir, attenuation, scattered_ok = scatter_from_params(
            matp[:, 0].astype(i32), matp[:, 1], matp[:, 2], tex,
            dr, p, n, uniforms)
        cont = alive & hit & scattered_ok & (d < cfg.max_depth)

        throughput = jnp.where(cont[:, None], throughput * attenuation,
                               throughput)
        o = jnp.where(cont[:, None], p, o)
        dr = jnp.where(cont[:, None], new_dir, dr)
        return (o, dr, throughput, radiance, cont), None

    init = (origin, direction, jnp.ones((R, 3), f32),
            jnp.zeros((R, 3), f32), jnp.ones((R,), bool))
    state, _ = jax.lax.scan(
        jax.checkpoint(bounce, prevent_cse=False), init,
        (jnp.arange(tape.shape[0]), tape),
        unroll=min(unroll, tape.shape[0]))
    return state[3]
