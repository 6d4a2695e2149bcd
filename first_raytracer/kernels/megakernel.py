"""The path tracer as one Pallas kernel on the Triton route (Hopper GPUs).

The wavefront integrator (render/integrator.py) re-architects the
reference's recursive ``color()`` [E: main.cpp] (SURVEY.md §3.2) as one
XLA pass per bounce over a chunk of rays: every bounce writes each ray's
origin, direction and throughput to device memory and reads them back, and
keeps sweeping dead rays until the chunk's longest path ends.  This module
traces each path to termination inside one kernel instead, the way GPU
path tracers are built:

- One program per block of ``block`` lanes; the GPU's block scheduler
  balances the programs over the SMs.  When rendering, a lane owns a
  pixel's ``S`` samples and regenerates its next camera ray in registers
  when a path ends, so a lane's work averages over its samples; when
  recording, a lane owns one ray.
- Ray state (origin, direction, throughput, radiance, depth, sample) lives
  in registers for the whole path.
- Closest hit: a loop over the primitives with a compare/select of
  ``(t, id)``.  Strict ``<`` keeps the lowest id on ties, as ``argmin`` in
  ``render.integrator.intersect_brute`` does.
- The winner's material and normal data come from indexed loads of its row
  in a per-primitive table in global memory.
- RNG is the same counter-based Threefry-2x32-20 as ``core.rng`` on uint32
  registers, bit-identical, so the kernel traces the same paths as the
  wavefront integrator and the oracles.  The per-bounce arithmetic mirrors
  ``geometry``/``materials`` op for op; what differs is FMA contraction
  and the device's ``cbrt``, which can flip rare near-silhouette samples.

The same body records the record->replay tape (``record=True``, static):
it writes the winning primitive id per (bounce, ray) instead of radiance.

Every ``pallas_call`` names ``backend="triton"``.  ``interpret=True`` runs
the kernel on the CPU for tests and is only ever passed explicitly.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..geometry.sphere import BIG
from ..geometry.triangle import triangle_normal

__all__ = ["MegaScenePack", "pack_scene_mega", "render_pixels_mega",
           "render_image_mega", "render_image_mega_sharded",
           "record_paths_mega", "BLOCK"]

# Lanes per program, one lane per thread (block / 32 warps).  Measured on
# an H100 with tools/kernel_vs_plain.py (PERF.md): 32 lanes on one warp
# rendered the final scene fastest of 32, 64, 128 and 256, and recorded
# 2^17-ray tapes of the final scene and of sphere-field 20,000 fastest of
# 32, 64 and 128.
BLOCK = 32
# Triton software-pipelining stages; 1, 2 and 3 measure the same there.
NUM_STAGES = 1

# Threefry-2x32-20 schedule: must match core.rng exactly.
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA

# Per-primitive table columns (prim_tbl, one row per global primitive id).
_C_MTYPE, _C_TEX, _C_FUZZ, _C_IOR = 0, 1, 2, 3
_C_ALB, _C_ALB2, _C_SCALE = 4, 7, 10
_C_GEOM = 12  # sphere: center xyz, radius; triangle: unit normal xyz, 0
_NORM_EPS = 1e-20


@dataclasses.dataclass(frozen=True)
class MegaScenePack:
    """Device tables the kernel reads (built by ``pack_scene_mega``).

    ``sph`` (Ns, 4): center, radius.  ``tri`` (Nt, 9): v0, v1 - v0,
    v2 - v0 (the host-exact edges ``_moller_trumbore`` forms).  ``prim``
    (Ns + Nt, 16): the material row and normal data of each global
    primitive id, gathered once per bounce for the winner only.
    """

    sph: jax.Array
    tri: jax.Array
    prim: jax.Array
    ns: int
    nt: int


jax.tree_util.register_dataclass(
    MegaScenePack, data_fields=("sph", "tri", "prim"),
    meta_fields=("ns", "nt"))


def pack_scene_mega(scene) -> MegaScenePack:
    """Scene SoA -> kernel tables (device ops; cheap enough per fit step)."""
    f32 = jnp.float32
    ns, nt = scene.num_spheres, scene.num_triangles

    def mat_rows(mat):
        return jnp.concatenate([
            scene.mat_type[mat].astype(f32)[:, None],
            scene.tex_type[mat].astype(f32)[:, None],
            scene.fuzz[mat][:, None], scene.ref_idx[mat][:, None],
            scene.albedo[mat], scene.albedo2[mat],
            scene.tex_scale[mat][:, None],
            jnp.zeros((mat.shape[0], 1), f32)], axis=1)

    rows = []
    sph = jnp.zeros((0, 4), f32)
    tri = jnp.zeros((0, 9), f32)
    if ns:
        sph = jnp.concatenate([scene.sphere_center,
                               scene.sphere_radius[:, None]], axis=1)
        rows.append(jnp.concatenate([mat_rows(scene.sphere_mat), sph],
                                    axis=1))
    if nt:
        v0 = scene.tri_v0
        tri = jnp.concatenate([v0, scene.tri_v1 - v0, scene.tri_v2 - v0],
                              axis=1)
        n = triangle_normal(v0, scene.tri_v1, scene.tri_v2)
        rows.append(jnp.concatenate([mat_rows(scene.tri_mat), n,
                                     jnp.zeros((nt, 1), f32)], axis=1))
    # One-row placeholders keep every operand non-empty.
    if not ns:
        sph = jnp.zeros((1, 4), f32)
    if not nt:
        tri = jnp.zeros((1, 9), f32)
    return MegaScenePack(sph=sph.astype(f32), tri=tri.astype(f32),
                         prim=jnp.concatenate(rows, axis=0).astype(f32),
                         ns=ns, nt=nt)


def _threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32-20 on uint32 vectors: mirrors ``core.rng``."""
    u32 = jnp.uint32
    ks = (k0, k1, k0 ^ k1 ^ u32(_PARITY))
    x0 = c0 + ks[0]
    x1 = c1 + ks[1]
    for g in range(5):
        for j in range(4):
            r = _ROTATIONS[(4 * g + j) % 8]
            x0 = x0 + x1
            x1 = (x1 << u32(r)) | (x1 >> u32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(g + 1) % 3]
        x1 = x1 + ks[(g + 2) % 3] + u32(g + 1)
    return x0, x1


def _unit(bits):
    """uint32 -> f32 in [0, 1) from the top 24 bits (``core.rng``)."""
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(
        1.0 / (1 << 24))


def _normalize(x, y, z, eps=0.0):
    """``core.vecmath.normalize`` in component form."""
    n2 = x * x + y * y + z * z
    if eps:
        n2 = jnp.maximum(n2, eps)
    inv = jnp.where(n2 > 0, 1.0 / jnp.sqrt(jnp.where(n2 > 0, n2, 1.0)), 0.0)
    return x * inv, y * inv, z * inv


def _tracer_kernel(cam_ref, key_ref, off_ref, sph_ref, tri_ref, prim_ref,
                   out_ref, seg_ref, it_ref, *, nx, ny, spp_total,
                   max_depth, t_min, n_lanes, n_cols, S, stride, ns, nt,
                   block, record):
    """One program traces ``block`` lanes x ``S`` samples to termination.

    Lane ``l`` owns samples ``s < S`` with global ray id
    ``off + l * stride + s`` (the first ``n_cols - l * S`` of them for the
    last lanes, none past ``n_lanes``).  Rendering
    sums a lane's samples into its pixel (``out_ref`` is (3, lanes));
    recording (``S == 1``, one ray per lane) writes
    ``out_ref[depth * lanes + lane]`` = winning primitive id, or -1
    (``out_ref`` is (D * lanes,), every entry written; padding lanes own
    their own columns, so no masked-off store aliases a live entry).
    """
    f32, i32, u32 = jnp.float32, jnp.int32, jnp.uint32
    pid = pl.program_id(0)
    lanes = -(-n_lanes // block) * block
    lane = pid * block + jax.lax.broadcasted_iota(i32, (block,), 0)
    # Samples this lane owns (0 for padding lanes).
    s_end = jnp.where(lane < n_lanes,
                      jnp.clip(n_cols - lane * S, 0, S), 0).astype(i32)
    base = off_ref[0]
    k0, k1 = key_ref[0], key_ref[1]
    cam = [cam_ref[k] for k in range(19)]
    co, ll, hz, vt, cu, cv = (cam[3 * j:3 * j + 3] for j in range(6))
    lens_r = cam[18]
    D = max_depth + 1

    def rid_of(s):
        return (base + lane * stride + jnp.minimum(s, S - 1)).astype(u32)

    def draws4(rid, dom):
        """``core.rng._uniforms``: counters (rid, 2 dom), (rid, 2 dom + 1)."""
        d2 = dom * u32(2)
        a0, a1 = _threefry2x32(k0, k1, rid, d2)
        b0, b1 = _threefry2x32(k0, k1, rid, d2 + u32(1))
        return _unit(a0), _unit(a1), _unit(b0), _unit(b1)

    def camera_ray(rid):
        """``render.camera.generate_rays`` for one ray per lane."""
        ju, jv, lu, lv = draws4(rid, jnp.zeros_like(rid))
        pix = jax.lax.div(rid.astype(i32), i32(spp_total))
        row = jax.lax.div(pix, i32(nx))
        i_f = (pix - row * nx).astype(f32)
        j_f = row.astype(f32)
        sf = (i_f + ju) / f32(nx)
        tf = (j_f + jv) / f32(ny)
        r = jnp.sqrt(lu)
        th = f32(2.0 * math.pi) * lv
        rd0 = lens_r * (r * jnp.cos(th))
        rd1 = lens_r * (r * jnp.sin(th))
        off = [rd0 * cu[k] + rd1 * cv[k] for k in range(3)]
        o = [co[k] + off[k] for k in range(3)]
        d = [ll[k] + sf * hz[k] + tf * vt[k] - co[k] - off[k]
             for k in range(3)]
        return o, list(_normalize(*d))

    def closest_hit(o, d):
        """Closest (t, global id): ``intersect_brute`` one ray per lane."""
        ox, oy, oz = o
        dx, dy, dz = d
        init = (jnp.full((block,), BIG, f32), jnp.zeros((block,), i32))

        def sphere(i, carry):
            bt, bw = carry
            ocx = ox - sph_ref[i, 0]
            ocy = oy - sph_ref[i, 1]
            ocz = oz - sph_ref[i, 2]
            r = sph_ref[i, 3]
            b = ocx * dx + ocy * dy + ocz * dz
            c = (ocx * ocx + ocy * ocy + ocz * ocz) - r * r
            disc = b * b - c
            has = disc > 0
            sq = jnp.sqrt(jnp.where(has, disc, 0.0))
            tn = -b - sq
            tf = -b + sq
            near = has & (tn > t_min) & (tn < BIG)
            far = has & (tf > t_min) & (tf < BIG)
            t = jnp.where(near, tn, jnp.where(far, tf, BIG))
            better = t < bt
            return jnp.where(better, t, bt), jnp.where(better, i, bw)

        def triangle(i, carry):
            bt, bw = carry
            v0x, v0y, v0z = tri_ref[i, 0], tri_ref[i, 1], tri_ref[i, 2]
            e1x, e1y, e1z = tri_ref[i, 3], tri_ref[i, 4], tri_ref[i, 5]
            e2x, e2y, e2z = tri_ref[i, 6], tri_ref[i, 7], tri_ref[i, 8]
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            ok = jnp.abs(det) > 1e-9
            inv = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
            tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
            u = (tx * px + ty * py + tz * pz) * inv
            qx = ty * e1z - tz * e1y
            qy = tz * e1x - tx * e1z
            qz = tx * e1y - ty * e1x
            v = (dx * qx + dy * qy + dz * qz) * inv
            t = (e2x * qx + e2y * qy + e2z * qz) * inv
            hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                   & (t > t_min) & (t < BIG))
            t = jnp.where(hit, t, BIG)
            better = t < bt
            return jnp.where(better, t, bt), jnp.where(better, ns + i, bw)

        carry = init
        if ns:
            carry = jax.lax.fori_loop(0, ns, sphere, carry)
        if nt:
            carry = jax.lax.fori_loop(0, nt, triangle, carry)
        return carry

    def body(carry):
        it, s, depth, o, d, tp, rad, segs = carry
        active = s < s_end
        t, w = closest_hit(o, d)
        hit = active & (t < BIG)
        if record:
            plgpu.store(out_ref.at[depth * lanes + lane],
                        jnp.where(hit, w, -1), mask=active)

        def row(k):
            return prim_ref[w, k]

        p = [o[k] + t * d[k] for k in range(3)]
        geom = [row(_C_GEOM + k) for k in range(4)]
        is_sph = w < ns
        n = [jnp.where(is_sph, (p[k] - geom[k]) / geom[3], geom[k])
             for k in range(3)]
        p = [jnp.where(hit, p[k], 0.0) for k in range(3)]
        n = [jnp.where(hit, n[k], f32(k == 2)) for k in range(3)]

        # ---- scatter: materials.scatter_from_params, op for op ----
        u1, u2, u3, coin = draws4(rid_of(s), (depth + 1).astype(u32))
        bz = 1.0 - 2.0 * u1
        br = jnp.sqrt(jnp.maximum(0.0, 1.0 - bz * bz))
        phi = f32(2.0 * math.pi) * u2
        brad = jax.lax.cbrt(u3)
        ball = [brad * (br * jnp.cos(phi)), brad * (br * jnp.sin(phi)),
                brad * bz]
        mtype = row(_C_MTYPE)
        is_metal = mtype == 1.0
        is_diel = mtype == 2.0
        fuzz = row(_C_FUZZ)
        ior = row(_C_IOR)

        lam = _normalize(*[n[k] + ball[k] for k in range(3)], eps=_NORM_EPS)
        ddn = d[0] * n[0] + d[1] * n[1] + d[2] * n[2]
        refl = [d[k] - 2.0 * ddn * n[k] for k in range(3)]
        mraw = [refl[k] + fuzz * ball[k] for k in range(3)]
        metal_ok = (mraw[0] * n[0] + mraw[1] * n[1] + mraw[2] * n[2]) > 0.0
        met = _normalize(*mraw, eps=_NORM_EPS)
        outside = ddn > 0.0
        on = [jnp.where(outside, -n[k], n[k]) for k in range(3)]
        ni = jnp.where(outside, ior, 1.0 / ior)
        cosine = jnp.where(outside, ior * ddn, -ddn)
        uv = _normalize(*d)
        dt = uv[0] * on[0] + uv[1] * on[1] + uv[2] * on[2]
        disc = 1.0 - ni * ni * (1.0 - dt * dt)
        can = disc > 0
        sq = jnp.sqrt(jnp.where(can, disc, 0.0))
        rfr = [jnp.where(can, ni * (uv[k] - on[k] * dt) - on[k] * sq, 0.0)
               for k in range(3)]
        r0 = (1.0 - ior) / (1.0 + ior)
        r0 = r0 * r0
        om = 1.0 - cosine
        om2 = om * om
        schlick = r0 + (1.0 - r0) * (om2 * om2 * om)
        use_refl = coin < jnp.where(can, schlick, 1.0)
        diel = [jnp.where(use_refl, a, b) for a, b in
                zip(_normalize(*refl, eps=_NORM_EPS),
                    _normalize(*rfr, eps=_NORM_EPS))]
        nd = [jnp.where(is_diel, diel[k], jnp.where(is_metal, met[k],
                                                    lam[k]))
              for k in range(3)]
        ok = jnp.where(is_metal, metal_ok, True)

        cont = hit & ok & (depth < max_depth)
        if not record:
            # Sky on a miss [E: main.cpp color()], then throughput.
            sky_t = 0.5 * (d[1] + 1.0)
            miss = active & ~hit
            rad = [rad[k] + jnp.where(
                miss, tp[k] * ((1.0 - sky_t) * 1.0 + sky_t * blue), 0.0)
                for k, blue in enumerate((0.5, 0.7, 1.0))]
            scale = row(_C_SCALE)
            sines = (jnp.sin(scale * p[0]) * jnp.sin(scale * p[1])
                     * jnp.sin(scale * p[2]))
            odd = (row(_C_TEX) == 1.0) & (sines < 0.0)
            att = [jnp.where(is_diel, 1.0,
                             jnp.where(odd, row(_C_ALB2 + k),
                                       row(_C_ALB + k)))
                   for k in range(3)]
            tp = [jnp.where(cont, tp[k] * att[k], tp[k]) for k in range(3)]
        o = [jnp.where(cont, p[k], o[k]) for k in range(3)]
        d = [jnp.where(cont, nd[k], d[k]) for k in range(3)]
        depth = jnp.where(cont, depth + 1, depth)
        segs = segs + active.astype(i32)

        # ---- path end: regenerate the lane's next sample in place ----
        term = active & ~cont
        s = jnp.where(term, s + 1, s)
        regen = term & (s < s_end)
        co_, cd_ = camera_ray(rid_of(s))
        o = [jnp.where(regen, co_[k], o[k]) for k in range(3)]
        d = [jnp.where(regen, cd_[k], d[k]) for k in range(3)]
        if not record:
            tp = [jnp.where(regen, 1.0, tp[k]) for k in range(3)]
        depth = jnp.where(regen, 0, depth)
        return it + 1, s, depth, o, d, tp, rad, segs

    max_it = S * D + 1

    def cond(carry):
        it, s = carry[0], carry[1]
        busy = jnp.max((s < s_end).astype(i32)) > 0
        return (it < max_it) & busy

    zero = jnp.zeros((block,), f32)
    izero = jnp.zeros((block,), i32)
    if record:
        # Every tape entry of this lane's ray starts as -1 (miss/dead).
        miss = jnp.full((block,), -1, i32)
        for dep in range(D):
            out_ref[pl.ds(dep * lanes + pid * block, block)] = miss
    o0, d0 = camera_ray(rid_of(izero))
    init = (jnp.int32(0), izero, izero, o0, d0, [zero + 1.0] * 3,
            [zero] * 3, izero)
    it, _, _, _, _, _, rad, segs = jax.lax.while_loop(cond, body, init)
    if not record:
        for k in range(3):
            out_ref[k, pl.ds(pid * block, block)] = rad[k]
    seg_ref[pl.ds(pid * block, block)] = segs
    it_ref[pid] = it


def _cam_vec(camera):
    return jnp.concatenate([
        jnp.asarray(camera.origin, jnp.float32).reshape(3),
        jnp.asarray(camera.lower_left, jnp.float32).reshape(3),
        jnp.asarray(camera.horizontal, jnp.float32).reshape(3),
        jnp.asarray(camera.vertical, jnp.float32).reshape(3),
        jnp.asarray(camera.u, jnp.float32).reshape(3),
        jnp.asarray(camera.v, jnp.float32).reshape(3),
        jnp.asarray(camera.lens_radius, jnp.float32).reshape(1)])


def _launch(pack: MegaScenePack, cam, key, off, *, nx, ny, spp_total,
            max_depth, t_min, n_lanes, n_cols, S, stride, record,
            block=BLOCK, interpret=False):
    grid = max(1, -(-n_lanes // block))
    lanes = grid * block
    kernel = functools.partial(
        _tracer_kernel, nx=nx, ny=ny, spp_total=spp_total,
        max_depth=max_depth, t_min=t_min, n_lanes=n_lanes, n_cols=n_cols,
        S=S, stride=stride, ns=pack.ns, nt=pack.nt, block=block,
        record=record)
    if record:
        main = jax.ShapeDtypeStruct(((max_depth + 1) * lanes,), jnp.int32)
    else:
        main = jax.ShapeDtypeStruct((3, lanes), jnp.float32)
    return pl.pallas_call(
        kernel, grid=(grid,),
        out_shape=(main, jax.ShapeDtypeStruct((lanes,), jnp.int32),
                   jax.ShapeDtypeStruct((grid,), jnp.int32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=max(1, block // 32),
                                             num_stages=NUM_STAGES),
        interpret=interpret, name="path_tracer",
    )(cam, key, off, pack.sph, pack.tri, pack.prim)


_launch_jit = jax.jit(
    _launch, static_argnames=("nx", "ny", "spp_total", "max_depth", "t_min",
                              "n_lanes", "n_cols", "S", "stride", "record",
                              "block", "interpret"))


def _key(key):
    return jnp.asarray(key, jnp.uint32).reshape(2)


def render_pixels_mega(pack: MegaScenePack, camera, cfg, key, spp0=0,
                       spp_total: int = None, interpret: bool = False,
                       block: int = BLOCK, return_iters: bool = False, pix0=0,
                       num_pixels: int = None):
    """Radiance sums of pixels ``[pix0, pix0 + num_pixels)``.

    Returns ``(radiance_sum (P, 3), segments (P,) i32)``: the sum over
    samples ``[spp0, spp0 + cfg.spp)`` of each pixel, in a
    ``spp_total``-samples-per-pixel ray-id space (progressive batches),
    and the path segments each pixel traced.  ``return_iters`` adds the
    bounce-loop trip count of each program (lane occupancy =
    segments.sum() / (iters.sum() * block)).  ``spp0`` and ``pix0`` may be
    traced.
    """
    spp_total = cfg.spp if spp_total is None else spp_total
    num_pixels = cfg.num_pixels if num_pixels is None else num_pixels
    if cfg.num_pixels * spp_total >= 1 << 31:
        raise ValueError("ray ids must fit in int32")
    off = (jnp.asarray(pix0, jnp.int32) * spp_total
           + jnp.asarray(spp0, jnp.int32)).reshape(1)
    rad, seg, its = _launch_jit(
        pack, _cam_vec(camera), _key(key), off, nx=cfg.nx, ny=cfg.ny,
        spp_total=spp_total, max_depth=cfg.max_depth,
        t_min=float(cfg.t_min), n_lanes=num_pixels,
        n_cols=num_pixels * cfg.spp, S=cfg.spp, stride=spp_total,
        record=False, block=block, interpret=interpret)
    rad = rad[:, :num_pixels].T
    seg = seg[:num_pixels]
    if return_iters:
        return rad, seg, its
    return rad, seg


def render_image_mega(scene, camera, cfg, seed: int = 0,
                      interpret: bool = False, block: int = BLOCK):
    """Full-image render through the kernel; (ny, nx, 3), row 0 = top.

    Same RNG stream and radiance semantics as ``render.api.render_image``.
    """
    from ..core import rng

    rad, _ = render_pixels_mega(pack_scene_mega(scene), camera, cfg,
                                rng.base_key(seed), interpret=interpret,
                                block=block)
    return (rad / cfg.spp).reshape(cfg.ny, cfg.nx, 3)[::-1]


def render_image_mega_sharded(scene, camera, cfg, mesh, seed: int = 0,
                              interpret: bool = False, block: int = BLOCK):
    """Kernel render with pixels split over the mesh's ``tiles`` axis.

    Each device traces a contiguous pixel block with the globally keyed
    RNG, so the image is bit-identical to ``render_image_mega`` for any
    device count.  Scene tables and camera are replicated; the only
    collective is the gather of the output blocks.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..core import rng
    from ..parallel.mesh import TILE_AXIS

    pack = pack_scene_mega(scene)
    total = cfg.num_pixels
    p_local = -(-total // mesh.shape[TILE_AXIS])

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(P(), P(), P()),
                       out_specs=P(TILE_AXIS), check_vma=False)
    def run(pack, cam, key):
        pix0 = jax.lax.axis_index(TILE_AXIS) * p_local
        rad, _ = render_pixels_mega(
            pack, cam, cfg, key, pix0=pix0, num_pixels=p_local,
            interpret=interpret, block=block)
        # Pixels past the image (last shard's padding) are dropped below.
        return rad

    rad = run(pack, camera, rng.base_key(seed))[:total]
    return (rad / cfg.spp).reshape(cfg.ny, cfg.nx, 3)[::-1]


def record_paths_mega(pack: MegaScenePack, camera, cfg, key, ray0: int = 0,
                      num_rays: int = None, spp_total: int = None,
                      interpret: bool = False, block: int = BLOCK):
    """(max_depth + 1, R) i32 primitive tape for rays ``[ray0, ray0 + R)``.

    ``ray0`` may be traced (a shard's offset under ``shard_map``).

    The contract of ``diff.replay.record_paths``: ``tape[d, i]`` is the
    global primitive id ray ``ray0 + i`` hit at bounce ``d``, or -1 on
    miss/dead, so ``trace_rays_replay`` consumes it unchanged.
    """
    num_rays = cfg.num_rays if num_rays is None else num_rays
    spp_total = cfg.spp if spp_total is None else spp_total
    if isinstance(ray0, int) and ray0 + num_rays >= 1 << 31:
        raise ValueError("ray ids must fit in int32")
    tape, _, _ = _launch_jit(
        pack, _cam_vec(camera), _key(key),
        jnp.asarray(ray0, jnp.int32).reshape(1), nx=cfg.nx, ny=cfg.ny,
        spp_total=spp_total, max_depth=cfg.max_depth,
        t_min=float(cfg.t_min), n_lanes=num_rays, n_cols=num_rays, S=1,
        stride=1, record=True, block=block, interpret=interpret)
    return tape.reshape(cfg.max_depth + 1, -1)[:, :num_rays]
