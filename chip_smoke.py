#!/usr/bin/env python
"""Smoke test of the whole system on one GPU (or, with ``--cards 4``, of
its sharded paths on four).

Run from the repository root on a machine with an NVIDIA GPU:

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --cards 4  # four cards: the sharded comparisons

Everything runs in this one process.  Each phase prints one JSON line and
raises on failure, so any failed check exits non-zero; the last line is
``{"ok": true, "device": {...}}`` and is printed only when every phase
passed.  Phases (one card):

1. device: the default device must be a GPU.
2. compile: the path-tracing kernel at the final scene's real shapes,
   with its memory analysis.
3. forward: kernel vs plain wavefront on the final scene (and its golden
   checksum), kernel and wavefront per ray vs the NumPy oracle.
4. gradients: kernel tape vs XLA pool tape at 2^17 rays; over the rays
   no nudge moves, replay loss and gradients from the kernel's tape vs the
   pool tape's and vs reverse mode through the wavefront, with a wrong
   tape as the control that must fail; three ``cli fit --fast`` steps;
   matmul precision.
5. large scene: ``cli render --preset sphere-field`` and the closest hit of
   the routed tracer vs the BVH walk.
6. chip tests: ``pytest -m chip``.
7. bench: ``bench.py`` in its default and its grad mode.
"""
import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# Sizes of the gradient and large-scene checks.
GRAD_RAYS = 1 << 17
FIELD_RAYS = 1 << 16
FIT_ARGS = ["--preset", "random-spheres", "--nx", "512", "--ny", "256",
            "--spp", "1"]
# Nudges of the camera ray that find rays decided by near-ties.
NUDGES = (1e-6, 1e-5, 1e-4)
# Over the rays no nudge moves: replay loss and gradients from the
# kernel's tape vs the pool recorder's tape, and vs direct reverse mode
# through the plain wavefront summed in float64 over REF_SLICES slices.
GRAD_RTOL = 1e-4
REF_SLICES = 16
# Replay loss from the kernel's tape vs the pool recorder's, over all rays:
# the near-tie rays whose tapes differ move it (1.5e-4 measured on an
# H100); their gradients are not bounded (PERF.md, open questions).
ALL_RAYS_LOSS_RTOL = 1e-3


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def phase_device(jax, n_cards):
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX's default device is {devs[0].platform!r}")
    check(len(devs) >= n_cards, f"need {n_cards} GPUs, found {len(devs)}")
    emit("device", platform=devs[0].platform, kind=devs[0].device_kind,
         count=len(devs))
    return devs


def phase_compile(jax, mk, scene, cam, cfg, key):
    pack = mk.pack_scene_mega(scene)
    out = {}
    for name, fn in (
            ("render", lambda p, k: mk.render_pixels_mega(p, cam, cfg, k)),
            ("record", lambda p, k: mk.record_paths_mega(
                p, cam, cfg, k, num_rays=GRAD_RAYS))):
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(pack, key).compile()
        mem = compiled.memory_analysis()
        out[name] = {"compile_s": time.perf_counter() - t0,
                     "argument_bytes": mem.argument_size_in_bytes,
                     "output_bytes": mem.output_size_in_bytes,
                     "temp_bytes": mem.temp_size_in_bytes,
                     "code_bytes": mem.generated_code_size_in_bytes}
    emit("compile", **out)
    return pack


def phase_forward(jax, jnp, mk, scene, cam, cfg, key, pack):
    from first_raytracer.oracle.cpu_oracle import render_oracle
    from first_raytracer.render.api import render_image, render_ray_batch
    from first_raytracer.scene.builders import three_spheres

    rad, seg = mk.render_pixels_mega(pack, cam, cfg, key)
    img_k = np.asarray(rad / cfg.spp).reshape(cfg.ny, cfg.nx, 3)[::-1]
    img_w = np.asarray(render_image(scene, cam, cfg, seed=0))
    diff = np.abs(img_k - img_w)
    frac = float((diff > 1e-3).mean())
    checksum = float(jnp.sum(rad))
    with open(os.path.join(ROOT, "bench_golden.json")) as f:
        golden = json.load(f)["radiance_sum_final_1200x800_10spp"]
    rel = abs(checksum - golden) / golden

    # Per ray vs the NumPy oracle: the kernel renders each sample as its
    # own one-sample batch, so its pixel sums are per-ray radiance.
    s3, c3, g3 = three_spheres(nx=24, ny=12, spp=2)
    ids = jnp.arange(g3.num_rays, dtype=jnp.int32)
    orc = render_oracle(s3, c3, g3, seed=0, ray_ids=np.arange(g3.num_rays))
    wf = np.asarray(render_ray_batch(s3, c3, g3, key, ids))
    one = dataclasses.replace(g3, spp=1)
    p3 = mk.pack_scene_mega(s3)
    kr = np.stack([np.asarray(mk.render_pixels_mega(
        p3, c3, one, key, spp0=s, spp_total=g3.spp)[0])
        for s in range(g3.spp)], axis=1).reshape(-1, 3)
    err_k = float(np.abs(kr - orc).max())
    err_w = float(np.abs(wf - orc).max())
    emit("forward", frac_pixels_gt_1e3=frac, median_abs_diff=float(
        np.median(diff)), checksum=checksum, golden=golden,
         checksum_rel=rel, segments=int(np.asarray(seg, np.int64).sum()),
         oracle_max_abs_kernel=err_k, oracle_max_abs_wavefront=err_w)
    check(frac < 0.01, f"kernel vs wavefront: {frac:.4%} pixels > 1e-3")
    check(rel < 0.01, f"checksum {checksum} vs golden {golden}")
    check(err_k <= 5e-4 and err_w <= 5e-4,
          f"oracle per-ray error kernel {err_k}, wavefront {err_w}")


def ill_conditioned(jax, jnp, scene, cam, cfg, key, ids, eps_list=NUDGES,
                    n=16):
    """Which rays change their tape, as the plain XLA recorder records it,
    when the camera ray's direction is nudged by each ``eps`` in ``n``
    random ways (1e-6 is ~16 f32 ulps).

    Such a ray meets a near-tie somewhere on its path (two hit distances,
    a silhouette graze, a metal or dielectric decision at its boundary),
    or bounces chaotically in a narrow gap, so a last-ulp difference
    between two correct tracers may pick either branch.  The set is found
    from the plain recorder alone, without looking at the kernel.

    Returns the (R,) bool mask over ``ids`` (nudged by any ``eps``) and
    the cumulative count flagged up to each ``eps``.
    """
    from first_raytracer.core import rng
    from first_raytracer.core.vecmath import normalize
    from first_raytracer.diff.replay import record_paths
    from first_raytracer.render.camera import generate_rays

    rec = jax.jit(record_paths, static_argnames=("cfg",))
    ids = jnp.asarray(ids, jnp.int32)
    o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                         rng.camera_uniforms(key, ids))
    base = np.asarray(rec(scene, o, d, ids, key, cfg))
    gen = np.random.default_rng(0)
    flips, counts = np.zeros(ids.shape[0], bool), {}
    for eps in eps_list:
        for _ in range(n):
            dk = normalize(d + eps * jnp.asarray(
                gen.normal(size=d.shape), jnp.float32))
            flips |= (np.asarray(rec(scene, o, dk, ids, key, cfg))
                      != base).any(0)
        counts[eps] = int(flips.sum())
    return flips, counts


def rel_diff(a, b):
    """Relative L2 difference of ``a`` from the reference ``b``, per field
    of two gradient dicts (0 where both are zero)."""
    out = {}
    for f in b:
        num = float(np.linalg.norm(np.asarray(a[f]) - np.asarray(b[f])))
        den = float(np.linalg.norm(np.asarray(b[f])))
        out[f] = num / den if den else (0.0 if num == 0 else float("inf"))
    return out


def replay(params, scene, cam, cfg, key, ids, tape):
    """Loss (MSE against black) and gradients of the depth-bucketed replay
    of ``tape`` over ray ``ids``."""
    import jax.numpy as jnp

    from first_raytracer.diff.grad import render_loss_and_grads_bucketed

    target = jnp.zeros((ids.shape[0], 3), jnp.float32)
    return render_loss_and_grads_bucketed(params, scene, cam, cfg, key, ids,
                                          target, tape)


def reverse_mode(params, scene, cam, cfg, key, ids, slices=REF_SLICES):
    """The same loss and gradients by direct reverse mode through the plain
    wavefront (``method="scan"``), which traces its own paths.

    ``ids`` are taken in ``slices`` equal slices (any remainder is
    dropped) whose results are summed in float64: one float32 sum over
    ~1e5 rays drifts by ~3e-4 in the albedo gradient.  Returns
    ``(loss, grads, ids used)``.
    """
    import jax.numpy as jnp

    from first_raytracer.diff.grad import render_loss_and_grads

    ids = np.asarray(ids)[:ids.shape[0] // slices * slices]
    loss, grads = 0.0, None
    for part in np.split(ids, slices):
        lo, g = render_loss_and_grads(
            params, scene, cam, cfg, key, jnp.asarray(part),
            jnp.zeros((part.size, 3), jnp.float32), method="scan")
        loss += float(lo) / slices
        g = {f: np.asarray(v, np.float64) / slices for f, v in g.items()}
        grads = g if grads is None else {f: grads[f] + g[f] for f in g}
    return loss, grads, jnp.asarray(ids)


def compare(got, ref):
    """``(loss_rel, grads_rel)`` of ``got = (loss, grads)`` from ``ref``."""
    return (abs(float(got[0]) - float(ref[0])) / abs(float(ref[0])),
            rel_diff(got[1], ref[1]))


def within(loss_rel, grads_rel, rtol=GRAD_RTOL):
    return loss_rel <= rtol and all(v <= rtol for v in grads_rel.values())


def wrong_first_hits(tape, n, num_prims, seed=0):
    """``tape`` with the first hit of ``n`` random hitting rays replaced by
    another primitive: a recorder that is wrong on ``n`` rays."""
    gen = np.random.default_rng(seed)
    cols = gen.choice(np.nonzero(tape[0] >= 0)[0], n, replace=False)
    bad = np.array(tape)
    bad[0, cols] = (bad[0, cols] + gen.integers(1, num_prims, n)) % num_prims
    return bad


def _within_f32_rounding(scene, o, d, a, b):
    """Whether two closest-hit choices ``a``, ``b`` (ids, -1 = miss) of the
    same rays both stand within f32 rounding, recomputed in float64.

    A sphere hit is decided by b^2 - (|oc|^2 - r^2), a difference of terms
    of size |oc|^2: for a 0.2-radius sphere 100 units away, f32 rounding
    of those terms covers the outer few percent of its silhouette.  A
    choice is explained when either candidate's discriminant is within
    ~16 f32 ulps of those terms, or both hit at distances within 1e-5.
    Triangles are not modelled (never explained).
    """
    ns = scene.num_spheres
    center = np.asarray(scene.sphere_center, np.float64)
    radius = np.asarray(scene.sphere_radius, np.float64)
    o, d = o.astype(np.float64), d.astype(np.float64)
    graze, t = [], []
    for ids in (a, b):
        k = np.clip(ids, 0, ns - 1)
        oc = o - center[k]
        bq = (oc * d).sum(1)
        oc2, r2 = (oc * oc).sum(1), radius[k] ** 2
        disc = bq * bq - (oc2 - r2)
        sph = (ids >= 0) & (ids < ns)
        graze.append(np.where(sph, np.abs(disc) / (bq * bq + oc2 + r2),
                              np.inf))
        t.append(np.where(sph & (disc > 0),
                          -bq - np.sqrt(np.maximum(disc, 0)), np.inf))
    with np.errstate(invalid="ignore"):  # inf - inf where both miss
        tie = np.abs(t[0] - t[1]) <= 1e-5 * np.maximum(np.abs(t[1]), 1.0)
    return (np.minimum(graze[0], graze[1]) <= 1e-6) | tie


def _f32_dots_not_highest(jax, closed):
    """f32 dot_generals in a jaxpr (recursively) not at HIGHEST."""
    bad = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                prec = eqn.params.get("precision")
                f32 = any(v.aval.dtype == np.float32 for v in eqn.invars)
                hi = prec is not None and all(
                    p == jax.lax.Precision.HIGHEST
                    for p in (prec if isinstance(prec, tuple) else (prec,)))
                if f32 and not hi:
                    bad.append(str(eqn)[:160])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                    if hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                        walk(sub.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(closed.jaxpr)
    return bad


def phase_gradients(jax, jnp, mk, scene, cam, cfg, key, pack):
    """Kernel tape vs the XLA pool recorder's, and the replay of the
    kernel's tape vs the pool recorder's and vs direct reverse mode.

    The gradient comparisons run over the rays that no nudge of the camera
    ray moves (``ill_conditioned``), a set decided from the plain recorder
    alone, without looking at the kernel.  They fail when the kernel
    records a wrong path for any ray whose path is well decided, or when
    the replay's gradients differ from reverse mode through the plain
    wavefront.  A control tape with as many wrong first hits as the two
    recorders disagree on must fail both.
    """
    from first_raytracer import cli
    from first_raytracer.diff.grad import (
        render_loss_and_grads_bucketed, split_params)
    from first_raytracer.diff.replay import plan_buckets, record_paths_pool
    from first_raytracer.render.api import render_ray_batch

    R = GRAD_RAYS
    ids = jnp.arange(R, dtype=jnp.int32)
    tape_k = np.asarray(mk.record_paths_mega(pack, cam, cfg, key,
                                             num_rays=R))
    pool = jax.jit(record_paths_pool, static_argnames=("cfg", "pool_size"))
    tape_p = np.asarray(pool(scene, cam, cfg, key, ids, pool_size=1 << 14))
    agree = float((tape_k == tape_p).mean())
    div = (tape_k != tape_p).any(0)
    ill, ill_counts = ill_conditioned(jax, jnp, scene, cam, cfg, key, ids)

    params, _ = split_params(scene)
    ref_loss, ref_grads, well = reverse_mode(params, scene, cam, cfg, key,
                                             np.nonzero(~ill)[0])
    cols = np.asarray(well)
    n_wrong = max(int(div.sum()), 16)
    on_well = {
        "kernel": replay(params, scene, cam, cfg, key, well, tape_k[:, cols]),
        "pool": replay(params, scene, cam, cfg, key, well, tape_p[:, cols]),
        "control": replay(params, scene, cam, cfg, key, well,
                          wrong_first_hits(tape_k[:, cols], n_wrong,
                                           scene.num_primitives))}
    vs_pool = {k: compare(on_well[k], on_well["pool"])
               for k in ("kernel", "control")}
    vs_rev = {k: compare(v, (ref_loss, ref_grads))
              for k, v in on_well.items()}

    # Over all rays: kernel tape vs pool tape through one bucket plan.
    target = jnp.zeros((R, 3), jnp.float32)
    plan = plan_buckets(tape_p)
    all_k, all_p = (render_loss_and_grads_bucketed(
        params, scene, cam, cfg, key, ids, target, t, plan=plan)
        for t in (tape_k, tape_p))
    loss_all, grads_all = compare(all_k, all_p)

    # Matmul precision of the forward, record and differentiated replay.
    bad = []
    for closed in (
            jax.make_jaxpr(lambda p: render_loss_and_grads_bucketed(
                p, scene, cam, cfg, key, ids, target, tape_p,
                plan=plan))(params),
            jax.make_jaxpr(lambda s: pool(s, cam, cfg, key, ids,
                                          pool_size=1 << 14))(scene),
            jax.make_jaxpr(lambda s: render_ray_batch(s, cam, cfg, key,
                                                      ids))(scene)):
        bad += _f32_dots_not_highest(jax, closed)

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["fit", *FIT_ARGS, "--fast", "--opt", "adam", "--lr",
                  "0.05", "--steps", "3", "--log-every", "1"])
    losses = [json.loads(line)["loss"] for line in
              out.getvalue().splitlines() if line.startswith("{")]
    emit("gradients", tape_agree=agree, divergent_rays=int(div.sum()),
         divergent_rays_not_near_ties=int((div & ~ill).sum()),
         rays_flipped_by_nudge=ill_counts, well_decided_rays=int(cols.size),
         control_wrong_rays=n_wrong,
         vs_pool_tape={k: {"loss": v[0], "grads": v[1]}
                       for k, v in vs_pool.items()},
         vs_reverse_mode={k: {"loss": v[0], "grads": v[1]}
                          for k, v in vs_rev.items()},
         loss_rel_all_rays=loss_all, grad_rel_all_rays=grads_all,
         fit_losses=losses, f32_dots_below_highest=bad)
    check(agree >= 0.999, f"tape agreement {agree:.5%}")
    check(not (div & ~ill).any(),
          f"{int((div & ~ill).sum())} divergent rays are not near-ties")
    check(within(*vs_pool["kernel"]),
          f"kernel vs pool tape on well-decided rays: {vs_pool['kernel']}")
    for k in ("kernel", "pool"):
        check(within(*vs_rev[k]),
              f"{k}-tape replay vs reverse mode: {vs_rev[k]}")
    check(not within(*vs_pool["control"]) and not within(*vs_rev["control"]),
          "a tape wrong on %d rays passed the gradient checks" % n_wrong)
    check(loss_all <= ALL_RAYS_LOSS_RTOL,
          f"all-ray loss, kernel vs pool tape: {loss_all}")
    check(len(losses) == 3 and np.isfinite(losses).all()
          and losses[0] > losses[1] > losses[2], f"fit losses {losses}")
    check(not bad, f"f32 matmuls below HIGHEST: {bad}")


def phase_large_scene(jax, jnp, mk, key):
    from first_raytracer import cli
    from first_raytracer.accel.build import build_bvh
    from first_raytracer.accel.traverse import intersect_bvh
    from first_raytracer.core import rng
    from first_raytracer.render.camera import generate_rays
    from first_raytracer.render.routing import use_kernel
    from first_raytracer.scene.builders import sphere_field

    scene, cam, cfg = sphere_field()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cli.main(["render", "--preset", "sphere-field", "--out",
                  os.path.join(tmp, "field.png")])
        cli_s = time.perf_counter() - t0
    # cli render routes this scene to the kernel (render/routing.py).
    check(use_kernel(scene), "sphere-field no longer routes to the kernel")
    n = min(FIELD_RAYS, cfg.num_rays)
    ids = jnp.arange(n, dtype=jnp.int32) * (cfg.num_rays // n)
    o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                         rng.camera_uniforms(key, ids))
    prim, _, hit = jax.jit(intersect_bvh)(scene, build_bvh(scene), o, d,
                                          cfg.t_min)
    want = np.where(np.asarray(hit), np.asarray(prim), -1)
    pack = mk.pack_scene_mega(scene)
    # Depth-0 tape entries are the camera rays' closest hits.
    got = np.asarray(mk.record_paths_mega(pack, cam, cfg, key)[0])
    got = got[np.asarray(ids)]
    rad, _ = mk.render_pixels_mega(pack, cam, cfg, key)
    checksum = float(jnp.sum(rad))
    with open(os.path.join(ROOT, "bench_golden.json")) as f:
        golden = json.load(f)["radiance_sum_field20000_800x450_4spp"]
    agree = float((got == want).mean())
    diff = np.nonzero(got != want)[0]
    rounding = _within_f32_rounding(scene, np.asarray(o)[diff],
                                    np.asarray(d)[diff], got[diff],
                                    want[diff])
    emit("large_scene", primitives=scene.num_primitives, cli_render_s=cli_s,
         closest_hit_agree_vs_bvh=agree, disagreeing_rays=int(diff.size),
         disagreeing_within_f32_rounding=int(rounding.sum()),
         checksum=checksum, golden=golden)
    check(agree >= 0.99, f"closest hit vs BVH agreement {agree:.5%}")
    check(bool(rounding.all()), f"{int((~rounding).sum())} closest-hit "
          "disagreements are not within f32 rounding")
    check(abs(checksum - golden) / golden < 0.01,
          f"field checksum {checksum} vs golden {golden}")


def phase_chip_tests():
    import pytest

    os.environ["FRT_TESTS_ON_CHIP"] = "1"
    rc = pytest.main(["-q", "-m", "chip", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_chip.py")])
    emit("chip_tests", pytest_exit=int(rc))
    check(rc == 0, f"pytest -m chip exit {rc}")


def phase_bench():
    import bench

    for mode in ("mega", "grad"):
        os.environ["BENCH_MODE"] = mode
        rc = bench.main()
        check(rc == 0, f"bench.py {mode} exit {rc}")
    os.environ.pop("BENCH_MODE")
    emit("bench", modes=["mega", "grad"])


def run_one_card(jax, jnp):
    from first_raytracer.core import rng
    from first_raytracer.kernels import megakernel as mk
    from first_raytracer.scene.builders import random_scene

    scene, cam, cfg = random_scene()
    key = rng.base_key(0)
    pack = phase_compile(jax, mk, scene, cam, cfg, key)
    phase_forward(jax, jnp, mk, scene, cam, cfg, key, pack)
    phase_gradients(jax, jnp, mk, scene, cam, cfg, key, pack)
    phase_large_scene(jax, jnp, mk, key)
    phase_chip_tests()
    phase_bench()


def run_four_cards(jax, jnp, devs):
    """Each sharded path vs its own single-card run, on the final scene."""
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from first_raytracer.core import rng
    from first_raytracer.diff.grad import (render_loss_and_grads_tape,
                                           split_params)
    from first_raytracer.kernels import megakernel as mk
    from first_raytracer.parallel.mesh import TILE_AXIS, make_render_mesh
    from first_raytracer.parallel.ring import render_image_ring
    from first_raytracer.parallel.shard import render_image_sharded
    from first_raytracer.scene.builders import random_scene

    devs = devs[:4]
    scene, cam, cfg = random_scene()
    key = rng.base_key(0)
    res = {}

    # The same wavefront program on one card (a 1x1 mesh) is the
    # reference for both sharded wavefront renders.
    single = np.asarray(render_image_sharded(
        scene, cam, cfg, make_render_mesh(1, 1, devs[:1])))
    wf = np.asarray(render_image_sharded(scene, cam, cfg,
                                         make_render_mesh(2, 2, devs)))
    res["wavefront_2x2_max_abs"] = float(np.abs(wf - single).max())
    ring = np.asarray(render_image_ring(scene, cam, cfg,
                                        make_render_mesh(4, 1, devs)))
    res["ring_4_max_abs"] = float(np.abs(ring - single).max())

    mesh = make_render_mesh(4, 1, devs)
    k1 = np.asarray(mk.render_image_mega(scene, cam, cfg))
    k4 = np.asarray(mk.render_image_mega_sharded(scene, cam, cfg, mesh))
    res["kernel_4x1_bit_identical"] = bool(np.array_equal(k1, k4))

    # Sharded record -> replay step: each card records its own ray range
    # with the kernel and replays it; gradients are all-reduced by GSPMD.
    R = GRAD_RAYS
    pack = mk.pack_scene_mega(scene)
    r_loc = R // 4

    @jax.jit
    @functools.partial(shard_map, mesh=mesh, in_specs=(P(), P()),
                       out_specs=P(None, TILE_AXIS), check_vma=False)
    def record(pack, key):
        ray0 = jax.lax.axis_index(TILE_AXIS) * r_loc
        return mk.record_paths_mega(pack, cam, cfg, key, ray0=ray0,
                                    num_rays=r_loc)

    ids = jnp.arange(R, dtype=jnp.int32)
    target = jnp.zeros((R, 3), jnp.float32)
    params, _ = split_params(scene)
    tape4 = record(pack, key)
    tape1 = mk.record_paths_mega(pack, cam, cfg, key, num_rays=R)
    res["tapes_equal"] = bool(np.array_equal(np.asarray(tape4),
                                             np.asarray(tape1)))
    sh = NamedSharding(mesh, P(TILE_AXIS))
    l4, g4 = render_loss_and_grads_tape(
        jax.device_put(params, NamedSharding(mesh, P())), scene, cam, cfg,
        key, jax.device_put(ids, sh), jax.device_put(target, sh), tape4)
    l1, g1 = render_loss_and_grads_tape(params, scene, cam, cfg, key, ids,
                                        target, tape1)
    res["grad_loss_rel"] = abs(float(l4) - float(l1)) / abs(float(l1))
    res["grad_max_abs_diff"] = {
        f: float(np.abs(np.asarray(g4[f]) - np.asarray(g1[f])).max(
            initial=0.0)) for f in g1}
    res["grad_allclose_rtol_1e-5"] = all(
        np.allclose(np.asarray(g4[f]), np.asarray(g1[f]), rtol=1e-5,
                    atol=1e-7) for f in g1)
    emit("four_cards", **res)
    check(res["wavefront_2x2_max_abs"] <= 1e-5, "wavefront 2x2 vs single")
    check(res["kernel_4x1_bit_identical"], "kernel 4x1 not bit-identical")
    check(res["ring_4_max_abs"] <= 1e-6, "ring vs replicated")
    check(res["grad_loss_rel"] <= 1e-5 and res["grad_allclose_rtol_1e-5"],
          "sharded gradient step vs single card")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded comparisons on 4 GPUs")
    args = ap.parse_args(argv)
    print(card_line(), flush=True)

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    from first_raytracer.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    devs = phase_device(jax, args.cards)
    if args.cards == 4:
        run_four_cards(jax, jnp, devs)
    else:
        run_one_card(jax, jnp)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": args.cards}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
