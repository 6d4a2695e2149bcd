#!/usr/bin/env python
"""Benchmark harness: prints ONE JSON line.

Headline workload [BASELINE.json:8]: the random-spheres "final scene"
(~500 spheres) at 1200x800 @ 10spp, depth 50, on one GPU.  Metric: Mpaths/s
(paths = nx*ny*spp camera paths traced to termination); also reports
Mrays/s (traced path segments per second, from the tracer's counters).

Modes (``BENCH_MODE``): ``mega`` (default) is the path-tracing kernel
(kernels/megakernel.py); ``wavefront`` and ``regenerative`` are the plain
XLA integrators, with ``BENCH_INTERSECT=brute`` (default) or ``bvh``;
``grad`` times record + differentiated replay steps over
``BENCH_GRAD_RAYS`` rays, with the recorder chosen by render/routing.py.
``BENCH_SCENE=fieldN`` / ``trifieldN`` select the large-scene presets.

The run refuses to time anything but a GPU, and every line names the
device (platform, device_kind, device count).  Result-integrity guards:

- median of >=3 repeats; repeats disagreeing by >3x fail the run (a hung or
  no-op execution is not a measurement);
- the implied sweep-FLOP rate (segments x primitives x ~10 FLOP / median
  time) must stay below the device's FP32 peak from ``PEAKS``; a device
  missing from the table is an error;
- the forward modes' radiance checksum must match the committed golden
  (bench_golden.json) to 1%, so a no-op execution cannot score.  Goldens
  are read, never written.

On any guard failure: one JSON line with an "error" key, exit 2.
"""
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from first_raytracer.utils.cache import enable_persistent_cache

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "bench_golden.json")
# Published peaks per device, keyed by ``device_kind`` (dense rates at the
# full power limit).  FP32 is the rate outside the tensor cores, which is
# what the tracer's scalar arithmetic can use.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32_flops": 67e12, "hbm_bytes_s": 3.35e12,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, SXM5 column"},
    "NVIDIA H100 PCIe": {
        "fp32_flops": 51e12, "hbm_bytes_s": 2.0e12,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, PCIe column"},
}
MAX_REPEAT_SPREAD = 3.0


def peak_for(device_kind):
    """The ``PEAKS`` row of a device; an unknown device is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(f"no peak rates for device {device_kind!r}; add "
                         "its published peaks to bench.PEAKS") from None


def _fail(reason, **extra):
    print(json.dumps(dict(error=reason, **extra)))
    return 2


def check_spread(times, max_spread=MAX_REPEAT_SPREAD):
    """None if repeat timings agree to ``max_spread``x, else a reason."""
    if max(times) / max(min(times), 1e-12) > max_spread:
        return "repeat timings disagree by >%gx" % max_spread
    return None


def check_flops(segments, num_prims, seconds, max_flops):
    """None if the implied sweep-FLOP rate is physically possible.

    A dense sweep costs ~10 FP32 ops per (segment, primitive), an
    under-count of the real ~20, so the implied rate can only exceed the
    device's peak ``max_flops`` when the timing is an artifact.
    """
    if not segments:
        return None
    implied = segments * num_prims * 10.0 / max(seconds, 1e-12)
    if implied > max_flops:
        return ("implied FLOP rate %.3g/s is physically impossible"
                % implied)
    return None


def check_checksum(checksum, golden, rtol=1e-2):
    """None if the radiance checksum matches the golden to ``rtol``."""
    rel = abs(checksum - golden) / max(abs(golden), 1e-9)
    if not rel < rtol:
        return ("radiance checksum %.6g mismatches golden %.6g "
                "(rel %.3g)" % (checksum, golden, rel))
    return None


def golden_key(scene_sel, cfg):
    return "radiance_sum_%s_%dx%d_%dspp" % (scene_sel or "final", cfg.nx,
                                            cfg.ny, cfg.spp)


def build_scene(scene_sel):
    from first_raytracer.scene.builders import (random_scene,
                                                sphere_field,
                                                triangle_field)
    if scene_sel.startswith("trifield"):
        return triangle_field(n=int(scene_sel[8:] or 20000))
    if scene_sel.startswith("field"):
        return sphere_field(n=int(scene_sel[5:] or 20000))
    if scene_sel:
        raise ValueError(f"unknown BENCH_SCENE {scene_sel!r}")
    return random_scene()  # 1200x800 @ 10spp, ~500 spheres


def main():
    enable_persistent_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py times GPUs only; found {dev.platform!r}",
              file=sys.stderr)
        return 1
    peak = peak_for(dev.device_kind)

    from first_raytracer.accel.build import build_bvh
    from first_raytracer.core import rng
    from first_raytracer.render.api import render_ray_batch
    from first_raytracer.render.camera import generate_rays
    from first_raytracer.render.integrator import trace_rays
    from first_raytracer.render.regenerative import (
        render_rays_regenerative)

    scene_sel = os.environ.get("BENCH_SCENE", "")
    scene, cam, cfg = build_scene(scene_sel)
    metric_name = "Mpaths/s %s %dx%d@%dspp" % (scene_sel or "final-scene",
                                               cfg.nx, cfg.ny, cfg.spp)
    mode = os.environ.get("BENCH_MODE", "mega")
    isect = os.environ.get("BENCH_INTERSECT", "brute")
    if isect not in ("brute", "bvh"):
        raise ValueError(f"unknown BENCH_INTERSECT {isect!r}")
    accel = build_bvh(scene, max_leaf=4) if isect == "bvh" else None
    pool = int(os.environ.get("BENCH_POOL", 1 << 17))
    chunk = int(os.environ.get("BENCH_CHUNK", 1 << 17))
    repeats = max(3, int(os.environ.get("BENCH_REPEATS", 3)))

    key = rng.base_key(0)
    total = cfg.num_rays
    count_rays = total

    if mode == "mega":
        from first_raytracer.kernels.megakernel import (
            pack_scene_mega, render_pixels_mega)
        isect = "kernel"
        mpack = pack_scene_mega(scene)

        def run():
            return render_pixels_mega(mpack, cam, cfg, key)
    elif mode == "grad":
        # Differentiable-pass throughput [BASELINE.json:11]: value+grad of
        # an MSE pixel loss w.r.t. the full DIFF_FIELDS parameter set via
        # record -> depth-bucketed replay (diff/replay.py), over
        # BENCH_GRAD_PIPELINE back-to-back steps with one device sync —
        # the steady-state shape of a fit loop.
        from first_raytracer.diff.grad import (
            render_loss_and_grads_bucketed, split_params)
        from first_raytracer.diff.replay import (plan_buckets,
                                                 record_paths_pool)
        from first_raytracer.kernels.megakernel import (
            pack_scene_mega, record_paths_mega)
        from first_raytracer.render.routing import kernel_records

        R = int(os.environ.get("BENCH_GRAD_RAYS", 1 << 17))
        pipe = max(1, int(os.environ.get("BENCH_GRAD_PIPELINE", 16)))
        ids = jnp.arange(R, dtype=jnp.int32)
        params, _ = split_params(scene)
        target = jnp.zeros((R, 3), jnp.float32)
        if kernel_records(scene, ids):
            isect = "kernel"
            gpack = pack_scene_mega(scene)

            def rec_tape():
                return record_paths_mega(gpack, cam, cfg, key, num_rays=R)
        else:
            isect = "pool"
            rec = jax.jit(record_paths_pool,
                          static_argnames=("cfg", "pool_size"))

            def rec_tape():
                return rec(scene, cam, cfg, key, ids, pool_size=1 << 14)
        # The plan is data-deterministic (fixed seed): computed once.
        plan = plan_buckets(rec_tape())

        def step():
            return render_loss_and_grads_bucketed(
                params, scene, cam, cfg, key, ids, target, rec_tape(),
                plan=plan)

        count_rays = R
        total = R * pipe

        def run():
            return [step() for _ in range(pipe)]
    elif mode == "regenerative":
        def run():
            return render_rays_regenerative(scene, cam, cfg, key,
                                            jnp.int32(0), total, accel,
                                            None, pool_size=pool)
    elif mode == "wavefront":
        blocks = [jnp.minimum(jnp.arange(s, s + chunk, dtype=jnp.int32),
                              total - 1) for s in range(0, total, chunk)]

        def run():
            return jnp.concatenate([render_ray_batch(
                scene, cam, cfg, key, b, accel) for b in blocks])[:total]
    else:
        raise ValueError(f"unknown BENCH_MODE {mode!r}")

    t0 = time.perf_counter()
    warm = jax.block_until_ready(run())  # compile + warm
    setup_s = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    best = sorted(times)[len(times) // 2]  # median
    err = check_spread(times)
    if err:
        return _fail(err, times=times)

    if mode != "grad":
        checksum = float(jnp.sum(warm[0] if mode == "mega" else warm))
        with open(GOLDEN) as f:
            gold = json.load(f)
        gkey = golden_key(scene_sel, cfg)
        if gkey not in gold:
            return _fail("no golden checksum %s" % gkey, checksum=checksum)
        err = check_checksum(checksum, gold[gkey])
        if err:
            return _fail(err)

    # True segment count: the kernel reports it; the other modes run one
    # instrumented plain pass over the same ray population (not timed).
    if mode == "mega":
        segments = int(np.asarray(warm[1], np.int64).sum())
    else:
        @jax.jit
        def seg_count(ids):
            cam_u = rng.camera_uniforms(key, ids)
            o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids, cam_u)
            _, segs = trace_rays(scene, o, d, ids, key, cfg, accel=accel,
                                 return_stats=True)
            return jnp.sum(segs)

        c = min(chunk, count_rays)
        segments = sum(int(seg_count(jnp.minimum(
            jnp.arange(s, s + c, dtype=jnp.int32), count_rays - 1)))
            for s in range(0, count_rays, c))
        segments = segments * (total // count_rays)

    err = check_flops(segments, scene.num_primitives, best,
                      peak["fp32_flops"])
    if err:
        return _fail(err, segments=segments, seconds=best)

    print(json.dumps({
        "metric": metric_name,
        "value": total / best / 1e6,
        "unit": "Mpaths/s",
        "mrays_s": segments / best / 1e6,
        "seconds": best,
        "times": times,
        "setup_s": setup_s,
        "mode": mode,
        "intersect": isect,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
