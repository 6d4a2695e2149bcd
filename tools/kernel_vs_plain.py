#!/usr/bin/env python
"""Time the path-tracing kernel against what XLA makes of the plain path.

Run from the repository root on a machine with a GPU:

    python tools/kernel_vs_plain.py                      # every GPU section
    python tools/kernel_vs_plain.py --only forward record
    JAX_PLATFORMS=cpu python tools/kernel_vs_plain.py --only checksums

Sections:

- ``forward``: final scene, 1200x800 @ 10spp: the kernel at each lane
  block (``--blocks``; block / 32 warps) vs ``render_image`` (wavefront and
  regenerative, ``intersect_brute``).
- ``stages``: the kernel's render and 2^17-ray record at Triton
  ``num_stages`` 1, 2 and 3.
- ``record``: a 2^17-ray tape of the final scene: the kernel at block 32,
  64 and 128 vs ``record_paths_pool`` (pool 2^14, dense sweep).
- ``grad``: 8 gradient steps (record + depth-bucketed replay, 2^17 rays)
  with each recorder.
- ``large``: 800x450 @ 4spp sphere and triangle fields at the sizes of
  ``--fields``/``--trifields``: the kernel vs the plain wavefront and
  regenerative integrators with the BVH walk, and with the brute sweep up
  to ``--brute-max`` primitives (``--large-paths`` picks among them).
- ``record_scale``: a 2^17-ray tape by the kernel vs the pool recorder on
  sphere and triangle fields at the sizes of ``--record-fields`` and
  ``--record-trifields``: where the recorder's crossover lies.
- ``hlo``: whether the brute sweep's (R, Np) distance matrix leaves its
  fusion in the optimized HLO at sphere-field 20,004 with 2^17-ray chunks.
- ``checksums``: radiance sums of bench.py's large scenes by the plain
  path (BVH, regenerative pool) on any backend: with ``JAX_PLATFORMS=cpu``,
  a witness for bench_golden.json that shares no compiler with the card.

Times are device-synced, the first call (compilation) excluded, the median
of ``--repeats`` (at least 3).  Each result is one JSON line on stdout,
after a line with the card's name and power limit from ``nvidia-smi``;
``--out FILE`` appends the lines to FILE too.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GPU_SECTIONS = ("forward", "stages", "record", "grad", "large",
                "record_scale", "hlo")
GRAD_RAYS = 1 << 17
POOL = 1 << 14


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def timed(jax, fn, repeats):
    """(first call s, median of ``repeats`` warm calls s, warm times)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return first, sorted(times)[len(times) // 2], times


class Runner:
    def __init__(self, args):
        import jax
        import jax.numpy as jnp

        from first_raytracer.core import rng
        from first_raytracer.scene.builders import random_scene

        self.jax, self.jnp, self.args = jax, jnp, args
        self.key = rng.base_key(0)
        self.final = random_scene()
        self.card = card_line()
        self.out = open(args.out, "a") if args.out else None

    def emit(self, section, **fields):
        line = json.dumps({"section": section, "card": self.card, **fields})
        print(line, flush=True)
        if self.out:
            self.out.write(line + "\n")
            self.out.flush()

    def time(self, fn):
        first, med, times = timed(self.jax, fn, self.args.repeats)
        return {"first_s": first, "median_s": med, "times": times}

    # -- sections ----------------------------------------------------------

    def forward(self):
        from first_raytracer.kernels import megakernel as mk
        from first_raytracer.render.api import render_image

        scene, cam, cfg = self.final
        pack = mk.pack_scene_mega(scene)
        for block in self.args.blocks:
            self.emit("forward", path="kernel", block=block,
                      warps=max(1, block // 32), **self.time(
                          lambda: mk.render_pixels_mega(pack, cam, cfg,
                                                        self.key,
                                                        block=block)))
        for path, mode in (("wavefront_brute", "wavefront"),
                           ("regenerative_brute", "regenerative")):
            if path in self.args.large_paths:
                self.emit("forward", path=path, **self.time(
                    lambda: render_image(scene, cam, cfg, mode=mode)))

    def stages(self):
        from first_raytracer.kernels import megakernel as mk

        scene, cam, cfg = self.final
        pack = mk.pack_scene_mega(scene)
        keep = mk.NUM_STAGES
        try:
            for n in (1, 2, 3):
                mk.NUM_STAGES = n
                self.jax.clear_caches()
                self.emit("stages", num_stages=n,
                          render=self.time(lambda: mk.render_pixels_mega(
                              pack, cam, cfg, self.key)),
                          record=self.time(lambda: mk.record_paths_mega(
                              pack, cam, cfg, self.key,
                              num_rays=GRAD_RAYS)))
        finally:
            mk.NUM_STAGES = keep
            self.jax.clear_caches()

    def _recorders(self, scene, cam, cfg, blocks):
        from first_raytracer.diff.replay import record_paths_pool
        from first_raytracer.kernels import megakernel as mk

        jnp = self.jnp
        pack = mk.pack_scene_mega(scene)
        ids = jnp.arange(GRAD_RAYS, dtype=jnp.int32)
        pool = self.jax.jit(record_paths_pool,
                            static_argnames=("cfg", "pool_size"))
        out = {f"kernel_block{b}": (lambda b=b: mk.record_paths_mega(
            pack, cam, cfg, self.key, num_rays=GRAD_RAYS, block=b))
            for b in blocks}
        out["pool"] = lambda: pool(scene, cam, cfg, self.key, ids,
                                   pool_size=POOL)
        return out

    def record(self):
        scene, cam, cfg = self.final
        for name, fn in self._recorders(scene, cam, cfg,
                                        (32, 64, 128)).items():
            self.emit("record", scene="final", recorder=name,
                      **self.time(fn))

    def grad(self):
        from first_raytracer.diff.grad import (
            render_loss_and_grads_bucketed, split_params)
        from first_raytracer.diff.replay import plan_buckets
        from first_raytracer.kernels.megakernel import BLOCK

        jnp = self.jnp
        scene, cam, cfg = self.final
        ids = jnp.arange(GRAD_RAYS, dtype=jnp.int32)
        target = jnp.zeros((GRAD_RAYS, 3), jnp.float32)
        params, _ = split_params(scene)
        recs = self._recorders(scene, cam, cfg, (BLOCK,))
        for name, rec in recs.items():
            plan = plan_buckets(rec())

            def steps(rec=rec, plan=plan):
                return [render_loss_and_grads_bucketed(
                    params, scene, cam, cfg, self.key, ids, target, rec(),
                    plan=plan) for _ in range(8)]

            self.emit("grad", recorder=name, steps=8, **self.time(steps))

    def large(self):
        from first_raytracer.kernels import megakernel as mk
        from first_raytracer.render.api import render_image
        from first_raytracer.render.routing import plain_accel
        from first_raytracer.scene.builders import (sphere_field,
                                                    triangle_field)

        jnp = self.jnp
        cases = ([("sphere-field", sphere_field, n)
                  for n in self.args.fields]
                 + [("triangle-field", triangle_field, n)
                    for n in self.args.trifields])
        for name, build, n in cases:
            scene, cam, cfg = build(n=n)
            prims = scene.num_primitives
            res = {}
            pack = mk.pack_scene_mega(scene)
            t0 = time.perf_counter()
            bvh = plain_accel(scene)
            res["bvh_build_s"] = time.perf_counter() - t0
            paths = {
                "kernel": lambda: mk.render_pixels_mega(pack, cam, cfg,
                                                        self.key),
                "wavefront_bvh": lambda: render_image(scene, cam, cfg,
                                                      accel=bvh),
                "regenerative_bvh": lambda: render_image(
                    scene, cam, cfg, accel=bvh, mode="regenerative")}
            if prims <= self.args.brute_max:
                paths["wavefront_brute"] = lambda: render_image(scene, cam,
                                                                cfg)
                paths["regenerative_brute"] = lambda: render_image(
                    scene, cam, cfg, mode="regenerative")
            for path, fn in paths.items():
                if path in self.args.large_paths:
                    res[path] = self.time(fn)
            k = float(jnp.sum(mk.render_pixels_mega(pack, cam, cfg,
                                                    self.key)[0]))
            self.emit("large", scene=name, n=n, primitives=prims,
                      spheres=scene.num_spheres,
                      triangles=scene.num_triangles, kernel_checksum=k,
                      **res)

    def record_scale(self):
        from first_raytracer.kernels.megakernel import BLOCK
        from first_raytracer.scene.builders import (sphere_field,
                                                    triangle_field)

        cases = ([("sphere-field", sphere_field, n)
                  for n in self.args.record_fields]
                 + [("triangle-field", triangle_field, n)
                    for n in self.args.record_trifields])
        for name, build, n in cases:
            scene, cam, cfg = build(n=n)
            res = {r: self.time(fn) for r, fn in self._recorders(
                scene, cam, cfg, (BLOCK,)).items()}
            self.emit("record_scale", scene=name, n=n,
                      primitives=scene.num_primitives,
                      spheres=scene.num_spheres,
                      triangles=scene.num_triangles, **res)

    def hlo(self):
        from first_raytracer.render.api import render_ray_batch
        from first_raytracer.scene.builders import sphere_field

        jnp = self.jnp
        scene, cam, cfg = sphere_field()
        R, Np = 1 << 17, scene.num_primitives
        ids = jnp.arange(R, dtype=jnp.int32)
        text = render_ray_batch.lower(scene, cam, cfg, self.key,
                                      ids).compile().as_text()
        if self.args.hlo_out:
            with open(self.args.hlo_out, "w") as f:
                f.write(text)
        self.emit("hlo", rays=R, primitives=Np,
                  **materialized(text, R, Np))

    def checksums(self):
        from first_raytracer.render.api import render_image
        from first_raytracer.render.routing import plain_accel
        import bench

        jax = self.jax
        for sel in self.args.scenes:
            scene, cam, cfg = bench.build_scene(sel)
            t0 = time.perf_counter()
            img = render_image(scene, cam, cfg, accel=plain_accel(scene),
                               mode="regenerative")
            checksum = float(jax.numpy.sum(img)) * cfg.spp
            self.emit("checksums", scene=sel, key=bench.golden_key(sel, cfg),
                      path="regenerative_bvh",
                      platform=jax.devices()[0].platform, checksum=checksum,
                      seconds=time.perf_counter() - t0)


def materialized(hlo_text, R, Np):
    """Which instructions outside fused computations produce an array with
    both an ``R`` and an ``Np`` dimension: those are written to memory.

    Returns the count of such instructions, their first lines, and the
    number of fused computations that hold (R, Np) values internally.
    """
    comps, cur = {}, None
    for line in hlo_text.splitlines():
        m = re.match(r"^(?:ENTRY )?%?([\w.\-]+) .*\{$", line)
        if m:
            cur = m.group(1)
            comps[cur] = []
        elif line.startswith("}"):
            cur = None
        elif cur is not None:
            comps[cur].append(line.strip())
    fused = set()
    for lines in comps.values():
        for ln in lines:
            if " fusion(" in ln:
                fused.update(re.findall(r"calls=%?([\w.\-]+)", ln))
    dims = re.compile(r"\[([0-9,]*)\]")
    result_type = re.compile(r"^\s*(\(.*?\)|\S+)\s+[\w\-]+\(")

    def big(ln):
        m = result_type.match(ln.split("=", 1)[1]) if "=" in ln else None
        for shape in dims.findall(m.group(1) if m else ""):
            ds = [int(x) for x in shape.split(",") if x]
            if R in ds and Np in ds:
                return True
        return False

    out = [ln[:200] for name, lines in comps.items() if name not in fused
           for ln in lines if big(ln)]
    inside = sum(1 for name in fused if any(big(ln)
                                            for ln in comps.get(name, ())))
    return {"materialized": len(out), "materialized_lines": out[:8],
            "fusions_holding_matrix": inside}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+",
                    choices=GPU_SECTIONS + ("checksums",),
                    default=list(GPU_SECTIONS))
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--blocks", type=int, nargs="+",
                    default=[32, 64, 128, 256])
    ap.add_argument("--fields", type=int, nargs="*", default=[20000, 200000])
    ap.add_argument("--trifields", type=int, nargs="*",
                    default=[20000, 40000, 80000])
    ap.add_argument("--brute-max", type=int, default=25000)
    ap.add_argument("--large-paths", nargs="+", default=[
        "kernel", "wavefront_bvh", "regenerative_bvh", "wavefront_brute",
        "regenerative_brute"])
    ap.add_argument("--record-fields", type=int, nargs="*",
                    default=[1000, 2000, 5000, 10000, 20000])
    ap.add_argument("--record-trifields", type=int, nargs="*",
                    default=[2000, 5000, 20000, 80000])
    ap.add_argument("--scenes", nargs="+",
                    default=["field20000", "field5000", "trifield20000"])
    ap.add_argument("--hlo-out", help="write the optimized HLO here")
    ap.add_argument("--out", help="append the JSON lines to this file")
    args = ap.parse_args(argv)
    if args.repeats < 3:
        ap.error("--repeats must be at least 3")

    import jax

    from first_raytracer.utils.cache import enable_persistent_cache

    enable_persistent_cache()
    if (set(args.only) & set(GPU_SECTIONS)
            and jax.devices()[0].platform != "gpu"):
        print("the timed sections need a GPU; found "
              f"{jax.devices()[0].platform!r}", file=sys.stderr)
        return 1
    runner = Runner(args)
    print(runner.card, flush=True)
    for section in args.only:
        getattr(runner, section)()
    return 0


if __name__ == "__main__":
    sys.exit(main())
