#!/usr/bin/env python
"""Full-size acceptance run (SURVEY.md §4.3): the four canonical driver
configs [BASELINE.json:7-10] rendered at full scale on a GPU.

For each preset:
- render the FULL config on the path-tracing kernel (timed);
- render the same config on the wavefront path (the oracle-adjacent
  XLA implementation) and compare images;
- spot-check a random ray subsample against the recursive NumPy oracle
  (the stand-in for the missing reference; SURVEY.md §0).

Prints one JSON line per preset and exits nonzero on any gate failure.
Usage: python tools/acceptance.py [--skip-oracle]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import numpy as np

from first_raytracer.utils.cache import enable_persistent_cache

from first_raytracer.core import rng
from first_raytracer.kernels.megakernel import render_image_mega
from first_raytracer.oracle import native_oracle
from first_raytracer.oracle.cpu_oracle import render_oracle
from first_raytracer.render.api import render_image, render_ray_batch
from first_raytracer.scene.builders import PRESETS


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the per-preset rows to this JSON file")
    ap.add_argument("--skip-oracle", action="store_true")
    ap.add_argument("--oracle-rays", type=int, default=2048,
                    help="per-preset ray subsample checked against the "
                         "oracle; the C++ oracle (~100x NumPy) makes "
                         "thousands cheap, and falls back to 64 NumPy "
                         "rays if the .so is not built")
    args = ap.parse_args(argv)
    enable_persistent_cache()
    dev = jax.devices()[0]

    failures = 0
    rows = []

    def write_out():
        # Written after EVERY preset (not just at the end) so a mid-run
        # failure still ships the rows already gathered.
        if args.out:
            with open(args.out, "w") as f:
                json.dump({"platform": dev.platform,
                           "device_kind": dev.device_kind,
                           "device_count": len(jax.devices()),
                           "failures": failures,
                           "complete": len(rows) == 4, "rows": rows}, f,
                          indent=1)
    # The four canonical driver configs [BASELINE.json:7-10].
    canonical = ("three-spheres", "random-spheres", "triangle-mesh",
                 "camera-effects")
    for name in canonical:
        preset = PRESETS[name]
        scene, cam, cfg = preset()  # FULL canonical size
        jax.block_until_ready(render_image_mega(scene, cam, cfg))  # compile
        # Device render and host readback are timed apart: the frame is
        # device work, the image transfer is not.
        t0 = time.perf_counter()
        img_dev = jax.block_until_ready(render_image_mega(scene, cam, cfg))
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        img_mega = np.asarray(img_dev)
        t_read = time.perf_counter() - t0
        t_mega = t_dev + t_read
        img_wave = np.asarray(render_image(scene, cam, cfg))
        d = np.abs(img_mega - img_wave)
        # The kernel's rounding differences (FMA contraction, cbrt) flip
        # a rare near-silhouette *sample*; a flipped sample moves its
        # pixel by O(1/spp), so the affected-pixel gate scales with spp
        # while the bulk (median/mean) must stay at float-noise level.
        frac_bad = float((d > 1e-3).mean())
        row = {
            "preset": name,
            "config": f"{cfg.nx}x{cfg.ny}@{cfg.spp}spp d{cfg.max_depth}",
            "mega_device_seconds": t_dev,
            "mega_readback_seconds": t_read,
            "mega_seconds_e2e": t_mega,
            "mega_mpaths_s_device": cfg.num_rays / t_dev / 1e6,
            "mega_mpaths_s_e2e": cfg.num_rays / t_mega / 1e6,
            "mega_vs_wavefront_frac_gt_1e3": frac_bad,
            "mega_vs_wavefront_mean": float(d.mean()),
            "mega_vs_wavefront_median": float(np.median(d)),
        }
        ok = (frac_bad < max(0.01, 0.3 / cfg.spp)
              and float(np.median(d)) < 1e-6 and float(d.mean()) < 2e-3)
        if not args.skip_oracle:
            n_rays = args.oracle_rays
            use_native = native_oracle.available()
            if not use_native:
                n_rays = min(n_rays, 64)  # NumPy oracle is ~100x slower
            r = np.random.RandomState(1)
            ids = np.sort(r.choice(cfg.num_rays, size=n_rays,
                                   replace=False)).astype(np.int64)
            if use_native:
                o_ref = native_oracle.render_oracle_native(
                    scene, cam, cfg, ray_ids=ids)
            else:
                o_ref = render_oracle(scene, cam, cfg, ray_ids=ids)
            o_dev = np.asarray(render_ray_batch(
                scene, cam, cfg, rng.base_key(0),
                jnp.asarray(ids, jnp.int32)))
            od = np.abs(o_ref - o_dev).max(axis=1)
            row["oracle_rays"] = n_rays
            row["oracle_native"] = use_native
            row["oracle_rays_matching_1e4"] = float((od < 1e-4).mean())
            ok = ok and row["oracle_rays_matching_1e4"] > 0.95
        row["pass"] = bool(ok)
        failures += 0 if ok else 1
        rows.append(row)
        print(json.dumps(row), flush=True)
        write_out()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
