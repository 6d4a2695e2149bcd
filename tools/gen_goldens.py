#!/usr/bin/env python
"""Generate golden per-ray radiance arrays from the CPU oracle
(SURVEY.md §4.3) for all four forward presets, at CI-sized configs.

Run after any *intentional* semantics change:
    python tools/gen_goldens.py
Commits into tests/goldens/*.npz; tests/test_goldens.py compares the
device-path render against these without re-running the oracle.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np

from first_raytracer.oracle.cpu_oracle import render_oracle
from first_raytracer.scene.builders import (camera_showcase, random_scene,
                                            three_spheres, triangle_scene)

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "goldens")

CASES = {
    "three-spheres": lambda: three_spheres(nx=24, ny=12, spp=2),
    "camera-effects": lambda: camera_showcase(nx=24, ny=12, spp=2),
    "triangle-mesh": lambda: triangle_scene(nx=24, ny=12, spp=2),
    "random-spheres": lambda: random_scene(nx=16, ny=8, spp=1),
}


def main():
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, build in CASES.items():
        scene, cam, cfg = build()
        rad = render_oracle(scene, cam, cfg, seed=0,
                            ray_ids=np.arange(cfg.num_rays))
        path = os.path.join(GOLDEN_DIR, f"{name}.npz")
        np.savez_compressed(path, radiance=rad, nx=cfg.nx, ny=cfg.ny,
                            spp=cfg.spp, max_depth=cfg.max_depth, seed=0)
        print(f"{path}: {rad.shape} mean={rad.mean():.4f}")


if __name__ == "__main__":
    main()
