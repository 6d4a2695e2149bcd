"""Golden-image regression tests (SURVEY.md §4.3): the wavefront render must
reproduce the committed oracle radiance for every forward preset without
re-running the oracle.  Guards against silent semantics drift in either
path.  Regenerate with tools/gen_goldens.py after intentional changes."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from first_raytracer.core import rng
from first_raytracer.render.api import render_ray_batch
from first_raytracer.scene.builders import (camera_showcase, random_scene,
                                            three_spheres, triangle_scene)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")

CASES = {
    "three-spheres": (lambda: three_spheres(nx=24, ny=12, spp=2), 0.0),
    "camera-effects": (lambda: camera_showcase(nx=24, ny=12, spp=2), 0.0),
    "triangle-mesh": (lambda: triangle_scene(nx=24, ny=12, spp=2), 0.005),
    "random-spheres": (lambda: random_scene(nx=16, ny=8, spp=1), 0.01),
}


@pytest.mark.parametrize("name", list(CASES))
def test_golden(name):
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    if not os.path.exists(path):
        pytest.skip("goldens not generated (tools/gen_goldens.py)")
    z = np.load(path)
    build, frac_tol = CASES[name]
    scene, cam, cfg = build()
    assert (cfg.nx, cfg.ny, cfg.spp) == (int(z["nx"]), int(z["ny"]),
                                         int(z["spp"]))
    key = rng.base_key(int(z["seed"]))
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    got = np.asarray(render_ray_batch(scene, cam, cfg, key, ids))
    diff = np.abs(got - z["radiance"]).max(axis=1)
    frac_bad = float((diff > 5e-4).mean())
    assert frac_bad <= frac_tol, (frac_bad, float(diff.max()))
