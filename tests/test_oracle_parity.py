"""Golden parity: wavefront device-path radiance vs the recursive CPU oracle
(SURVEY.md §4.1/§4.3; the driver's 'pixel allclose vs reference' gate,
BASELINE.json:2).

Both consume identical counter-RNG uniforms, so agreement is per-RAY (far
stronger than per-pixel): tight absolute tolerance with no averaging.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from first_raytracer.core import rng
from first_raytracer.oracle.cpu_oracle import render_oracle
from first_raytracer.render.api import render_image, render_ray_batch
from first_raytracer.scene.builders import (camera_showcase, random_scene,
                                            three_spheres, triangle_scene)

# Small configs: full 50-depth semantics, tiny ray counts for CI speed.
CASES = [
    ("three-spheres", lambda: three_spheres(nx=24, ny=12, spp=2)),
    ("camera-effects", lambda: camera_showcase(nx=24, ny=12, spp=2)),
    ("triangle-mesh", lambda: triangle_scene(nx=24, ny=12, spp=2)),
    ("random-spheres", lambda: random_scene(nx=16, ny=8, spp=1)),
]


def _compare(scene, cam, cfg, seed=0, atol=2e-4, frac_tol=0.0):
    key = rng.base_key(seed)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    wf = np.asarray(render_ray_batch(scene, cam, cfg, key, ids))
    orc = render_oracle(scene, cam, cfg, seed=seed,
                        ray_ids=np.arange(cfg.num_rays))
    diff = np.abs(wf - orc).max(axis=1)
    frac_bad = float((diff > atol).mean())
    assert frac_bad <= frac_tol, (
        f"{frac_bad:.4%} rays differ by >{atol}; max={diff.max():.3e}")
    return diff


@pytest.mark.parametrize("name,build", CASES, ids=[c[0] for c in CASES])
def test_wavefront_matches_oracle(name, build):
    scene, cam, cfg = build()
    # Scenes with many near-tie primitive pairs (the ~500-sphere grid) or
    # shared triangle edges (the tetrahedra + floor quad) have knife-edge
    # rays where last-ulp NumPy-vs-XLA drift flips an intersection and the
    # whole path diverges; allow a whisker of those, none elsewhere.
    frac_tol = {"random-spheres": 0.01, "triangle-mesh": 0.005}.get(name, 0.0)
    _compare(scene, cam, cfg, atol=5e-4, frac_tol=frac_tol)


def test_full_image_pipeline_matches_oracle(tiny_three_spheres):
    scene, cam, cfg = tiny_three_spheres
    img = np.asarray(render_image(scene, cam, cfg, seed=0))
    orc = render_oracle(scene, cam, cfg, seed=0)
    np.testing.assert_allclose(img, orc, atol=5e-4)


def test_seed_changes_image(tiny_three_spheres):
    scene, cam, cfg = tiny_three_spheres
    a = np.asarray(render_image(scene, cam, cfg, seed=0))
    b = np.asarray(render_image(scene, cam, cfg, seed=1))
    assert not np.allclose(a, b)
    # But the estimator is unbiased: images agree loosely.
    assert np.abs(a - b).mean() < 0.2


def test_chunked_render_matches_unchunked(tiny_three_spheres):
    scene, cam, cfg = tiny_three_spheres
    a = np.asarray(render_image(scene, cam, cfg, seed=0))
    b = np.asarray(render_image(scene, cam, cfg, seed=0, chunk=77))
    # Same math at a different static batch size: XLA vectorization may
    # reassociate, so allow small accumulated drift only.
    np.testing.assert_allclose(a, b, atol=5e-5)
