"""Regenerative (compacted-pool) integrator == plain wavefront integrator.

Every ray's math is identical (counter RNG travels with the ray), so the
images must match to float associativity, across pool sizes smaller than,
equal to, and larger than the ray count — including pools small enough to
force many regeneration waves."""
import numpy as np
import pytest

from first_raytracer.render.api import render_image
from first_raytracer.scene.builders import three_spheres


@pytest.fixture(scope="module")
def setup():
    scene, cam, cfg = three_spheres(nx=16, ny=8, spp=2)
    ref = np.asarray(render_image(scene, cam, cfg, seed=0))
    return scene, cam, cfg, ref


@pytest.mark.parametrize("pool", [64, 256, 1024])
def test_regenerative_matches_wavefront(setup, pool):
    scene, cam, cfg, ref = setup
    img = np.asarray(render_image(scene, cam, cfg, seed=0,
                                  mode="regenerative", pool_size=pool))
    np.testing.assert_allclose(img, ref, atol=2e-6)


def test_regenerative_with_bvh(setup):
    from first_raytracer.accel.build import build_bvh
    scene, cam, cfg, ref = setup
    bvh = build_bvh(scene)
    img = np.asarray(render_image(scene, cam, cfg, seed=0, accel=bvh,
                                  mode="regenerative", pool_size=128))
    np.testing.assert_allclose(img, ref, atol=2e-6)
