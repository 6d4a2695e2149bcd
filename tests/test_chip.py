"""Tests of the compiled kernel on the GPU (``chip`` marker).

They skip where the default device is not a GPU (decided in the ``gpu``
fixture at run time) and run on the card with
``FRT_TESTS_ON_CHIP=1 python -m pytest -m chip tests/`` or as a phase of
chip_smoke.py.  Interpret-mode twins of these checks run everywhere
(tests/test_megakernel.py, tests/test_record_mega.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from first_raytracer.core import rng
from first_raytracer.kernels.megakernel import (pack_scene_mega,
                                                record_paths_mega,
                                                render_image_mega)
from first_raytracer.render.api import render_image
from first_raytracer.scene.builders import (camera_showcase,
                                            three_spheres,
                                            triangle_scene)


@pytest.mark.chip
@pytest.mark.parametrize("preset", [three_spheres, triangle_scene,
                                    camera_showcase])
def test_compiled_kernel_matches_wavefront(gpu, preset):
    scene, cam, cfg = preset(nx=64, ny=32, spp=4)
    ref = np.asarray(render_image(scene, cam, cfg))
    img = np.asarray(render_image_mega(scene, cam, cfg))
    diff = np.abs(ref - img)
    assert (diff > 1e-3).mean() < 0.01, diff.max()


@pytest.mark.chip
def test_compiled_recorder_matches_pool(gpu):
    from first_raytracer.diff.replay import record_paths_pool

    scene, cam, cfg = triangle_scene(nx=64, ny=32, spp=2)
    key = rng.base_key(0)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    want = np.asarray(record_paths_pool(scene, cam, cfg, key, ids,
                                        pool_size=1024))
    got = np.asarray(record_paths_mega(pack_scene_mega(scene), cam, cfg,
                                       key))
    assert (got == want).mean() > 0.99
