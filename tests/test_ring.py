"""Ring-sharded scene mode (parallel/ring.py) on the 8-device CPU mesh.

The scale-out extension beyond parity (SURVEY.md §2.2 TP row / §5.7): scene
geometry partitioned across devices, shards passed around a ``ppermute``
ring each bounce.  The contract: for the same seed, the ring render must match the
replicated single-device render — no device ever held the whole scene, yet
every closest hit (including tie-breaks) resolves to the same primitive.
Radiance is compared at 1-ulp-per-bounce tolerance: the ring program is
structurally different XLA code, so fused-multiply-add choices in the
surrounding bounce math can differ by reassociation noise (the *selection*
fold itself is exact — see parallel/ring.py docstring).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from first_raytracer.parallel.mesh import make_render_mesh
from first_raytracer.parallel.ring import pad_scene_ring, render_image_ring
from first_raytracer.render.api import render_image
from first_raytracer.scene.builders import PRESETS


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return make_render_mesh(8, 1)


def _small(preset, **kw):
    scene, cam, cfg = PRESETS[preset](**kw)
    return scene, cam, cfg


def test_pad_scene_sentinels_never_hit():
    scene, cam, cfg = _small("three-spheres", nx=40, ny=20, spp=2)
    padded = pad_scene_ring(scene, 8)
    assert padded.num_spheres % 8 == 0
    ref = render_image(scene, cam, cfg, seed=0)
    pad = render_image(padded, cam, cfg, seed=0)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(pad))


def test_ring_equals_replicated_three_spheres(mesh8):
    scene, cam, cfg = _small("three-spheres", nx=40, ny=20, spp=2)
    ref = np.asarray(render_image(scene, cam, cfg, seed=0))
    out = np.asarray(render_image_ring(scene, cam, cfg, mesh8, seed=0))
    _assert_ulp_close(ref, out)


def _assert_ulp_close(ref, out):
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    assert np.abs(out - ref).mean() < 1e-7


def test_ring_equals_replicated_mixed_primitives(mesh8):
    # triangle-mesh preset: spheres + triangles, exercises the global-id
    # tie-break mapping across both primitive kinds.
    scene, cam, cfg = _small("triangle-mesh", nx=40, ny=24, spp=2)
    ref = np.asarray(render_image(scene, cam, cfg, seed=0))
    out = np.asarray(render_image_ring(scene, cam, cfg, mesh8, seed=0))
    _assert_ulp_close(ref, out)


def test_ring_handles_duplicate_primitives_tiebreak(mesh8):
    # Two identical spheres in different shards: the winner must be the
    # lower global id on every device, matching the replicated argmin.
    scene, cam, cfg = _small("three-spheres", nx=40, ny=20, spp=1)
    dup = dataclasses.replace(
        scene,
        sphere_center=jnp.concatenate([scene.sphere_center,
                                       scene.sphere_center]),
        sphere_radius=jnp.concatenate([scene.sphere_radius,
                                       scene.sphere_radius]),
        sphere_mat=jnp.concatenate([scene.sphere_mat, scene.sphere_mat]),
    )
    ref = np.asarray(render_image(dup, cam, cfg, seed=0))
    out = np.asarray(render_image_ring(dup, cam, cfg, mesh8, seed=0))
    _assert_ulp_close(ref, out)


def test_ring_on_2d_mesh():
    # Ring over the tiles axis of a (4, 2) mesh: geometry sharded 4 ways,
    # replicated across the spp axis; output must still match.
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    from first_raytracer.parallel.mesh import make_render_mesh as mk
    mesh42 = mk(4, 2)
    scene, cam, cfg = _small("three-spheres", nx=40, ny=20, spp=2)
    ref = np.asarray(render_image(scene, cam, cfg, seed=0))
    out = np.asarray(render_image_ring(scene, cam, cfg, mesh42, seed=0))
    _assert_ulp_close(ref, out)
