"""Sharded-render tests on the 8-virtual-device CPU mesh (SURVEY.md §4.5):
mesh-layout invariance, spp-psum combine, auto vs explicit SPMD, and the
gradient all-reduce falling out of autodiff."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from first_raytracer.core import rng
from first_raytracer.diff.grad import render_loss, split_params
from first_raytracer.parallel.mesh import make_render_mesh
from first_raytracer.parallel.shard import (render_image_auto,
                                            render_image_sharded)
from first_raytracer.render.api import render_image
from first_raytracer.scene.builders import three_spheres


@pytest.fixture(scope="module")
def setup():
    scene, cam, cfg = three_spheres(nx=16, ny=8, spp=4)
    ref = np.asarray(render_image(scene, cam, cfg, seed=0))
    return scene, cam, cfg, ref


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("tiles,spp", [(8, 1), (4, 2), (2, 4), (1, 1)])
def test_shard_map_layout_invariance(setup, tiles, spp):
    scene, cam, cfg, ref = setup
    mesh = make_render_mesh(tiles, spp, devices=jax.devices()[:tiles * spp])
    img = np.asarray(render_image_sharded(scene, cam, cfg, mesh, seed=0))
    # Counter RNG => every mesh layout reproduces the single-device image
    # (only reduction-order ulp drift allowed).
    np.testing.assert_allclose(img, ref, atol=2e-6)


def test_auto_sharding_matches(setup):
    scene, cam, cfg, ref = setup
    mesh = make_render_mesh(4, 2)
    img = np.asarray(render_image_auto(scene, cam, cfg, mesh, seed=0))
    np.testing.assert_allclose(img, ref, atol=2e-6)


def test_indivisible_shapes_rejected(setup):
    scene, cam, cfg, _ = setup
    mesh = make_render_mesh(8, 1)
    import dataclasses
    bad = dataclasses.replace(cfg, nx=17)  # 17*8 pixels % 8 != 0... pick odd
    bad = dataclasses.replace(cfg, nx=3, ny=3)
    with pytest.raises(ValueError):
        render_image_sharded(scene, cam, bad, mesh, seed=0)
    bad_spp = dataclasses.replace(cfg, spp=3)
    mesh2 = make_render_mesh(4, 2)
    with pytest.raises(ValueError):
        render_image_sharded(scene, cam, bad_spp, mesh2, seed=0)


def test_sharded_grads_match_single_device(setup):
    """Gradient psum: grads of a replicated-param sharded loss equal the
    single-device grads (the 'all-reduced' semantics of BASELINE.json:5)."""
    scene, cam, cfg, _ = setup
    import dataclasses
    cfg_small = dataclasses.replace(cfg, spp=2)
    params, _ = split_params(scene, fields=("albedo", "fuzz"))
    key = rng.base_key(0)
    ids = jnp.arange(cfg_small.num_rays, dtype=jnp.int32)
    target = jnp.zeros((cfg_small.num_rays, 3), jnp.float32)

    g_single = jax.grad(render_loss)(
        params, scene, cam, cfg_small, key, ids, target)

    mesh = make_render_mesh(8, 1)
    from jax.sharding import NamedSharding, PartitionSpec as P
    ids_sh = jax.device_put(ids, NamedSharding(mesh, P("tiles")))
    target_sh = jax.device_put(target, NamedSharding(mesh, P("tiles")))
    g_sharded = jax.grad(render_loss)(
        params, scene, cam, cfg_small, key, ids_sh, target_sh)

    for k in params:
        np.testing.assert_allclose(np.asarray(g_single[k]),
                                   np.asarray(g_sharded[k]),
                                   rtol=1e-4, atol=1e-7)
