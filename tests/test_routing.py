"""The choice of tracer (render/routing.py) and the fit step that uses it."""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest

from first_raytracer.render import routing
from first_raytracer.scene.builders import (random_scene, sphere_field,
                                            three_spheres,
                                            triangle_field)


def test_sweep_cost_weights_triangles():
    scene = triangle_field(n=100)[0]
    assert routing.sweep_cost(scene) == (
        scene.num_spheres + routing.TRIANGLE_WEIGHT * scene.num_triangles)


@pytest.mark.parametrize("preset", [three_spheres, random_scene,
                                    sphere_field, triangle_field])
def test_shipped_presets_route_to_kernel(preset):
    """Every preset the repo ships routes as measured: to the kernel, but
    triangle-field's 20,000 triangles are past the triangle crossover."""
    assert routing.use_kernel(preset()[0]) is (preset is not triangle_field)


@pytest.mark.parametrize("n_spheres,n_tris,want", [
    (routing.KERNEL_MAX_COST, 0, True),
    (routing.KERNEL_MAX_COST + 1, 0, False),
    (4, (routing.KERNEL_MAX_COST - 4) // routing.TRIANGLE_WEIGHT, True),
    (4, (routing.KERNEL_MAX_COST - 4) // routing.TRIANGLE_WEIGHT + 1,
     False),
])
def test_kernel_bound_is_inclusive_and_weighted(n_spheres, n_tris, want):
    scene = types.SimpleNamespace(num_spheres=n_spheres,
                                  num_triangles=n_tris)
    assert routing.use_kernel(scene) is want


def test_scenes_past_the_bound_take_the_bvh(monkeypatch):
    scene = random_scene()[0]
    monkeypatch.setattr(routing, "KERNEL_MAX_COST", scene.num_spheres - 1)
    assert not routing.use_kernel(scene)
    bvh = routing.plain_accel(scene)
    assert bvh.prim_ids.shape[0] == scene.num_spheres


@pytest.mark.parametrize("ids_kind", ["contiguous", "strided"])
def test_fit_step_replay_recorders_agree(ids_kind):
    """The fit step records with the kernel for contiguous ids and with
    the XLA pool recorder otherwise; both give the same first step."""
    import optax

    from first_raytracer.core import rng
    from first_raytracer.diff.grad import (make_fit_step_replay,
                                           ray_radiance, split_params)

    scene, cam, cfg = three_spheres(nx=16, ny=8, spp=2)
    key = rng.base_key(0)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    if ids_kind == "strided":
        ids = ids[::2]
    params_true, _ = split_params(scene, fields=("albedo",))
    target = ray_radiance(params_true, scene, cam, cfg, key, ids)
    bad = dataclasses.replace(scene, albedo=scene.albedo * 0.6)
    params, _ = split_params(bad, fields=("albedo",))
    opt = optax.adam(0.05)
    step = make_fit_step_replay(bad, cam, cfg, ids, target, opt,
                                interpret=True)
    loss, _, _ = step(params, opt.init(params), key)
    ref = float(np.mean((np.asarray(ray_radiance(
        params, bad, cam, cfg, key, ids)) - np.asarray(target)) ** 2))
    np.testing.assert_allclose(float(loss), ref, rtol=1e-5)


@pytest.mark.parametrize("ids,want", [
    (np.arange(8), True),
    (np.arange(100, 164), True),
    (np.arange(1), True),
    (np.arange(0), True),
    (np.arange(0, 16, 2), False),
    (np.arange(8)[::-1], False),
    (np.array([0, 1, 2, 4]), False),
])
def test_recorder_follows_id_contiguity(ids, want):
    """The kernel records one contiguous id range."""
    assert routing.kernel_records(three_spheres()[0], ids) is want


@pytest.mark.parametrize("n_spheres,n_tris,want", [
    (routing.RECORD_MAX_SPHERES, 0, True),
    (routing.RECORD_MAX_SPHERES + 1, 0, False),
    (3, 80_000, True),
])
def test_recorder_bound_counts_spheres(n_spheres, n_tris, want):
    """Past the measured sphere count the pool recorder records; the
    kernel won on every triangle field measured."""
    scene = types.SimpleNamespace(num_spheres=n_spheres,
                                  num_triangles=n_tris)
    assert routing.kernel_records(scene, np.arange(16)) is want
