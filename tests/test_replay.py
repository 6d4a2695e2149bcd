"""Path-replay differentiable pass (diff/replay.py): the record->replay
split must be *exactly* equivalent — values and gradients — to round 2's
direct reverse-mode through the monolithic wavefront scan, for every
intersector (brute / BVH), on sphere-only, mixed, and
checker scenes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from first_raytracer.accel.build import build_bvh
from first_raytracer.core import rng
from first_raytracer.diff.grad import (ray_radiance,
                                       render_loss_and_grads,
                                       split_params)
from first_raytracer.diff.replay import record_paths
from first_raytracer.render.camera import generate_rays
from first_raytracer.scene.builders import (camera_showcase,
                                            three_spheres,
                                            triangle_scene)

CFG_KW = dict(nx=12, ny=6, spp=2)
MAX_DEPTH = 8


def _setup(builder):
    scene, cam, cfg = builder(**CFG_KW)
    cfg = dataclasses.replace(cfg, max_depth=MAX_DEPTH)
    key = rng.base_key(0)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    target = jnp.zeros((cfg.num_rays, 3), jnp.float32)
    return scene, cam, cfg, key, ids, target


@pytest.fixture(scope="module")
def sph():
    return _setup(three_spheres)


@pytest.fixture(scope="module")
def mixed():
    return _setup(triangle_scene)


@pytest.mark.parametrize("builder", [three_spheres, triangle_scene,
                                     camera_showcase])
def test_replay_radiance_matches_direct(builder):
    """Replay radiance equals the direct differentiable scan to ulps (same
    masked math, same recorded selection; the payload-matmul extraction
    shifts XLA fusion/fma-contraction boundaries by 1 ulp on a few
    percent of lanes)."""
    scene, cam, cfg, key, ids, _ = _setup(builder)
    params, _ = split_params(scene, fields=())
    rad_replay = np.asarray(ray_radiance(params, scene, cam, cfg, key, ids,
                                         method="replay"))
    rad_direct = np.asarray(ray_radiance(params, scene, cam, cfg, key, ids,
                                         method="scan"))
    np.testing.assert_allclose(rad_replay, rad_direct, rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("isect", ["brute", "bvh"])
def test_replay_grads_match_direct(sph, isect):
    """Gradients through the replay equal the direct path's, per
    intersector (selection is identical, so the differentiable recompute
    graph is identical)."""
    scene, cam, cfg, key, ids, target = sph
    accel, intersect_fn = None, None
    if isect == "bvh":
        accel = build_bvh(scene)
    params, _ = split_params(scene, fields=("albedo", "sphere_center",
                                            "fuzz", "ref_idx"))
    l_r, g_r = render_loss_and_grads(params, scene, cam, cfg, key, ids,
                                     target, accel,
                                     intersect_fn=intersect_fn,
                                     method="replay")
    l_d, g_d = render_loss_and_grads(params, scene, cam, cfg, key, ids,
                                     target, accel,
                                     intersect_fn=intersect_fn,
                                     method="scan")
    np.testing.assert_allclose(float(l_r), float(l_d), rtol=1e-6)
    for k in params:
        # Same math, different backward graph (remat recomputes + different
        # fusion order) => ulp-level associativity drift only.
        np.testing.assert_allclose(np.asarray(g_r[k]), np.asarray(g_d[k]),
                                   rtol=2e-3, atol=1e-7)


def test_replay_grads_match_direct_triangles(mixed):
    """Mixed sphere/triangle scene: triangle-vertex gradients agree too."""
    scene, cam, cfg, key, ids, target = mixed
    params, _ = split_params(scene, fields=("tri_v0", "tri_v1", "tri_v2",
                                            "albedo"))
    _, g_r = render_loss_and_grads(params, scene, cam, cfg, key, ids,
                                   target, method="replay")
    _, g_d = render_loss_and_grads(params, scene, cam, cfg, key, ids,
                                   target, method="scan")
    for k in params:
        np.testing.assert_allclose(np.asarray(g_r[k]), np.asarray(g_d[k]),
                                   rtol=2e-3, atol=1e-7)
        assert np.any(np.asarray(g_r[k]) != 0.0), k


def test_tape_semantics(sph):
    """Tape entries are -1 or valid global ids; once a ray records -1 it
    never records a primitive again (death is final)."""
    scene, cam, cfg, key, ids, _ = sph
    cam_u = rng.camera_uniforms(key, ids)
    o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids, cam_u)
    tape = np.asarray(record_paths(scene, o, d, ids, key, cfg))
    assert tape.shape == (cfg.max_depth + 1, cfg.num_rays)
    assert tape.min() >= -1
    assert tape.max() < scene.num_primitives
    dead = np.zeros(tape.shape[1], bool)
    for dth in range(tape.shape[0]):
        row_dead = tape[dth] < 0
        assert not np.any(dead & ~row_dead), f"resurrection at depth {dth}"
        dead |= row_dead
    # The camera bounce must hit something in this scene.
    assert (tape[0] >= 0).mean() > 0.5


@pytest.mark.parametrize("pool", [32, 64, 256])
def test_pool_record_matches_lockstep(sph, pool):
    """The compacted-pool recorder produces the exact tape of the lockstep
    recorder for pools smaller than, comparable to, and larger than the
    live ray population (identical per-ray math, just scheduled densely)."""
    from first_raytracer.diff.replay import record_paths_pool

    scene, cam, cfg, key, ids, _ = sph
    cam_u = rng.camera_uniforms(key, ids)
    o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids, cam_u)
    tape_lock = np.asarray(record_paths(scene, o, d, ids, key, cfg))
    tape_pool = np.asarray(record_paths_pool(scene, cam, cfg, key, ids,
                                             pool_size=pool))
    np.testing.assert_array_equal(tape_pool, tape_lock)


def test_live_trips_trim_is_exact(sph):
    """Trimming the tape to live_trips rows changes nothing — loss and
    grads equal the full-tape replay."""
    from first_raytracer.diff.grad import render_loss_and_grads_tape
    from first_raytracer.diff.replay import live_trips

    scene, cam, cfg, key, ids, target = sph
    cam_u = rng.camera_uniforms(key, ids)
    o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids, cam_u)
    tape = record_paths(scene, o, d, ids, key, cfg)
    trips = live_trips(tape)
    assert 1 <= trips <= cfg.max_depth + 1
    params, _ = split_params(scene, fields=("albedo", "sphere_center"))
    l_full, g_full = render_loss_and_grads_tape(
        params, scene, cam, cfg, key, ids, target, tape)
    l_trim, g_trim = render_loss_and_grads_tape(
        params, scene, cam, cfg, key, ids, target, tape[:trips])
    assert float(l_full) == float(l_trim)
    for k in params:
        np.testing.assert_array_equal(np.asarray(g_full[k]),
                                      np.asarray(g_trim[k]))


def test_replay_pool_end_to_end_grads(sph):
    """record_pool inside the jitted loss path (render_loss_and_grads
    record_pool=...) matches the lockstep-record result exactly."""
    scene, cam, cfg, key, ids, target = sph
    params, _ = split_params(scene, fields=("albedo", "sphere_radius"))
    l0, g0 = render_loss_and_grads(params, scene, cam, cfg, key, ids,
                                   target, method="replay")
    l1, g1 = render_loss_and_grads(params, scene, cam, cfg, key, ids,
                                   target, method="replay", record_pool=64)
    assert float(l0) == float(l1)
    for k in params:
        np.testing.assert_array_equal(np.asarray(g0[k]), np.asarray(g1[k]))


def test_replay_value_and_grad_jits_and_is_finite(sph):
    """The jitted end-to-end fast path (the bench-mode entry) runs and
    yields finite loss/grads for the full DIFF_FIELDS set."""
    scene, cam, cfg, key, ids, target = sph
    params, _ = split_params(scene)
    loss, grads = render_loss_and_grads(params, scene, cam, cfg, key, ids,
                                        target, method="replay")
    assert np.isfinite(float(loss))
    for k, g in grads.items():
        assert np.all(np.isfinite(np.asarray(g))), k
