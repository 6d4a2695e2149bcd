"""Counter-based RNG tests (SURVEY.md §4.1/§4.2): determinism, decorrelation,
precompute/lazy agreement, and sampler distributions."""
import jax.numpy as jnp
import numpy as np

from first_raytracer.core import rng


def test_deterministic_and_order_independent():
    key = rng.base_key(0)
    ids = jnp.array([5, 9, 5], dtype=jnp.int32)
    u = np.asarray(rng.camera_uniforms(key, ids))
    assert np.array_equal(u[0], u[2])          # same ray id -> same draws
    assert not np.array_equal(u[0], u[1])      # different id -> different
    # Buffer order / slicing does not matter (compaction invariance).
    u_single = np.asarray(rng.camera_uniforms(key, jnp.array([9], jnp.int32)))
    np.testing.assert_array_equal(u[1], u_single[0])


def test_domains_decorrelated():
    key = rng.base_key(0)
    ids = jnp.arange(16, dtype=jnp.int32)
    cam = np.asarray(rng.camera_uniforms(key, ids))
    b0 = np.asarray(rng.bounce_uniforms(key, ids, 0))
    b1 = np.asarray(rng.bounce_uniforms(key, ids, 1))
    assert not np.allclose(cam, b0)
    assert not np.allclose(b0, b1)


def test_precompute_matches_lazy():
    key = rng.base_key(3)
    ids = jnp.array([0, 7, 123], dtype=jnp.int32)
    pre = np.asarray(rng.precompute_uniforms(key, ids, max_depth=4))
    np.testing.assert_array_equal(
        pre[:, 0], np.asarray(rng.camera_uniforms(key, ids)))
    for d in range(5):
        np.testing.assert_array_equal(
            pre[:, 1 + d], np.asarray(rng.bounce_uniforms(key, ids, d)))


def test_uniform_range_and_mean():
    key = rng.base_key(1)
    ids = jnp.arange(4096, dtype=jnp.int32)
    u = np.asarray(rng.camera_uniforms(key, ids))
    assert u.min() >= 0.0 and u.max() < 1.0
    np.testing.assert_allclose(u.mean(), 0.5, atol=0.01)


def test_unit_ball_sample_distribution():
    key = rng.base_key(2)
    ids = jnp.arange(8192, dtype=jnp.int32)
    u = np.asarray(rng.bounce_uniforms(key, ids, 0))
    pts = np.asarray(rng.unit_ball_sample(
        jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1]), jnp.asarray(u[:, 2])))
    r = np.linalg.norm(pts, axis=1)
    assert r.max() <= 1.0 + 1e-6
    # Uniform ball: E[r] = 3/4, E[xyz] = 0.
    np.testing.assert_allclose(r.mean(), 0.75, atol=0.01)
    np.testing.assert_allclose(pts.mean(axis=0), 0.0, atol=0.02)


def test_unit_disk_sample_distribution():
    key = rng.base_key(2)
    ids = jnp.arange(8192, dtype=jnp.int32)
    u = np.asarray(rng.camera_uniforms(key, ids))
    pts = np.asarray(rng.unit_disk_sample(
        jnp.asarray(u[:, 2]), jnp.asarray(u[:, 3])))
    r = np.linalg.norm(pts, axis=1)
    assert r.max() <= 1.0 + 1e-6
    # Uniform disk: E[r] = 2/3.
    np.testing.assert_allclose(r.mean(), 2.0 / 3.0, atol=0.01)
