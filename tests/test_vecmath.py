"""Unit tests for core vector math (SURVEY.md §4.2 'vec math')."""
import jax.numpy as jnp
import numpy as np

from first_raytracer.core.vecmath import (cross, dot, length, normalize,
                                          point_at, reflect, refract,
                                          schlick, squared_length)


def test_dot_cross_length():
    a = jnp.array([[1.0, 2.0, 3.0], [0.0, 1.0, 0.0]])
    b = jnp.array([[4.0, -5.0, 6.0], [1.0, 0.0, 0.0]])
    np.testing.assert_allclose(dot(a, b), [12.0, 0.0])
    np.testing.assert_allclose(cross(a, b)[1], [0.0, 0.0, -1.0])
    np.testing.assert_allclose(squared_length(a), [14.0, 1.0])
    np.testing.assert_allclose(length(a), [np.sqrt(14.0), 1.0], rtol=1e-6)


def test_normalize_unit_and_zero():
    v = jnp.array([[3.0, 0.0, 4.0], [0.0, 0.0, 0.0]])
    n = normalize(v, eps=1e-20)
    np.testing.assert_allclose(n[0], [0.6, 0.0, 0.8], rtol=1e-6)
    assert np.all(np.isfinite(np.asarray(n)))


def test_point_at():
    o = jnp.array([[1.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 1.0, 0.0]])
    np.testing.assert_allclose(
        point_at(o, d, jnp.array([2.5]))[0], [1.0, 2.5, 0.0])


def test_reflect_mirror():
    v = jnp.array([[1.0, -1.0, 0.0]])
    n = jnp.array([[0.0, 1.0, 0.0]])
    np.testing.assert_allclose(reflect(v, n)[0], [1.0, 1.0, 0.0], atol=1e-7)


def test_refract_snell_and_tir():
    # Normal incidence: direction unchanged.
    v = jnp.array([[0.0, -1.0, 0.0]])
    n = jnp.array([[0.0, 1.0, 0.0]])
    r, ok = refract(v, n, jnp.array([1.0 / 1.5]))
    assert bool(ok[0])
    np.testing.assert_allclose(r[0], [0.0, -1.0, 0.0], atol=1e-6)
    # Grazing exit from dense medium: total internal reflection.
    v = jnp.array([[1.0, -0.05, 0.0]])
    r, ok = refract(normalize(v), n, jnp.array([1.5]))
    assert not bool(ok[0])
    # Snell's law at 45 degrees entering glass.
    s = np.sqrt(0.5)
    v = jnp.array([[s, -s, 0.0]])
    r, ok = refract(v, n, jnp.array([1.0 / 1.5]))
    sin_out = float(r[0, 0])  # horizontal component = sin(theta_t)
    np.testing.assert_allclose(sin_out, s / 1.5, rtol=1e-5)


def test_schlick_limits():
    # cos=1 -> r0; cos=0 -> 1.
    r0 = ((1 - 1.5) / (1 + 1.5)) ** 2
    np.testing.assert_allclose(
        schlick(jnp.array(1.0), jnp.array(1.5)), r0, rtol=1e-6)
    np.testing.assert_allclose(
        schlick(jnp.array(0.0), jnp.array(1.5)), 1.0, rtol=1e-6)
