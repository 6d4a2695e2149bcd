"""Geometry unit tests (SURVEY.md §4.2): sphere and triangle intersection
edge cases, hit_all/hit_one consistency, AABB slab test."""
import jax.numpy as jnp
import numpy as np

from first_raytracer.geometry.aabb import (aabb_hit, sphere_aabb_np,
                                           triangle_aabb_np)
from first_raytracer.geometry.sphere import (BIG, sphere_hit_all,
                                             sphere_hit_one,
                                             sphere_normal)
from first_raytracer.geometry.triangle import (triangle_hit_all,
                                               triangle_hit_one,
                                               triangle_normal)

T_MIN, T_MAX = 1e-3, 1e30


def _one_sphere(center, radius):
    return jnp.array([center], jnp.float32), jnp.array([radius], jnp.float32)


def _hit_sphere(o, d, center, radius):
    c, r = _one_sphere(center, radius)
    t = sphere_hit_all(jnp.array([o], jnp.float32),
                       jnp.array([d], jnp.float32), c, r, T_MIN, T_MAX)
    return float(t[0, 0])


def test_sphere_head_on():
    t = _hit_sphere([0, 0, 0], [0, 0, -1], [0, 0, -3], 1.0)
    np.testing.assert_allclose(t, 2.0, rtol=1e-6)


def test_sphere_behind_origin_misses():
    assert _hit_sphere([0, 0, 0], [0, 0, 1], [0, 0, -3], 1.0) >= 1e29


def test_sphere_grazing():
    # Ray passing exactly at distance=radius: disc == 0 -> book says miss
    # (strict disc > 0).
    assert _hit_sphere([1.0, 0, 0], [0, 0, -1], [0, 0, -3], 1.0) >= 1e29
    # Slightly inside the silhouette: hit.
    assert _hit_sphere([0.999, 0, 0], [0, 0, -1], [0, 0, -3], 1.0) < 4.0


def test_sphere_inside_far_root():
    # Origin inside the sphere: near root is negative, far root selected.
    t = _hit_sphere([0, 0, -3], [0, 0, -1], [0, 0, -3], 1.0)
    np.testing.assert_allclose(t, 1.0, rtol=1e-6)


def test_sphere_negative_radius_normal_flipped():
    # Hollow-glass trick: negative radius flips the outward normal.
    o = jnp.array([[0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    c, r = _one_sphere([0, 0, -3], -1.0)
    t = sphere_hit_one(o, d, c[0:1].repeat(1, 0), r, T_MIN, T_MAX)
    _, n = sphere_normal(o, d, t, c, r)
    np.testing.assert_allclose(n[0], [0, 0, -1.0], atol=1e-5)


def test_sphere_t_min_shadow_acne_guard():
    # A hit at t < t_min must be rejected (the 1e-3 epsilon of the
    # reference's color() call).
    t = _hit_sphere([0, 0, -2.0 + 1e-4], [0, 0, -1], [0, 0, -3], 1.0)
    np.testing.assert_allclose(t, 2.0 - 1e-4, rtol=1e-3)


def test_sphere_all_vs_one_consistency(random_rays):
    # The integrator requires the dense test and the gathered per-primitive
    # test to agree *within one compiled program* (hit-mask consistency of
    # intersect vs recompute).  Separately-compiled instances may differ by
    # an ulp near grazing rays, so the comparison is jitted together.
    import jax

    o, d = random_rays
    rng_ = np.random.RandomState(1)
    centers = rng_.randn(16, 3).astype(np.float32) * 3
    radii = (0.3 + rng_.rand(16)).astype(np.float32)

    @jax.jit
    def both(o, d, c, r):
        t_all = sphere_hit_all(o, d, c, r, T_MIN, T_MAX)
        t_ones = [sphere_hit_one(
            o, d, jnp.broadcast_to(c[j], o.shape),
            jnp.broadcast_to(r[j], (o.shape[0],)), T_MIN, T_MAX)
            for j in range(16)]
        return t_all, jnp.stack(t_ones, axis=1)

    t_all, t_one = both(jnp.asarray(o), jnp.asarray(d),
                        jnp.asarray(centers), jnp.asarray(radii))
    t_all, t_one = np.asarray(t_all), np.asarray(t_one)
    both_hit = (t_all < 1e29) & (t_one < 1e29)
    np.testing.assert_allclose(t_all[both_hit], t_one[both_hit], rtol=1e-5)
    # Hit masks agree except possibly at knife-edge grazers.
    assert (t_all < 1e29).sum() == (t_one < 1e29).sum()


V0, V1, V2 = [0.0, 0.0, -2.0], [1.0, 0.0, -2.0], [0.0, 1.0, -2.0]


def _hit_tri(o, d, v0=V0, v1=V1, v2=V2):
    t = triangle_hit_all(
        jnp.array([o], jnp.float32), jnp.array([d], jnp.float32),
        jnp.array([v0], jnp.float32), jnp.array([v1], jnp.float32),
        jnp.array([v2], jnp.float32), T_MIN, T_MAX)
    return float(t[0, 0])


def test_triangle_center_hit():
    np.testing.assert_allclose(
        _hit_tri([0.25, 0.25, 0.0], [0, 0, -1]), 2.0, rtol=1e-6)


def test_triangle_outside_misses():
    assert _hit_tri([0.9, 0.9, 0.0], [0, 0, -1]) >= 1e29  # beyond hypotenuse
    assert _hit_tri([-0.1, 0.5, 0.0], [0, 0, -1]) >= 1e29


def test_triangle_parallel_ray_misses():
    assert _hit_tri([0.25, 0.25, 0.0], [1, 0, 0]) >= 1e29


def test_triangle_behind_misses():
    assert _hit_tri([0.25, 0.25, 0.0], [0, 0, 1]) >= 1e29


def test_triangle_degenerate_misses():
    # Zero-area triangle: determinant ~ 0 -> miss, no NaN.
    t = _hit_tri([0.25, 0.25, 0.0], [0, 0, -1],
                 v1=[0.0, 0.0, -2.0], v2=[0.0, 0.0, -2.0])
    assert t >= 1e29


def test_triangle_normal_winding():
    n = triangle_normal(jnp.array([V0]), jnp.array([V1]), jnp.array([V2]))
    np.testing.assert_allclose(n[0], [0, 0, 1.0], atol=1e-6)


def test_triangle_all_vs_one_consistency(random_rays):
    # Jitted together for the same reason as the sphere consistency test.
    import jax

    o, d = random_rays
    rng_ = np.random.RandomState(2)
    v0 = rng_.randn(8, 3).astype(np.float32)
    v1 = v0 + rng_.randn(8, 3).astype(np.float32)
    v2 = v0 + rng_.randn(8, 3).astype(np.float32)

    @jax.jit
    def both(o, d, v0, v1, v2):
        t_all = triangle_hit_all(o, d, v0, v1, v2, T_MIN, T_MAX)
        t_ones = [triangle_hit_one(
            o, d, jnp.broadcast_to(v0[j], o.shape),
            jnp.broadcast_to(v1[j], o.shape),
            jnp.broadcast_to(v2[j], o.shape), T_MIN, T_MAX)
            for j in range(8)]
        return t_all, jnp.stack(t_ones, axis=1)

    t_all, t_one = both(*map(jnp.asarray, (o, d, v0, v1, v2)))
    t_all, t_one = np.asarray(t_all), np.asarray(t_one)
    both_hit = (t_all < 1e29) & (t_one < 1e29)
    np.testing.assert_allclose(t_all[both_hit], t_one[both_hit], rtol=1e-5)
    assert (t_all < 1e29).sum() == (t_one < 1e29).sum()


def test_aabb_basic():
    o = jnp.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [5.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]])
    inv = 1.0 / d  # IEEE inf on zero components
    mn = jnp.array([[-1.0, -1.0, -3.0]] * 3)
    mx = jnp.array([[1.0, 1.0, -2.0]] * 3)
    hit = np.asarray(aabb_hit(o, inv, mn, mx, 1e-3, 1e30))
    assert list(hit) == [True, False, False]


def test_aabb_axis_parallel_inside_slab():
    # Ray along +x inside the box's y/z slabs -> hit despite 0 components.
    o = jnp.array([[-5.0, 0.0, -2.5]])
    d = jnp.array([[1.0, 0.0, 0.0]])
    hit = np.asarray(aabb_hit(o, 1.0 / d, jnp.array([[-1.0, -1.0, -3.0]]),
                              jnp.array([[1.0, 1.0, -2.0]]), 1e-3, 1e30))
    assert bool(hit[0])


def test_aabb_respects_t_interval():
    o = jnp.array([[0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    mn = jnp.array([[-1.0, -1.0, -3.0]])
    mx = jnp.array([[1.0, 1.0, -2.0]])
    # Box fully beyond t_max -> miss.
    assert not bool(np.asarray(
        aabb_hit(o, 1.0 / d, mn, mx, 1e-3, 1.5))[0])
    # Box fully before t_min -> miss.
    assert not bool(np.asarray(
        aabb_hit(o, 1.0 / d, mn, mx, 4.0, 1e30))[0])


def test_primitive_aabbs():
    c = np.array([[0.0, 0.0, -3.0]], np.float32)
    r = np.array([-1.5], np.float32)  # negative radius -> |r| box
    mn, mx = sphere_aabb_np(c, r)
    np.testing.assert_allclose(mn[0], [-1.5, -1.5, -4.5])
    np.testing.assert_allclose(mx[0], [1.5, 1.5, -1.5])
    v0 = np.array([[0.0, 0.0, -2.0]], np.float32)
    v1 = np.array([[1.0, 0.0, -2.0]], np.float32)
    v2 = np.array([[0.0, 1.0, -2.0]], np.float32)
    mn, mx = triangle_aabb_np(v0, v1, v2)
    assert (mx[0] - mn[0]).min() > 0  # padded: nonzero extent on flat axis
