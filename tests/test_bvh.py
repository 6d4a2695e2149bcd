"""BVH tests (SURVEY.md §4.2): structural invariants of the flat layout and
traversal == brute force on random scenes and on every preset."""
import jax.numpy as jnp
import numpy as np
import pytest

from first_raytracer.accel.build import build_bvh, scene_prim_bounds
from first_raytracer.accel.traverse import intersect_bvh
from first_raytracer.render.integrator import intersect_brute
from first_raytracer.scene.builders import (camera_showcase,
                                            random_scene, sphere_field,
                                            three_spheres,
                                            triangle_field,
                                            triangle_scene)
from first_raytracer.scene.soa import SceneBuilder


def _random_sphere_scene(n, seed):
    r = np.random.RandomState(seed)
    b = SceneBuilder()
    m = b.lambertian((0.5, 0.5, 0.5))
    for i in range(n):
        b.sphere(r.randn(3) * 4, 0.2 + r.rand(), m)
    return b.build()


def _rays(n, seed, spread=6.0):
    r = np.random.RandomState(seed)
    o = (r.randn(n, 3) * spread).astype(np.float32)
    d = r.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_flat_layout_invariants():
    scene = _random_sphere_scene(64, 0)
    bvh = build_bvh(scene, max_leaf=4)
    first = np.asarray(bvh.node_first)
    count = np.asarray(bvh.node_count)
    skip = np.asarray(bvh.node_skip)
    n = bvh.num_nodes
    # prim_ids is a permutation of all primitives.
    assert sorted(np.asarray(bvh.prim_ids).tolist()) == list(range(64))
    # Skip links point forward, within bounds.
    assert np.all(skip > np.arange(n))
    assert np.all(skip <= n)
    # Leaves: 1..max_leaf prims, slots within range; leaf slot ranges tile
    # the prim array exactly.
    leaves = count > 0
    assert np.all(count[leaves] <= 4)
    ends = first[leaves] + count[leaves]
    assert np.all(ends <= 64)
    covered = np.zeros(64, bool)
    for f, c in zip(first[leaves], count[leaves]):
        assert not covered[f:f + c].any()
        covered[f:f + c] = True
    assert covered.all()
    # Child boxes are contained in parent boxes.  Structure recovery: an
    # inner node's left child is the next preorder index; the right child is
    # the left child's skip target.
    mn = np.asarray(bvh.node_min)
    mx = np.asarray(bvh.node_max)
    seen = 0
    stack = [(0, -np.inf * np.ones(3), np.inf * np.ones(3))]
    while stack:
        i, pmn, pmx = stack.pop()
        seen += 1
        assert np.all(mn[i] >= pmn - 1e-5) and np.all(mx[i] <= pmx + 1e-5)
        if count[i] == 0:
            left, right = i + 1, skip[i + 1]
            assert i < right < skip[i]  # right child inside this subtree
            stack.append((left, mn[i], mx[i]))
            stack.append((right, mn[i], mx[i]))
    assert seen == n  # every node reachable exactly once

    # Primitive boxes are inside their leaf boxes.
    pbmin, pbmax = scene_prim_bounds(scene.as_numpy())
    pids = np.asarray(bvh.prim_ids)
    for li in np.nonzero(leaves)[0]:
        for s in range(count[li]):
            pid = pids[first[li] + s]
            assert np.all(pbmin[pid] >= mn[li] - 1e-5)
            assert np.all(pbmax[pid] <= mx[li] + 1e-5)


def _assert_traversal_matches(scene, bvh, o, d, max_leaf=4):
    """Traversal == brute force, modulo knife-edge grazers: the two paths are
    compiled separately, so last-ulp drift can flip a tangent hit."""
    pb, tb, hb = intersect_brute(scene, o, d, 1e-3)
    pv, tv, hv = intersect_bvh(scene, bvh, o, d, 1e-3, max_leaf=max_leaf)
    pb, tb, hb = map(np.asarray, (pb, tb, hb))
    pv, tv, hv = map(np.asarray, (pv, tv, hv))
    assert (hb != hv).mean() < 0.005
    both = hb & hv
    if not both.any():  # all rays legitimately miss (tiny scenes)
        assert (hb == hv).all()
        return
    agree = pb[both] == pv[both]
    assert agree.mean() > 0.995
    np.testing.assert_allclose(tb[both][agree], tv[both][agree], rtol=2e-4)


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (7, 2), (64, 3), (257, 4)])
def test_traversal_equals_brute_random_spheres(n, seed):
    scene = _random_sphere_scene(n, seed)
    bvh = build_bvh(scene, max_leaf=4)
    o, d = _rays(512, seed + 10)
    _assert_traversal_matches(scene, bvh, o, d)


@pytest.mark.parametrize("preset", [three_spheres, triangle_scene,
                                    random_scene],
                         ids=["three-spheres", "triangle-mesh",
                              "random-spheres"])
def test_traversal_equals_brute_presets(preset):
    scene, cam, cfg = preset()
    bvh = build_bvh(scene, max_leaf=4)
    o, d = _rays(512, 99, spread=4.0)
    _assert_traversal_matches(scene, bvh, o, d)


def test_median_split_also_correct():
    scene = _random_sphere_scene(64, 5)
    bvh = build_bvh(scene, max_leaf=2, use_sah=False)
    o, d = _rays(256, 6)
    _assert_traversal_matches(scene, bvh, o, d, max_leaf=2)


@pytest.mark.parametrize("preset,kw", [
    (camera_showcase, {}),
    (sphere_field, dict(n=5000)),
    (triangle_field, dict(n=5000)),
], ids=["camera-effects", "sphere-field-5000", "triangle-field-5000"])
def test_traversal_equals_brute_large_scenes(preset, kw):
    """The plain path's two closest-hit finders agree at large-scene
    sizes (many leaves, deep trees), on camera rays of the scene."""
    from first_raytracer.core import rng
    from first_raytracer.render.camera import generate_rays

    scene, cam, cfg = preset(**kw)
    bvh = build_bvh(scene, max_leaf=4)
    key = rng.base_key(0)
    ids = jnp.arange(0, cfg.num_rays, cfg.num_rays // 1024,
                     dtype=jnp.int32)
    o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids,
                         rng.camera_uniforms(key, ids))
    _assert_traversal_matches(scene, bvh, o, d)


@pytest.mark.parametrize("max_leaf", [1, 3, 8])
def test_leaf_size_invariance(max_leaf):
    """Winner selection does not depend on how primitives land in leaves."""
    scene = random_scene(seed=7)[0]
    bvh = build_bvh(scene, max_leaf=max_leaf)
    o, d = _rays(700, 0, spread=8.0)
    _assert_traversal_matches(scene, bvh, o, d, max_leaf=max_leaf)
