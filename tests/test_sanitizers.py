"""Sanitizer runs (SURVEY.md §5.2): the JAX-functional equivalents of the
race/UB sanitizers a native framework would run in CI.

- ``jax_debug_nans``: the full wavefront render must produce no NaN/Inf
  anywhere in its outputs even though masked dead lanes see garbage
  internally (the integrator sanitizes hit data before scatter math).
- ``checkify`` index checks: the BVH traversal's dynamic gathers
  (node/primitive indices from the flattened tree walk) stay in bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import checkify

from first_raytracer.accel.build import build_bvh
from first_raytracer.core import rng
from first_raytracer.render.api import render_ray_batch
from first_raytracer.scene.builders import random_scene, three_spheres


def test_render_nan_free_under_debug_nans():
    scene, cam, cfg = three_spheres(nx=16, ny=8, spp=2)
    key = rng.base_key(0)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    old = jax.config.jax_debug_nans
    try:
        jax.config.update("jax_debug_nans", True)
        out = render_ray_batch(scene, cam, cfg, key, ids)
        out = np.asarray(out)
    finally:
        jax.config.update("jax_debug_nans", old)
    assert np.isfinite(out).all()


def test_bvh_traversal_index_checks():
    from first_raytracer.accel.traverse import intersect_bvh

    scene, cam, cfg = random_scene(nx=8, ny=4, spp=1)
    accel = build_bvh(scene, max_leaf=4)
    r = np.random.RandomState(3)
    o = jnp.asarray(r.randn(256, 3) * 5.0, jnp.float32)
    d = r.randn(256, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d, jnp.float32)

    def walk(o, d):
        prim, t, hit = intersect_bvh(scene, accel, o, d, 1e-3)
        return prim, t, hit

    checked = checkify.checkify(jax.jit(walk), errors=checkify.index_checks)
    err, (prim, t, hit) = checked(o, d)
    err.throw()  # raises if any traversal gather went out of bounds
    assert prim.shape == (256,)
