"""Gradients vs finite differences OF THE NATIVE C++ ORACLE.

tests/test_grad.py validates ``jax.grad`` against finite differences of
the same JAX renderer — self-consistency.  VERDICT r3 item 6: a shared
forward/backward semantic bug (e.g. in ``scatter_from_params``, a code
path the forward oracle-parity tests never touch) would pass that suite.
These tests close the loop per SURVEY.md §4.4: central finite differences
of the *independent* recursive C++ renderer (native/frt_oracle.cpp, the
reference's own architecture, same counter-RNG stream) against
``jax.grad`` of the JAX path, at matched rays.

Selection scope: reparameterized gradients deliberately exclude the
silhouette/visibility term (SURVEY.md §7 step 6), but the oracle re-runs
full selection at the perturbed parameters.  For geometry parameters the
comparison is therefore restricted to rays whose primitive tape is
IDENTICAL at theta-h, theta, theta+h — mechanically "away from
silhouettes" (and away from dielectric coin flips, which also change the
tape).  Albedo perturbs no geometry, so all rays qualify.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from first_raytracer.core import rng
from first_raytracer.diff.grad import ray_radiance, split_params
from first_raytracer.diff.replay import record_paths
from first_raytracer.oracle import native_oracle
from first_raytracer.render.camera import generate_rays
from first_raytracer.scene.builders import three_spheres

pytestmark = pytest.mark.skipif(not native_oracle.available(),
                                reason="native oracle not built")

CFG_KW = dict(nx=12, ny=6, spp=2)
MAX_DEPTH = 8


@pytest.fixture(scope="module")
def setup():
    scene, cam, cfg = three_spheres(**CFG_KW)
    cfg = dataclasses.replace(cfg, max_depth=MAX_DEPTH)
    key = rng.base_key(0)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    return scene, cam, cfg, key, ids


def _oracle_loss(scene, cam, cfg, ids, mask):
    """mean(radiance^2) over the masked rays, from the C++ oracle, f64."""
    rad = native_oracle.render_oracle_native(
        scene, cam, cfg, ray_ids=np.asarray(ids, np.int64))
    return float((rad.astype(np.float64)[mask] ** 2).mean())


def _tape(scene, cam, cfg, key, ids):
    cam_u = rng.camera_uniforms(key, ids)
    o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids, cam_u)
    return np.asarray(record_paths(scene, o, d, ids, key, cfg))


def _fd_oracle_vs_ad(setup, field, index, h, rtol, mask_by_tape):
    scene, cam, cfg, key, ids = setup

    def perturbed(delta):
        arr = np.asarray(getattr(scene, field)).copy()
        arr[index] += delta
        return dataclasses.replace(scene, **{field: jnp.asarray(arr)})

    s_plus, s_minus = perturbed(h), perturbed(-h)
    if mask_by_tape:
        t0 = _tape(scene, cam, cfg, key, ids)
        tp = _tape(s_plus, cam, cfg, key, ids)
        tm = _tape(s_minus, cam, cfg, key, ids)
        mask = ((t0 == tp) & (t0 == tm)).all(axis=0)
        assert mask.sum() >= 16, "too few selection-stable rays to test"
    else:
        mask = np.ones(len(np.asarray(ids)), bool)
    midx = jnp.asarray(np.nonzero(mask)[0], jnp.int32)

    # Central FD of the independent C++ oracle.
    g_fd = (_oracle_loss(s_plus, cam, cfg, ids, mask)
            - _oracle_loss(s_minus, cam, cfg, ids, mask)) / (2 * h)

    # jax.grad of the JAX path at the same rays, same loss.
    params, _ = split_params(scene, fields=(field,))

    def loss(params):
        rad = ray_radiance(params, scene, cam, cfg, key, ids)
        return jnp.mean(rad[midx] ** 2)

    g_ad = float(np.asarray(jax.grad(loss)(params)[field])[index])
    np.testing.assert_allclose(g_ad, g_fd, rtol=rtol, atol=1e-5)
    return g_ad


def test_albedo_grad_matches_oracle_fd(setup):
    """Albedo: no geometry change, every ray qualifies."""
    g = _fd_oracle_vs_ad(setup, "albedo", (1, 2), h=1e-2, rtol=5e-2,
                         mask_by_tape=False)
    assert g != 0.0


def test_fuzz_grad_matches_oracle_fd(setup):
    """Metal fuzz: scatter direction changes, so deep tapes can flip —
    mask to tape-stable rays."""
    g = _fd_oracle_vs_ad(setup, "fuzz", (2,), h=1e-3, rtol=0.1,
                         mask_by_tape=True)
    assert g != 0.0


def test_ref_idx_grad_matches_oracle_fd(setup):
    """Dielectric IOR: Schlick changes flip reflect/refract coins for
    near-threshold rays — the tape mask removes exactly those."""
    _fd_oracle_vs_ad(setup, "ref_idx", (3,), h=1e-3, rtol=0.1,
                     mask_by_tape=True)


def test_sphere_center_grad_matches_oracle_fd(setup):
    """Geometry: tape-stable rays measure the hit-equation derivative."""
    g = _fd_oracle_vs_ad(setup, "sphere_center", (1, 1), h=1e-3, rtol=0.15,
                         mask_by_tape=True)
    assert g != 0.0


def test_sphere_radius_grad_matches_oracle_fd(setup):
    _fd_oracle_vs_ad(setup, "sphere_radius", (1,), h=5e-4, rtol=0.15,
                     mask_by_tape=True)


@pytest.fixture(scope="module")
def setup_tri():
    from first_raytracer.scene.builders import triangle_scene
    scene, cam, cfg = triangle_scene(nx=16, ny=8, spp=2)
    cfg = dataclasses.replace(cfg, max_depth=MAX_DEPTH)
    key = rng.base_key(0)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    return scene, cam, cfg, key, ids


@pytest.fixture(scope="module")
def setup_checker():
    from first_raytracer.scene.builders import camera_showcase
    scene, cam, cfg = camera_showcase(nx=16, ny=8, spp=2)
    cfg = dataclasses.replace(cfg, max_depth=MAX_DEPTH)
    key = rng.base_key(0)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    return scene, cam, cfg, key, ids


def test_tri_v0_grad_matches_oracle_fd(setup_tri):
    """Triangle vertex (floor quad corner): the hit-equation/normal
    derivative for triangle geometry (VERDICT r4 item 6 — no FD-oracle
    test touched triangles before r5)."""
    g = _fd_oracle_vs_ad(setup_tri, "tri_v0", (0, 1), h=1e-3, rtol=0.15,
                         mask_by_tape=True)
    assert g != 0.0


def test_tri_v1_grad_matches_oracle_fd(setup_tri):
    _fd_oracle_vs_ad(setup_tri, "tri_v1", (0, 1), h=1e-3, rtol=0.15,
                     mask_by_tape=True)


def test_tri_v2_grad_matches_oracle_fd(setup_tri):
    _fd_oracle_vs_ad(setup_tri, "tri_v2", (1, 1), h=1e-3, rtol=0.15,
                     mask_by_tape=True)


def test_albedo2_grad_matches_oracle_fd(setup_checker):
    """Checker secondary color (camera-effects preset exercises the
    checker texture): pure attenuation, every ray qualifies."""
    g = _fd_oracle_vs_ad(setup_checker, "albedo2", (0, 1), h=1e-2,
                         rtol=5e-2, mask_by_tape=False)
    assert g != 0.0
