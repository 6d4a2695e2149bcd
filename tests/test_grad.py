"""Gradient tests (SURVEY.md §4.4, BASELINE.json:2 'gradient allclose'):
jax.grad through the wavefront loop vs central finite differences of the
SAME renderer at the same RNG keys, for every parameter family the
north-star names (albedo, fuzz, IOR, sphere centers, radii), plus BVH-path
gradients and a convergent inverse-rendering step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from first_raytracer.accel.build import build_bvh
from first_raytracer.core import rng
from first_raytracer.diff.grad import (render_loss, render_loss_and_grads,
                                       sgd_step, split_params)
from first_raytracer.scene.builders import three_spheres

# Moderate depth keeps FD noise manageable; semantics identical.
CFG_KW = dict(nx=12, ny=6, spp=2)
MAX_DEPTH = 8


@pytest.fixture(scope="module")
def setup():
    scene, cam, cfg = three_spheres(**CFG_KW)
    cfg = dataclasses.replace(cfg, max_depth=MAX_DEPTH)
    key = rng.base_key(0)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    target = jnp.zeros((cfg.num_rays, 3), jnp.float32)
    return scene, cam, cfg, key, ids, target


def _fd_vs_ad(setup, field, index, h, rtol, accel=None, atol=1e-5,
              freeze_selection=False):
    """Central finite differences vs autodiff on one scalar parameter.

    ``freeze_selection=True`` pins primitive *selection* to the unperturbed
    scene (geometry params only): reparameterized gradients deliberately
    exclude the silhouette/visibility term (SURVEY.md §7 step 6), so for
    centers/radii the honest comparison is FD of the render with the same
    fixed selection — which is exactly the function autodiff differentiates.
    """
    scene, cam, cfg, key, ids, target = setup
    intersect_fn = None
    if freeze_selection:
        from first_raytracer.render.integrator import default_intersect

        def intersect_fn(scene_arg, accel_arg, o, d, t_min):  # noqa: F811
            return default_intersect(scene, accel, o, d, t_min)

    params, _ = split_params(scene, fields=(field,))
    loss, grads = render_loss_and_grads(
        params, scene, cam, cfg, key, ids, target, accel,
        intersect_fn=intersect_fn)
    g_ad = float(np.asarray(grads[field])[index])

    def loss_at(v):
        arr = np.asarray(params[field]).copy()
        arr[index] = v
        return float(render_loss({field: jnp.asarray(arr)}, scene, cam, cfg,
                                 key, ids, target, accel,
                                 intersect_fn=intersect_fn))

    v0 = float(np.asarray(params[field])[index])
    g_fd = (loss_at(v0 + h) - loss_at(v0 - h)) / (2 * h)
    assert np.isfinite(loss)
    np.testing.assert_allclose(g_ad, g_fd, rtol=rtol, atol=atol)
    return g_ad


def test_grad_albedo_matches_fd(setup):
    # Center diffuse sphere's blue channel — smooth in albedo.
    g = _fd_vs_ad(setup, "albedo", (1, 2), h=1e-3, rtol=2e-2)
    assert g != 0.0


def test_grad_fuzz_matches_fd(setup):
    g = _fd_vs_ad(setup, "fuzz", (2,), h=1e-3, rtol=5e-2)
    assert g != 0.0


def test_grad_ref_idx_matches_fd(setup):
    _fd_vs_ad(setup, "ref_idx", (3,), h=1e-3, rtol=5e-2)


@pytest.fixture(scope="module")
def interior_setup(setup):
    """Rays aimed at the *interior* of the center sphere (pixels away from
    every silhouette): there the radiance is smooth in geometry parameters
    and FD measures the same hit-equation derivative autodiff computes.
    Whole-image FD would additionally include the silhouette/visibility
    term that reparameterized sampling intentionally omits
    (SURVEY.md §7 step 6 scope)."""
    scene, cam, cfg, key, _, _ = setup
    cfg4 = dataclasses.replace(cfg, max_depth=4)
    ids = []
    for j in range(2, 4):          # bottom-up rows around image center
        for i in range(5, 7):
            pix = j * cfg4.nx + i
            ids.extend(pix * cfg4.spp + s for s in range(cfg4.spp))
    ids = jnp.asarray(ids, jnp.int32)
    target = jnp.zeros((len(ids), 3), jnp.float32)
    return scene, cam, cfg4, key, ids, target


def test_grad_sphere_center_matches_fd(interior_setup):
    g = _fd_vs_ad(interior_setup, "sphere_center", (1, 1), h=1e-3, rtol=0.15)
    assert g != 0.0


def test_grad_sphere_radius_matches_fd(interior_setup):
    _fd_vs_ad(interior_setup, "sphere_radius", (1,), h=3e-4, rtol=0.15)


@pytest.fixture(scope="module")
def tri_setup():
    """One large triangle square-on to the camera: center pixels hit its
    interior, far from every silhouette, so FD of vertex perturbations
    measures the same hit-equation derivative autodiff computes."""
    from first_raytracer.render.camera import make_camera
    from first_raytracer.render.integrator import RenderConfig
    from first_raytracer.scene.soa import SceneBuilder

    b = SceneBuilder()
    m = b.lambertian((0.7, 0.3, 0.2))
    b.triangle((-4.0, -4.0, -2.0), (4.0, -4.0, -2.0), (0.0, 5.0, -2.0), m)
    cam = make_camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 2.0)
    cfg = RenderConfig(nx=12, ny=6, spp=2, max_depth=4)
    key = rng.base_key(0)
    ids = []
    for j in range(2, 4):
        for i in range(5, 7):
            pix = j * cfg.nx + i
            ids.extend(pix * cfg.spp + s for s in range(cfg.spp))
    ids = jnp.asarray(ids, jnp.int32)
    target = jnp.zeros((len(ids), 3), jnp.float32)
    return b.build(), cam, cfg, key, ids, target


@pytest.mark.parametrize("field,index", [
    ("tri_v0", (0, 2)), ("tri_v1", (0, 0)), ("tri_v2", (0, 1))])
def test_grad_triangle_vertices_match_fd(tri_setup, field, index):
    """Every advertised triangle-vertex gradient (DIFF_FIELDS) vs FD —
    perturbing a vertex tilts/shifts the plane, moving interior hit points
    smoothly."""
    g = _fd_vs_ad(tri_setup, field, index, h=1e-3, rtol=0.15)
    assert g != 0.0


@pytest.fixture(scope="module")
def checker_setup():
    """Checker-ground camera scene (camera_showcase semantics, tiny)."""
    from first_raytracer.scene.builders import camera_showcase
    scene, cam, cfg = camera_showcase(nx=12, ny=6, spp=2)
    cfg = dataclasses.replace(cfg, max_depth=MAX_DEPTH)
    key = rng.base_key(0)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    target = jnp.zeros((cfg.num_rays, 3), jnp.float32)
    return scene, cam, cfg, key, ids, target


def test_grad_albedo2_matches_fd(checker_setup):
    """Checker odd color (albedo2, DIFF_FIELDS) vs FD — smooth: it scales
    the throughput of every checker-odd bounce."""
    g = _fd_vs_ad(checker_setup, "albedo2", (0, 1), h=1e-3, rtol=5e-2)
    assert g != 0.0


def test_grad_tex_scale_is_zero_by_design(checker_setup):
    """The checker frequency enters only through the SIGN of
    sin(s*x)sin(s*y)sin(s*z) — a discrete choice like the reflect/refract
    coin, so its reparameterized gradient is identically zero and FD away
    from checker-cell boundaries agrees (the radiance is piecewise constant
    in tex_scale).  This documents the advertised-but-degenerate DIFF_FIELDS
    entry rather than leaving it untested."""
    scene, cam, cfg, key, ids, target = checker_setup
    params, _ = split_params(scene, fields=("tex_scale",))
    _, grads = render_loss_and_grads(params, scene, cam, cfg, key, ids,
                                     target)
    np.testing.assert_array_equal(np.asarray(grads["tex_scale"]), 0.0)
    # FD with a step far smaller than any cell width: piecewise constant.
    l0 = float(render_loss(params, scene, cam, cfg, key, ids, target))
    p1 = {"tex_scale": params["tex_scale"] + 1e-6}
    l1 = float(render_loss(p1, scene, cam, cfg, key, ids, target))
    assert l0 == l1


def test_inverse_rendering_recovers_sphere_center():
    """Geometry, not just color: recover a mirror sphere's 3D center from
    interior-pixel radiance via the hit-equation gradient.  A specular
    sphere is the well-posed instance: the reflected sky direction is a
    strong smooth function of the surface normal, so a dozen interior
    pixels pin all 3 DOF (diffuse interiors are nearly flat in the center,
    and silhouette rays carry the visibility term reparameterized
    gradients intentionally omit — both excluded by construction)."""
    import optax

    from first_raytracer.diff.grad import make_fit_step, ray_radiance
    from first_raytracer.render.camera import make_camera
    from first_raytracer.render.integrator import RenderConfig
    from first_raytracer.scene.soa import SceneBuilder

    b = SceneBuilder()
    b.sphere((0.0, 0.0, -1.5), 0.5, b.metal((0.9, 0.9, 0.9), fuzz=0.0))
    scene = b.build()
    cam = make_camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 2.0)
    cfg = RenderConfig(nx=24, ny=12, spp=2, max_depth=4)
    key = rng.base_key(0)
    ids = []
    for j in range(5, 8):          # interior of the sphere's pixel disk
        for i in range(10, 14):
            pix = j * cfg.nx + i
            ids.extend(pix * cfg.spp + s for s in range(cfg.spp))
    ids = jnp.asarray(ids, jnp.int32)

    true_params, _ = split_params(scene, fields=("sphere_center",))
    target = ray_radiance(true_params, scene, cam, cfg, key, ids)
    c0 = np.asarray(true_params["sphere_center"]).copy()
    c = c0.copy()
    c[0] += [0.04, -0.03, 0.05]  # small offset: interior rays still hit
    params = {"sphere_center": jnp.asarray(c)}
    opt = optax.adam(5e-3)
    state = opt.init(params)
    step = make_fit_step(scene, cam, cfg, ids, target, opt)
    err0 = float(np.abs(np.asarray(params["sphere_center"])[0] -
                        c0[0]).sum())
    for _ in range(120):
        loss, params, state = step(params, state, key)
    err1 = float(np.abs(np.asarray(params["sphere_center"])[0] -
                        c0[0]).sum())
    assert err1 < 0.1 * err0, (err0, err1, float(loss))


def test_grad_through_bvh_matches_brute(setup):
    """BVH traversal is stop_gradient'd; grads must equal the brute-force
    path (same primitive selection => same differentiable hit recompute)."""
    scene, cam, cfg, key, ids, target = setup
    params, _ = split_params(scene, fields=("albedo", "sphere_center"))
    _, g_brute = render_loss_and_grads(
        params, scene, cam, cfg, key, ids, target, None)
    bvh = build_bvh(scene)
    _, g_bvh = render_loss_and_grads(
        params, scene, cam, cfg, key, ids, target, bvh)
    for k in params:
        np.testing.assert_allclose(np.asarray(g_brute[k]),
                                   np.asarray(g_bvh[k]),
                                   rtol=1e-4, atol=1e-7)


def test_inverse_rendering_recovers_albedo(setup):
    """Perturb the center sphere's albedo; SGD on the pixel loss must pull it
    back toward the true value (end-to-end differentiability demo)."""
    scene, cam, cfg, key, ids, _ = setup
    from first_raytracer.diff.grad import ray_radiance
    true_params, _ = split_params(scene, fields=("albedo",))
    target = ray_radiance(true_params, scene, cam, cfg, key, ids)

    albedo0 = np.asarray(true_params["albedo"]).copy()
    albedo = albedo0.copy()
    albedo[1] = [0.5, 0.5, 0.1]  # wrong color for the center sphere
    params = {"albedo": jnp.asarray(albedo)}
    err0 = float(np.abs(np.asarray(params["albedo"])[1] - albedo0[1]).sum())
    for _ in range(30):
        loss, params = sgd_step(params, scene, cam, cfg, key, ids, target,
                                lr=2.0)
    err1 = float(np.abs(np.asarray(params["albedo"])[1] - albedo0[1]).sum())
    assert err1 < 0.3 * err0, (err0, err1, float(loss))


def test_scan_matches_while_forward(setup):
    """differentiable=True (scan) and False (while_loop) produce identical
    radiance — the masked math is the same."""
    scene, cam, cfg, key, ids, _ = setup
    from first_raytracer.diff.grad import ray_radiance
    from first_raytracer.render.api import render_ray_batch
    params, _ = split_params(scene, fields=())
    rad_scan = np.asarray(ray_radiance(params, scene, cam, cfg, key, ids))
    rad_while = np.asarray(render_ray_batch(scene, cam, cfg, key, ids))
    # Different loop primitives compile to different fusion orders; allow
    # accumulated f32 associativity drift only.
    np.testing.assert_allclose(rad_scan, rad_while, atol=1e-4)


def test_grads_from_kernel_tape_match_brute(setup):
    """A tape recorded by the path-tracing kernel (interpreted) drives the
    replay to the same loss and gradients as the brute-force record: the
    kernel only selects primitives, every gradient comes from the
    differentiable replay (SURVEY.md §7 step 6)."""
    from first_raytracer.diff.grad import render_loss_and_grads_tape
    from first_raytracer.kernels.megakernel import (pack_scene_mega,
                                                    record_paths_mega)

    scene, cam, cfg, key, ids, target = setup
    params, _ = split_params(scene, fields=("albedo", "sphere_center"))
    l_b, g_b = render_loss_and_grads(params, scene, cam, cfg, key, ids,
                                     target)
    tape = record_paths_mega(pack_scene_mega(scene), cam, cfg, key,
                             num_rays=ids.shape[0], interpret=True,
                             block=32)
    l_k, g_k = render_loss_and_grads_tape(params, scene, cam, cfg, key, ids,
                                          target, tape)
    np.testing.assert_allclose(float(l_k), float(l_b), rtol=1e-5)
    for f in params:
        np.testing.assert_allclose(np.asarray(g_k[f]), np.asarray(g_b[f]),
                                   rtol=2e-3, atol=1e-6)


def test_optax_fit_step_converges(setup):
    """make_fit_step (optax Adam) drives a perturbed albedo toward truth —
    the stateful-optimizer generalization of sgd_step used by cli fit."""
    import optax

    from first_raytracer.diff.grad import make_fit_step, ray_radiance

    scene, cam, cfg, key, ids, _ = setup
    true_params, _ = split_params(scene, fields=("albedo",))
    target = ray_radiance(true_params, scene, cam, cfg, key, ids)
    albedo0 = np.asarray(true_params["albedo"]).copy()
    albedo = albedo0.copy()
    albedo[1] = [0.5, 0.5, 0.1]
    params = {"albedo": jnp.asarray(albedo)}
    opt = optax.adam(0.05)
    state = opt.init(params)
    step = make_fit_step(scene, cam, cfg, ids, target, opt)
    err0 = float(np.abs(np.asarray(params["albedo"])[1] - albedo0[1]).sum())
    for _ in range(40):
        loss, params, state = step(params, state, key)
    err1 = float(np.abs(np.asarray(params["albedo"])[1] - albedo0[1]).sum())
    assert err1 < 0.5 * err0, (err0, err1, float(loss))
