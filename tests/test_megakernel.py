"""Path-tracing kernel tests: interpret-mode equivalence with the wavefront
integrator on every scene class (SURVEY.md §5.2 'sanitizer' runs).

The kernel re-derives the whole pipeline (camera, threefry RNG, intersect,
scatter, sky) per lane, so these tests pin it against ``render_image`` —
identical RNG stream and op-for-op arithmetic, so images match except where
a different rounding flips a rare near-silhouette sample (bounded
statistically)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from first_raytracer.kernels.megakernel import (pack_scene_mega,
                                                render_image_mega,
                                                render_pixels_mega)
from first_raytracer.render.api import render_image
from first_raytracer.scene.builders import (camera_showcase,
                                            random_scene, sphere_field,
                                            three_spheres,
                                            triangle_field,
                                            triangle_scene)


def _tri_only(**kw):
    scene, cam, cfg = triangle_scene(**kw)
    return dataclasses.replace(
        scene, sphere_center=jnp.zeros((0, 3), jnp.float32),
        sphere_radius=jnp.zeros((0,), jnp.float32),
        sphere_mat=jnp.zeros((0,), jnp.int32)), cam, cfg


def _checker_final(**kw):
    return random_scene(checker_ground=True, **kw)


def _close(ref, img, frac=0.01):
    diff = np.abs(np.asarray(ref) - np.asarray(img))
    # Bulk of pixels bit-close; allow rare rounding-driven sample flips.
    assert (diff > 1e-3).mean() < frac, diff.max()
    assert np.median(diff) < 1e-5


@pytest.mark.parametrize("preset,kw", [
    (three_spheres, dict(nx=32, ny=16, spp=4)),
    (triangle_scene, dict(nx=32, ny=16, spp=2)),
    (camera_showcase, dict(nx=32, ny=16, spp=4)),
    (random_scene, dict(nx=24, ny=12, spp=2)),
    (_checker_final, dict(nx=24, ny=12, spp=2)),
    (_tri_only, dict(nx=24, ny=12, spp=2)),
    (sphere_field, dict(n=300, nx=24, ny=12, spp=2)),
    (triangle_field, dict(n=200, nx=24, ny=12, spp=2)),
], ids=["three-spheres", "triangle-mesh", "camera-effects",
        "random-spheres", "checker-final", "triangles-only",
        "sphere-field", "triangle-field"])
def test_megakernel_matches_wavefront(preset, kw):
    scene, cam, cfg = preset(**kw)
    ref = render_image(scene, cam, cfg)
    img = render_image_mega(scene, cam, cfg, interpret=True, block=32)
    _close(ref, img)


@pytest.mark.parametrize("block", [16, 32, 128])
def test_megakernel_block_sizes(block):
    """Radiance lands on the right pixel for any block size, including
    blocks larger than the image and a padded last block."""
    scene, cam, cfg = three_spheres(nx=40, ny=8, spp=2)
    ref = render_image(scene, cam, cfg)
    _close(ref, render_image_mega(scene, cam, cfg, interpret=True,
                                  block=block))


@pytest.mark.parametrize("preset", [three_spheres, triangle_scene])
def test_megakernel_segment_counts(preset):
    """Segment totals agree with the integrator's stats counter."""
    from first_raytracer.core import rng
    from first_raytracer.render.camera import generate_rays
    from first_raytracer.render.integrator import trace_rays

    scene, cam, cfg = preset(nx=16, ny=8, spp=2)
    key = rng.base_key(0)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    cu = rng.camera_uniforms(key, ids)
    o, d = generate_rays(cam, cfg.nx, cfg.ny, cfg.spp, ids, cu)
    _, segs_ref = trace_rays(scene, o, d, ids, key, cfg, return_stats=True)

    pack = pack_scene_mega(scene)
    _, segs = render_pixels_mega(pack, cam, cfg, key, interpret=True,
                                 block=32)
    assert segs.shape == (cfg.num_pixels,)
    # Per pixel: the sum of its samples' segments.
    np.testing.assert_array_equal(
        np.asarray(segs),
        np.asarray(segs_ref).reshape(cfg.num_pixels, cfg.spp).sum(1))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_megakernel_sharded_matches_single(n_dev):
    """Tiles mesh == single-device kernel render, bit-identical.

    Sharding invariance (SURVEY.md §4.5c): RNG keyed by global ray id, so
    the pixel blocks are computed identically wherever they land (369
    pixels leave a padded last shard on both meshes).
    """
    import jax

    from first_raytracer.kernels.megakernel import (
        render_image_mega_sharded)
    from first_raytracer.parallel.mesh import make_render_mesh

    scene, cam, cfg = three_spheres(nx=41, ny=9, spp=2)
    mesh = make_render_mesh(n_dev, 1, devices=jax.devices()[:n_dev])
    single = np.asarray(render_image_mega(scene, cam, cfg, interpret=True,
                                          block=32))
    sharded = np.asarray(render_image_mega_sharded(
        scene, cam, cfg, mesh, interpret=True, block=32))
    np.testing.assert_array_equal(single, sharded)


def test_megakernel_occupancy_metrics():
    from first_raytracer.utils.metrics import megakernel_occupancy

    scene, cam, cfg = three_spheres(nx=32, ny=8, spp=2)
    m = megakernel_occupancy(scene, cam, cfg, interpret=True, block=32)
    assert m["segments"] > cfg.num_rays  # >= 1 segment per path
    assert 0 < m["lane_occupancy"] <= 1


@pytest.mark.parametrize("nx,ny,spp", [
    (8, 4, 1),      # image smaller than a block, single sample
    (7, 5, 3),      # nothing divides anything
    (16, 8, 100),   # deep sample loop (the book's spp)
])
def test_megakernel_shape_edges(nx, ny, spp):
    scene, cam, cfg = three_spheres(nx=nx, ny=ny, spp=spp)
    ref = render_image(scene, cam, cfg)
    img = render_image_mega(scene, cam, cfg, interpret=True, block=32)
    _close(ref, img, frac=0.02)


def test_megakernel_triangles_only_scene():
    """ns=0 path: the sphere loop is compiled out; the triangle table
    supplies t, normals and materials."""
    scene, cam, cfg = _tri_only(nx=48, ny=24, spp=2)
    ref = render_image(scene, cam, cfg)
    _close(ref, render_image_mega(scene, cam, cfg, interpret=True,
                                  block=64))


def test_megakernel_progressive_batches_sum_to_full():
    """Sample batches at a traced ``spp0`` offset sum to the one-shot
    render: the ray-id space is the full frame's."""
    from first_raytracer.core import rng

    scene, cam, cfg = three_spheres(nx=12, ny=6, spp=4)
    pack = pack_scene_mega(scene)
    key = rng.base_key(2)
    full, _ = render_pixels_mega(pack, cam, cfg, key, interpret=True,
                                 block=32)
    half = dataclasses.replace(cfg, spp=2)
    a, _ = render_pixels_mega(pack, cam, half, key, spp0=0, spp_total=4,
                              interpret=True, block=32)
    b, _ = render_pixels_mega(pack, cam, half, key, spp0=2, spp_total=4,
                              interpret=True, block=32)
    np.testing.assert_allclose(np.asarray(a + b), np.asarray(full),
                               rtol=1e-6, atol=1e-6)


def test_pack_tables_layout():
    """Per-primitive rows: material of each primitive, sphere geometry,
    unit triangle normals; sweep tables hold v0 and the two edges."""
    scene, _, _ = triangle_scene()
    pack = pack_scene_mega(scene)
    ns, nt = scene.num_spheres, scene.num_triangles
    assert (pack.ns, pack.nt) == (ns, nt)
    prim = np.asarray(pack.prim)
    assert prim.shape == (ns + nt, 16)
    mats = np.concatenate([np.asarray(scene.sphere_mat),
                           np.asarray(scene.tri_mat)])
    np.testing.assert_array_equal(prim[:, 0],
                                  np.asarray(scene.mat_type)[mats])
    np.testing.assert_array_equal(prim[:, 4:7],
                                  np.asarray(scene.albedo)[mats])
    np.testing.assert_array_equal(prim[:ns, 12:15],
                                  np.asarray(scene.sphere_center))
    np.testing.assert_allclose(np.linalg.norm(prim[ns:, 12:15], axis=1), 1,
                               rtol=1e-6)
    tri = np.asarray(pack.tri)
    np.testing.assert_array_equal(
        tri[:, 3:6], np.asarray(scene.tri_v1) - np.asarray(scene.tri_v0))


def test_pack_single_primitive_type_placeholders():
    """A scene without triangles (or spheres) still hands the kernel
    non-empty operands."""
    scene, _, _ = three_spheres()
    pack = pack_scene_mega(scene)
    assert pack.nt == 0 and pack.tri.shape == (1, 9)
    scene, _, _ = _tri_only()
    pack = pack_scene_mega(scene)
    assert pack.ns == 0 and pack.sph.shape == (1, 4)
    assert pack.prim.shape[0] == scene.num_triangles
