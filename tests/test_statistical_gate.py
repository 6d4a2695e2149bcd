"""Converged-image statistical gate (SURVEY.md §4.3; VERDICT r2 item 7).

The per-ray parity tests (test_oracle_parity.py, test_goldens.py) allow a
small fraction of knife-edge rays (`frac_tol` up to 1%) whose per-ray
error is unbounded — a near-tie argmin flip sends the whole path down a
different branch.  This module closes that loophole with an independent,
image-level bound: at pixel level a flipped *sample* moves its pixel by at
most O(1/spp), so the converged (pixel-averaged) image must agree with
the oracle to a bound that the per-ray escape cannot widen:

- bulk agreement: mean |image - oracle| at float-noise scale;
- worst pixel: <= a few flipped samples' worth (k/spp), never O(1).

Runs the exact scenes that use the frac_tol escape, at higher spp, against
the independent C++ oracle (native/frt_oracle.cpp) when built — ~100x the
NumPy oracle — falling back to the NumPy oracle otherwise.
"""
import dataclasses

import numpy as np
import pytest

from first_raytracer.oracle import native_oracle
from first_raytracer.oracle.cpu_oracle import render_oracle
from first_raytracer.render.api import render_image
from first_raytracer.scene.builders import random_scene, triangle_scene

# (name, builder, spp).  These are the two scenes whose per-ray parity
# tests carry a frac_tol escape hatch; spp chosen so the k/spp pixel
# bound is meaningfully tighter than the radiance range [0, 1].
CASES = [
    ("random-spheres", random_scene, 16),
    ("triangle-mesh", triangle_scene, 16),
]


def _oracle(scene, cam, cfg):
    if native_oracle.available():
        return native_oracle.render_oracle_native(scene, cam, cfg, seed=0)
    return render_oracle(scene, cam, cfg, seed=0)


@pytest.mark.parametrize("name,build,spp", CASES, ids=[c[0] for c in CASES])
def test_converged_image_matches_oracle(name, build, spp):
    scene, cam, cfg = build(nx=24, ny=12, spp=spp)
    img = np.asarray(render_image(scene, cam, cfg, seed=0))
    orc = _oracle(scene, cam, cfg)
    d = np.abs(img - orc).max(axis=-1)  # per-pixel, worst channel

    # Bulk: virtually every sample is bit-matched, so the image mean
    # error sits at accumulation-noise scale even with a few flips.
    assert d.mean() < 1.5e-3, f"{name}: image mean err {d.mean():.2e}"
    # Worst pixel: each flipped sample moves its pixel by <= ~1/spp
    # (radiance in [0,1]); allow up to 3 flips landing in one pixel
    # plus float noise.  An unbounded per-ray error CANNOT pass this
    # unless it is rare AND pixel-diluted — which is the claim under test.
    assert d.max() < 3.0 / spp + 1e-3, f"{name}: worst pixel {d.max():.3f}"
    # Coverage: the overwhelming majority of pixels are exact to tight tol.
    assert (d < 5e-4).mean() > 0.97, (
        f"{name}: only {(d < 5e-4).mean():.1%} pixels tight")


def test_gate_is_calibrated():
    """The gate must FAIL a genuinely wrong image (not be vacuously loose):
    perturb one material albedo by 5% and check the same bounds trip."""
    scene, cam, cfg = random_scene(nx=24, ny=12, spp=16)
    img = np.asarray(render_image(scene, cam, cfg, seed=0))
    bad = dataclasses.replace(scene, albedo=scene.albedo * 0.95)
    img_bad = np.asarray(render_image(bad, cam, cfg, seed=0))
    d = np.abs(img_bad - img).max(axis=-1)
    assert not (d.mean() < 1.5e-3 and (d < 5e-4).mean() > 0.97), (
        "statistical gate failed to detect a 5% albedo perturbation")


def test_gate_worst_pixel_bound_is_calibrated():
    """The max-pixel bound (3/spp + 1e-3) must also be falsifiable — a
    strong localized error has to trip it, not just the mean/coverage
    bounds (ADVICE r3).  Halving every albedo changes lit pixels by O(1),
    far beyond the bound."""
    spp = 16
    scene, cam, cfg = random_scene(nx=24, ny=12, spp=spp)
    img = np.asarray(render_image(scene, cam, cfg, seed=0))
    bad = dataclasses.replace(scene, albedo=scene.albedo * 0.5)
    img_bad = np.asarray(render_image(bad, cam, cfg, seed=0))
    d = np.abs(img_bad - img).max(axis=-1)
    assert d.max() >= 3.0 / spp + 1e-3, (
        f"worst-pixel bound never trips (max {d.max():.3f}): vacuous gate")
