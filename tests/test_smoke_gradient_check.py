"""The gradient check of chip_smoke.py, at a small size on the CPU.

The kernel's tape (interpret mode here) replayed over the rays no nudge
moves must match the pool recorder's tape and direct reverse mode through
the plain wavefront, and a tape wrong on a few rays must fail both.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from first_raytracer.core import rng  # noqa: E402
from first_raytracer.diff.grad import split_params  # noqa: E402
from first_raytracer.diff.replay import record_paths_pool  # noqa: E402
from first_raytracer.kernels.megakernel import (pack_scene_mega,  # noqa: E402
                                                record_paths_mega)
from first_raytracer.scene.builders import (three_spheres,  # noqa: E402
                                            triangle_scene)


@pytest.fixture(scope="module", params=[three_spheres, triangle_scene],
                ids=["three_spheres", "triangle_scene"])
def case(request):
    scene, cam, cfg = request.param(nx=16, ny=8, spp=2)
    key = rng.base_key(0)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)
    tape = np.asarray(record_paths_mega(pack_scene_mega(scene), cam, cfg,
                                        key, interpret=True))
    ill, counts = chip_smoke.ill_conditioned(jax, jnp, scene, cam, cfg, key,
                                             ids, n=4)
    params, _ = split_params(scene)
    ref_loss, ref_grads, well = chip_smoke.reverse_mode(
        params, scene, cam, cfg, key, np.nonzero(~ill)[0], slices=4)
    pool = np.asarray(record_paths_pool(scene, cam, cfg, key, ids,
                                        pool_size=64))
    return (scene, cam, cfg, key, params, tape, ill, counts, well,
            (ref_loss, ref_grads), pool)


def test_nudges_flag_a_minority_cumulatively(case):
    ill, counts, well = case[6:9]
    assert list(counts) == list(chip_smoke.NUDGES)
    assert list(counts.values()) == sorted(counts.values())
    assert counts[chip_smoke.NUDGES[-1]] == int(ill.sum())
    assert well.shape[0] > ill.size // 2
    assert not ill[np.asarray(well)].any()


def _replay(case, tape):
    scene, cam, cfg, key, params = case[:5]
    well = case[8]
    return chip_smoke.replay(params, scene, cam, cfg, key, well,
                             tape[:, np.asarray(well)])


def test_kernel_tape_matches_pool_tape_and_reverse_mode(case):
    tape, ref, pool = case[5], case[9], case[10]
    got = _replay(case, tape)
    assert chip_smoke.within(*chip_smoke.compare(got, _replay(case, pool)))
    rel = chip_smoke.compare(got, ref)
    assert chip_smoke.within(*rel), rel


def test_wrong_tape_fails_both_checks(case):
    scene, tape, ref, pool = case[0], case[5], case[9], case[10]
    well = np.asarray(case[8])
    bad = chip_smoke.wrong_first_hits(tape[:, well], 4,
                                      scene.num_primitives)
    full = np.array(tape)
    full[:, well] = bad
    got = _replay(case, full)
    assert not chip_smoke.within(*chip_smoke.compare(got, ref))
    assert not chip_smoke.within(
        *chip_smoke.compare(got, _replay(case, pool)))


def test_reverse_mode_slices_sum_to_the_whole(case):
    scene, cam, cfg, key, params = case[:5]
    well = case[8]
    one = chip_smoke.reverse_mode(params, scene, cam, cfg, key,
                                  np.asarray(well), slices=1)
    assert one[2].shape == well.shape
    rel = chip_smoke.compare(one[:2], case[9])
    assert chip_smoke.within(*rel), rel


def test_wrong_first_hits_changes_exactly_n_first_hits():
    tape = np.array([[0, 1, -1, 2, 0], [1, -1, -1, 0, 2]], np.int32)
    bad = chip_smoke.wrong_first_hits(tape, 2, 3, seed=1)
    changed = np.nonzero((bad != tape).any(0))[0]
    assert changed.size == 2 and (tape[0, changed] >= 0).all()
    assert (bad[1] == tape[1]).all() and (bad[0] >= 0).sum() == 4


@pytest.mark.parametrize("a,b,want", [
    ({"x": np.ones(3)}, {"x": np.ones(3)}, 0.0),
    ({"x": np.zeros(2)}, {"x": np.zeros(2)}, 0.0),
    ({"x": np.array([1.0, 0.0])}, {"x": np.zeros(2)}, float("inf")),
    ({"x": np.array([3.0, 4.0])}, {"x": np.array([0.0, 5.0])},
     np.sqrt(10.0) / 5.0),
])
def test_rel_diff(a, b, want):
    assert chip_smoke.rel_diff(a, b)["x"] == pytest.approx(want)
