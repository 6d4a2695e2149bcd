"""Failure recovery (SURVEY.md §5.3): deterministic tile re-render.

The counter RNG keys every sample by global ray id, so any lost/corrupt
region of the output is recoverable by re-rendering exactly its id range
— no global state, no replay of the rest of the frame.  Checkpoint
corruption is detected at load time (fault injection below).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from first_raytracer.core import rng
from first_raytracer.render.api import render_image, render_ray_batch
from first_raytracer.scene.builders import three_spheres


def test_tile_rerender_is_deterministic():
    scene, cam, cfg = three_spheres(nx=24, ny=12, spp=2)
    key = rng.base_key(0)
    full = np.asarray(render_ray_batch(
        scene, cam, cfg, key, jnp.arange(cfg.num_rays, dtype=jnp.int32)))

    # "Lose" a tile: pixels 100..150 -> recover by id range only.
    lost_pix = np.arange(100, 150)
    lost_ids = (lost_pix[:, None] * cfg.spp
                + np.arange(cfg.spp)[None, :]).reshape(-1)
    patch = np.asarray(render_ray_batch(
        scene, cam, cfg, key, jnp.asarray(lost_ids, jnp.int32)))
    np.testing.assert_array_equal(full[lost_ids], patch)


def test_checkpoint_fault_injection(tmp_path):
    from first_raytracer.render.progressive import (ProgressiveState,
                                                    progressive_render)

    scene, cam, cfg = three_spheres(nx=8, ny=4, spp=2)
    ck = str(tmp_path / "state.npz")
    st = ProgressiveState.fresh(cfg, seed=0)
    st.save(ck)

    # Wrong-seed resume is refused (silent divergence would corrupt).
    with pytest.raises(ValueError):
        progressive_render(scene, cam, cfg, seed=1, checkpoint_path=ck)

    # Truncated/corrupt checkpoint is detected at load.
    with open(ck, "wb") as f:
        f.write(b"\x00" * 16)
    with pytest.raises(Exception):
        ProgressiveState.load(ck)
