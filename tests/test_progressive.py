"""Checkpoint/resume tests (SURVEY.md §5.4): progressive accumulation equals
one-shot rendering; a killed-and-resumed render is bit-identical."""
import dataclasses

import numpy as np

from first_raytracer.render.api import render_image
from first_raytracer.render.progressive import (ProgressiveState,
                                                progressive_render)
from first_raytracer.scene.builders import three_spheres


def test_progressive_matches_oneshot(tiny_three_spheres):
    scene, cam, cfg = tiny_three_spheres
    a = np.asarray(render_image(scene, cam, cfg, seed=0))
    b = progressive_render(scene, cam, cfg, seed=0, samples_per_batch=1)
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_resume_after_kill(tmp_path, tiny_three_spheres):
    scene, cam, cfg = tiny_three_spheres
    ckpt = str(tmp_path / "render.ckpt.npz")

    # Simulate preemption after the first sample batch.
    class Stop(Exception):
        pass

    def killer(state):
        if state.samples_done == 1:
            state.save(ckpt)
            raise Stop

    try:
        progressive_render(scene, cam, cfg, seed=0, checkpoint_path=ckpt,
                           samples_per_batch=1, on_batch=killer)
        raise AssertionError("expected simulated preemption")
    except Stop:
        pass

    st = ProgressiveState.load(ckpt)
    assert st.samples_done == 1

    resumed = progressive_render(scene, cam, cfg, seed=0,
                                 checkpoint_path=ckpt, samples_per_batch=1)
    full = progressive_render(scene, cam, cfg, seed=0, samples_per_batch=1)
    np.testing.assert_array_equal(resumed, full)


def test_checkpoint_rejects_wrong_seed(tmp_path, tiny_three_spheres):
    scene, cam, cfg = tiny_three_spheres
    ckpt = str(tmp_path / "s.ckpt.npz")
    ProgressiveState.fresh(cfg, seed=3).save(ckpt)
    try:
        progressive_render(scene, cam, cfg, seed=4, checkpoint_path=ckpt)
        raise AssertionError("expected seed mismatch error")
    except ValueError:
        pass


def test_progressive_megakernel_matches_wavefront(tmp_path):
    """mode='mega' batches (the path-tracing kernel, interpreted) == plain
    progressive render, including a mid-run kill/resume."""
    import dataclasses

    from first_raytracer.render import progressive as prog
    from first_raytracer.kernels import megakernel as mk
    from first_raytracer.scene.builders import three_spheres

    # interpret mode for the CPU suite
    orig = mk._launch_jit
    try:
        mk._launch_jit = lambda *a, **kw: orig(*a, **{**kw, "interpret": True})
        scene, cam, cfg = three_spheres(nx=16, ny=8, spp=4)
        ref = prog.progressive_render(scene, cam, cfg, seed=0,
                                      samples_per_batch=2)
        ck = str(tmp_path / "mega.npz")
        seen = []

        class Stop(Exception):
            pass

        def kill_after_one(state):
            seen.append(state.samples_done)
            if len(seen) == 1:
                state.save(ck)
                raise Stop

        try:
            prog.progressive_render(scene, cam, cfg, seed=0,
                                    samples_per_batch=2, mode="mega",
                                    checkpoint_path=ck,
                                    on_batch=kill_after_one)
        except Stop:
            pass
        img = prog.progressive_render(scene, cam, cfg, seed=0,
                                      samples_per_batch=2, mode="mega",
                                      checkpoint_path=ck)
        d = np.abs(np.asarray(ref) - np.asarray(img))
        assert (d > 1e-3).mean() < 0.01
        assert np.median(d) < 1e-5
    finally:
        mk._launch_jit = orig


def test_orbax_checkpoint_backend(tmp_path):
    """Non-.npz checkpoint paths use the orbax PyTree backend; resume is
    bit-identical to the npz path (SURVEY.md §5.4 "save with orbax/npz")."""
    from first_raytracer.render.progressive import (ProgressiveState,
                                                    progressive_render)
    from first_raytracer.scene.builders import PRESETS

    scene, cam, cfg = PRESETS["three-spheres"](nx=24, ny=12, spp=4)
    ck = str(tmp_path / "ckpt_orbax")

    class Stop(Exception):
        pass

    def killer(state):
        if state.samples_done == 2:
            state.save(ck)
            raise Stop

    try:
        progressive_render(scene, cam, cfg, seed=3, checkpoint_path=ck,
                           samples_per_batch=1, on_batch=killer)
        raise AssertionError("expected simulated preemption")
    except Stop:
        pass
    st = ProgressiveState.load(ck)
    assert st.samples_done == 2 and st.seed == 3
    img = progressive_render(scene, cam, cfg, seed=3, checkpoint_path=ck,
                             samples_per_batch=1)
    ref = progressive_render(scene, cam, cfg, seed=3, samples_per_batch=1)
    np.testing.assert_array_equal(np.asarray(img), np.asarray(ref))
