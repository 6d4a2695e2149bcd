"""Native C++ BVH builder: bit-equality with the NumPy builder and
traversal correctness (SURVEY.md §2 native-component mandate)."""
import subprocess

import numpy as np
import pytest

from first_raytracer.accel import native
from first_raytracer.accel.build import build_bvh
from first_raytracer.scene.builders import random_scene, triangle_scene
from first_raytracer.scene.soa import SceneBuilder


@pytest.fixture(scope="module", autouse=True)
def built_lib():
    if not native.available():
        subprocess.run(["make", "-C", "native"], check=True,
                       cwd=native.lib_path().rsplit("/native/", 1)[0])
        native._TRIED = False  # re-probe
    assert native.available()


def _scene(n, seed):
    r = np.random.RandomState(seed)
    b = SceneBuilder()
    m = b.lambertian((0.5, 0.5, 0.5))
    for _ in range(n):
        b.sphere(r.randn(3) * 4, 0.2 + r.rand(), m)
    return b.build()


@pytest.mark.parametrize("n,seed,sah", [(1, 0, True), (5, 1, True),
                                        (64, 2, True), (64, 2, False),
                                        (500, 3, True)])
def test_native_matches_numpy(n, seed, sah):
    scene = _scene(n, seed)
    a = build_bvh(scene, max_leaf=4, use_sah=sah, backend="numpy")
    b = build_bvh(scene, max_leaf=4, use_sah=sah, backend="native")
    for field in ("node_min", "node_max", "node_first", "node_count",
                  "node_skip", "prim_ids"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, field)), np.asarray(getattr(b, field)),
            err_msg=field)


def test_native_matches_numpy_presets():
    for preset in (random_scene, triangle_scene):
        scene = preset()[0]
        a = build_bvh(scene, max_leaf=4, backend="numpy")
        b = build_bvh(scene, max_leaf=4, backend="native")
        for field in ("node_min", "node_max", "node_first", "node_count",
                      "node_skip", "prim_ids"):
            np.testing.assert_array_equal(
                np.asarray(getattr(a, field)),
                np.asarray(getattr(b, field)), err_msg=field)


class TestNativeOracle:
    """C++ oracle (native/frt_oracle.cpp) vs NumPy oracle vs the device wavefront:
    three independent implementations of the reference semantics agree."""

    def _skip_if_missing(self):
        from first_raytracer.oracle import native_oracle
        import pytest
        if not native_oracle.available():
            pytest.skip("libfrt_native.so not built")

    def test_matches_numpy_oracle(self):
        self._skip_if_missing()
        import numpy as np
        from first_raytracer.oracle.cpu_oracle import render_oracle
        from first_raytracer.oracle.native_oracle import (
            render_oracle_native)
        from first_raytracer.scene.builders import (camera_showcase,
                                                    three_spheres,
                                                    triangle_scene)

        for preset in (three_spheres, triangle_scene, camera_showcase):
            scene, cam, cfg = preset(nx=24, ny=12, spp=2)
            a = render_oracle(scene, cam, cfg)
            b = render_oracle_native(scene, cam, cfg)
            # Same op order in f32; only libm transcendental ulps differ.
            np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)

    def test_matches_device_wavefront(self):
        self._skip_if_missing()
        import numpy as np
        from first_raytracer.oracle.native_oracle import (
            render_oracle_native)
        from first_raytracer.render.api import render_image
        from first_raytracer.scene.builders import three_spheres

        scene, cam, cfg = three_spheres(nx=24, ny=12, spp=2)
        a = render_oracle_native(scene, cam, cfg)
        b = np.asarray(render_image(scene, cam, cfg))
        d = np.abs(a - b)
        assert (d > 1e-3).mean() < 0.01
        assert np.median(d) < 1e-5
