"""Test configuration.

The suite runs on the CPU backend with 8 virtual devices (SURVEY.md §4.5:
the standard JAX fake-multidevice fixture), so sharding and collective code
paths run without several cards, and the Pallas kernel runs in interpret
mode.

Tests that need the GPU carry the ``chip`` marker and the ``gpu`` fixture:
they skip here and run on the card (``FRT_TESTS_ON_CHIP=1 python -m pytest
-m chip tests/``, which chip_smoke.py also runs).  With
``FRT_TESTS_ON_CHIP`` set the default backend is left alone.
"""
import os

if not os.environ.get("FRT_TESTS_ON_CHIP"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("FRT_TESTS_ON_CHIP"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a GPU; skips elsewhere (decided in the "
        "gpu fixture)")


@pytest.fixture
def gpu():
    """The first device if it is a GPU, else skip (decided at run time)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU, found {dev.platform}")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled executables after each test module.

    The suite compiles hundreds of programs (including the large
    interpret-mode kernel while-loops); keeping them all loaded grew the
    process until the XLA:CPU compiler itself segfaulted near the end of
    the run.  Recompiles are cheap via the persistent disk cache.
    """
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def tiny_three_spheres():
    from first_raytracer.scene.builders import three_spheres
    return three_spheres(nx=24, ny=12, spp=2)


@pytest.fixture(scope="session")
def rng_key():
    from first_raytracer.core import rng
    return rng.base_key(0)


def rays_for(cfg):
    import jax.numpy as jnp
    return jnp.arange(cfg.num_rays, dtype=jnp.int32)


@pytest.fixture(scope="session")
def random_rays():
    """Deterministic random ray bundle for geometry tests."""
    r = np.random.RandomState(0)
    o = r.randn(256, 3).astype(np.float32) * 2.0
    d = r.randn(256, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d
