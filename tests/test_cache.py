"""The persistent compilation cache's location rule (utils/cache.py)."""
import os
import subprocess
import sys

from first_raytracer.utils.cache import cache_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_follows_the_environment():
    assert cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/y"}) == "/x/y"


def test_cache_dir_defaults_to_fixed_checkout_path():
    assert cache_dir({}) == os.path.join(ROOT, ".jax_cache")


def _configured_dir(cache_env):
    """The cache directory a fresh process configures, with
    ``JAX_COMPILATION_CACHE_DIR`` set to ``cache_env`` (None: unset)."""
    code = ("import jax\n"
            "from first_raytracer.utils.cache import "
            "enable_persistent_cache\n"
            "enable_persistent_cache()\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if cache_env is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = cache_env
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return out.stdout.strip().splitlines()[-1]


def test_enable_keeps_the_environment_directory(tmp_path):
    assert _configured_dir(str(tmp_path)) == str(tmp_path)


def test_enable_without_environment_uses_checkout_path():
    assert _configured_dir(None) == os.path.join(ROOT, ".jax_cache")
