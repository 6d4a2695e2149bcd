"""Profiling/metrics harness (SURVEY.md §5.1): timing, throughput units,
and jax.profiler trace capture actually producing a trace artifact."""
import glob
import os

import jax.numpy as jnp
import numpy as np

from first_raytracer.utils.profiling import (Timer, throughput, time_fn,
                                             trace_to)


def test_timer_and_time_fn():
    t = Timer()
    with t.section("a"):
        pass
    with t.section("a"):
        pass
    assert t.times["a"] >= 0
    secs = time_fn(lambda x: x * 2, jnp.ones((8,)), warmup=1, repeats=2)
    assert secs > 0


def test_throughput_units():
    out = throughput(2_000_000, 5_000_000, 2.0)
    assert out["mpaths_per_s"] == 1.0
    assert out["mrays_per_s"] == 2.5
    assert out["avg_path_length"] == 2.5


def test_trace_to_writes_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace_to(logdir):
        np.asarray(jnp.arange(128) * 3)
    found = glob.glob(os.path.join(logdir, "**", "*.trace.json.gz"),
                      recursive=True) + glob.glob(
        os.path.join(logdir, "**", "*.xplane.pb"), recursive=True)
    assert found, f"no trace artifact under {logdir}"


def test_trace_to_none_is_noop():
    with trace_to(None):
        pass
