"""bench.py result-integrity guards and device rules.

A timing is only a measurement when the run really executed on the device:
these tests pin the guards that make an impossible result fail loudly, the
peak table the plausibility guard reads, and the refusal to time anything
but a GPU.
"""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402

H100 = bench.peak_for("NVIDIA H100 80GB HBM3")["fp32_flops"]


def test_spread_guard_accepts_stable_timings():
    assert bench.check_spread([0.250, 0.252, 0.255]) is None


def test_spread_guard_rejects_wild_disagreement():
    # One 1.6 ms outlier among 250 ms runs: a call that returned without
    # doing the work.
    assert bench.check_spread([0.0016, 0.250, 0.252]) is not None


def test_flops_guard_accepts_real_rate():
    # 24.7M segments over 488 spheres in 37.7 ms => ~3.2e12 implied
    # FLOP/s, under the H100's FP32 peak.
    assert bench.check_flops(24_700_000, 488, 0.0377, H100) is None


def test_flops_guard_rejects_impossible_rate():
    # The same segments in 0.16 ms would imply ~7.5e14 FLOP/s.
    err = bench.check_flops(24_700_000, 488, 0.00016, H100)
    assert err is not None and "impossible" in err


def test_flops_guard_ignores_zero_segments():
    # Modes that don't count segments must not trip the guard.
    assert bench.check_flops(0, 512, 0.001, H100) is None


def test_checksum_guard():
    assert bench.check_checksum(100.0, 100.4) is None  # ulp-drift scale
    assert bench.check_checksum(0.0, 100.0) is not None  # no-op execution
    assert bench.check_checksum(57.0, 100.0) is not None  # wrong image


def test_peak_table_rows_name_their_source():
    row = bench.peak_for("NVIDIA H100 80GB HBM3")
    assert row["fp32_flops"] == 67e12 and row["hbm_bytes_s"] == 3.35e12
    assert all("source" in r for r in bench.PEAKS.values())


def test_peak_table_unknown_device_is_an_error():
    with pytest.raises(ValueError, match="no peak rates"):
        bench.peak_for("cpu")


def test_golden_keys_name_the_scene_and_size():
    from first_raytracer.scene.builders import random_scene
    import json

    key = bench.golden_key("", random_scene()[2])
    assert key == "radiance_sum_final_1200x800_10spp"
    with open(bench.GOLDEN) as f:
        assert key in json.load(f)


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_refuses_a_cpu_device(script):
    """On a machine without a GPU both scripts exit non-zero and print no
    result line."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "Mpaths/s" not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied without the rest of the repository, chip_smoke.py fails."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ""}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
