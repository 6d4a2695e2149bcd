"""tools/kernel_vs_plain.py: its HLO reading and its refusal of a CPU."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import kernel_vs_plain as tool  # noqa: E402

R, NP = 96, 40


def _hlo(fn):
    o = jnp.ones((R, 3), jnp.float32)
    c = jnp.ones((NP, 3), jnp.float32)
    return jax.jit(fn).lower(o, c).compile().as_text()


def _dist(o, c):
    return jnp.sum((o[:, None, :] - c[None, :, :]) ** 2, axis=-1)


def test_matrix_inside_a_fusion_is_not_materialized():
    text = "\n".join([
        "%fused_min (p0: f32[96,3]) -> f32[96] {",
        "  %d = f32[96,40]{1,0} subtract(%a, %b)",
        "  ROOT %m = f32[96]{0} reduce(%d, %z), dimensions={1}",
        "}",
        "ENTRY %main (p0: f32[96,3]) -> f32[96] {",
        "  ROOT %f = f32[96]{0} fusion(%p0), kind=kInput, calls=%fused_min",
        "}",
    ])
    out = tool.materialized(text, R, NP)
    assert out["materialized"] == 0 and out["fusions_holding_matrix"] == 1


def test_returned_matrix_is_materialized():
    out = tool.materialized(_hlo(_dist), R, NP)
    assert out["materialized"] >= 1, out


def test_reads_tuple_results_and_fused_bodies():
    text = "\n".join([
        "%fused_sweep (p0: f32[96,3]) -> (f32[96], s32[96]) {",
        "  %d = f32[96,40]{1,0} multiply(%a, %b)",
        "  ROOT %t = (f32[96]{0}, s32[96]{0}) tuple(%m, %i)",
        "}",
        "ENTRY %main (p0: f32[96,3]) -> f32[96] {",
        "  %f = (f32[96]{0}, s32[96]{0}) fusion(%p0), kind=kInput, "
        "calls=%fused_sweep",
        "  %g = (f32[96,40]{1,0}, s32[96]{0}) custom-call(%p0)",
        "}",
    ])
    out = tool.materialized(text, R, NP)
    assert out["materialized"] == 1
    assert "custom-call" in out["materialized_lines"][0]
    assert out["fusions_holding_matrix"] == 1


@pytest.mark.parametrize("only", [["forward"], ["hlo", "large"]])
def test_timed_sections_refuse_a_cpu(only):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "tools/kernel_vs_plain.py",
                          "--only", *only], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"section"' not in out.stdout


def test_repeats_below_three_are_refused():
    with pytest.raises(SystemExit):
        tool.main(["--repeats", "2"])
