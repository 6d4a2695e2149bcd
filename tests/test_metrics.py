"""Observability metrics (SURVEY.md §5.5): wavefront occupancy / bounce
histogram accounting and the path-tracing kernel's lane occupancy, plus structured
logging."""
import logging

import numpy as np

from first_raytracer.scene.builders import PRESETS
from first_raytracer.utils.metrics import (log_metrics,
                                           megakernel_occupancy,
                                           wavefront_occupancy)


def _tiny():
    return PRESETS["three-spheres"](nx=24, ny=12, spp=2)


def test_wavefront_occupancy_accounting():
    scene, cam, cfg = _tiny()
    out = wavefront_occupancy(scene, cam, cfg, seed=0)
    counts = np.asarray(out["alive_per_bounce"])
    hist = np.asarray(out["bounce_histogram"])
    # Monotone alive counts; every launched path terminates somewhere.
    assert (np.diff(counts) <= 0).all()
    assert counts[0] == out["rays"]
    assert hist.sum() == out["rays"]
    assert out["avg_path_length"] >= 1.0
    assert 0.0 < out["wavefront_efficiency"] <= 1.0


def test_megakernel_occupancy_consistent_with_wavefront():
    scene, cam, cfg = _tiny()
    wf = wavefront_occupancy(scene, cam, cfg, seed=0,
                             num_rays=cfg.num_rays)
    mk = megakernel_occupancy(scene, cam, cfg, seed=0, block=32,
                              interpret=True)
    # Same RNG stream => identical total traced segments per path.
    assert abs(mk["mean_path_len"] - wf["avg_path_length"]) < 1e-3
    assert 0.0 < mk["lane_occupancy"] <= 1.0


def test_log_metrics_emits_json(caplog):
    with caplog.at_level(logging.INFO, logger="first_raytracer"):
        log_metrics("tag", {"a": 1})
    assert any("tag" in r.getMessage() and '"a": 1' in r.getMessage()
               for r in caplog.records)
