"""Structured render metrics / observability (SURVEY.md §5.5).

The reference's only observability is the image on stdout.  Here a render
can report per-bounce wavefront occupancy — rays alive per bounce, the
compaction ratio, a bounce histogram — from one instrumented pass, logged
via the stdlib ``logging`` module (no external deps).
"""
from __future__ import annotations

import json
import logging
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng
from ..render.camera import generate_rays
from ..render.integrator import RenderConfig, default_intersect

logger = logging.getLogger("first_raytracer")

__all__ = ["wavefront_occupancy", "megakernel_occupancy", "log_metrics",
           "logger"]


@partial(jax.jit, static_argnames=("cfg",))
def _occupancy_scan(scene, camera, cfg, key, ray_ids, accel):
    """(max_depth+1,) alive-ray count per bounce (scan-form loop)."""
    cam_u = rng.camera_uniforms(key, ray_ids)
    o, d = generate_rays(camera, cfg.nx, cfg.ny, cfg.spp, ray_ids, cam_u)
    import dataclasses
    cfg_scan = dataclasses.replace(cfg, differentiable=True)

    # Re-run the bounce loop collecting the alive count at each depth.
    # (Separate instrumented pass: the hot path stays counter-free.)
    R = o.shape[0]
    from ..render.integrator import BIG, recompute_hit
    from ..materials.scatter import scatter

    def bounce(state, depth):
        origin, direction, alive = state
        prim, _, hit = default_intersect(scene, accel, origin, direction,
                                         cfg.t_min)
        t, p, n, mat = recompute_hit(scene, origin, direction, prim,
                                     cfg.t_min)
        hit = hit & (t < BIG)
        p = jnp.where(hit[:, None], p, 0.0)
        n = jnp.where(hit[:, None], n,
                      jnp.array([0.0, 0.0, 1.0], jnp.float32))
        uniforms = rng.bounce_uniforms(key, ray_ids, depth)
        new_dir, _, ok = scatter(scene, mat, direction, p, n, uniforms)
        cont = alive & hit & ok & (depth < cfg.max_depth)
        origin = jnp.where(cont[:, None], p, origin)
        direction = jnp.where(cont[:, None], new_dir, direction)
        return (origin, direction, cont), jnp.sum(alive.astype(jnp.int32))

    (_, _, _), alive_counts = jax.lax.scan(
        bounce, (o, d, jnp.ones((R,), bool)),
        jnp.arange(cfg.max_depth + 1))
    return alive_counts


def wavefront_occupancy(scene, camera, cfg: RenderConfig, seed: int = 0,
                        accel=None, num_rays: int = 1 << 14) -> dict:
    """Occupancy report for the first ``num_rays`` rays of a render."""
    key = rng.base_key(seed)
    ids = jnp.arange(min(num_rays, cfg.num_rays), dtype=jnp.int32)
    counts = np.asarray(_occupancy_scan(scene, camera, cfg, key, ids, accel))
    total = int(ids.shape[0])
    alive_frac = counts / total
    # Bounce histogram: paths terminating at each depth.
    terminated = -np.diff(np.append(counts, 0))
    return {
        "rays": total,
        "alive_per_bounce": counts.tolist(),
        "alive_frac_per_bounce": [round(float(x), 4) for x in alive_frac],
        "bounce_histogram": terminated.tolist(),
        "avg_path_length": float(counts.sum()) / total,
        "wavefront_efficiency": float(counts.sum())
        / (total * max(int(np.sum(counts > 0)), 1)),
    }


def log_metrics(tag: str, metrics: dict, level=logging.INFO):
    logger.log(level, "%s %s", tag, json.dumps(metrics))


def megakernel_occupancy(scene, camera, cfg: RenderConfig, seed: int = 0,
                         block: int = None, interpret: bool = False):
    """Lane occupancy of the path-tracing kernel (kernels/megakernel.py).

    Occupancy = traced segments / (bounce-loop trips x lanes): the fraction
    of lane-iterations doing useful work while each program waits for its
    slowest lane.
    """
    from ..kernels import megakernel as mk

    block = block or mk.BLOCK
    rad, seg, its = mk.render_pixels_mega(
        mk.pack_scene_mega(scene), camera, cfg, rng.base_key(seed),
        interpret=interpret, block=block, return_iters=True)
    segs = int(np.asarray(seg, np.int64).sum())
    trips = np.asarray(its, np.int64)
    slots = int(trips.sum()) * block
    return {
        "segments": segs,
        "mean_path_len": round(segs / cfg.num_rays, 3),
        "program_trips_mean": round(float(trips.mean()), 1),
        "program_trips_max": int(trips.max()),
        "lane_occupancy": round(segs / slots, 4) if slots else 0.0,
    }
