"""Differentiable rendering: losses, gradients, and inverse-rendering steps.

The reference has no gradients at all (SURVEY.md §3.5); this module is the
north-star's differentiable pass [BASELINE.json:5, :11]: pixel-radiance
gradients w.r.t. material albedo/fuzz/IOR and sphere centers/radii via
reparameterized sampling — the counter RNG holds every uniform fixed, so the
rendered radiance is a (piecewise) smooth function of the scene parameters
and ``jax.grad`` differentiates it.  Two equivalent implementations:
``method="replay"`` (default) records the primitive tape outside the AD
graph and differentiates the cheap O(R) replay (diff/replay.py — the fast
path, ~2 orders over direct); ``method="scan"`` is direct reverse mode
through the scan-form wavefront loop (the equivalence oracle).

Scope (SURVEY.md §7 step 6): gradients flow through the hit equation
(recompute-from-primitive-id), scatter directions, Schlick/texture/
throughput math.  NOT differentiated: primitive *selection* (BVH traversal
under stop_gradient) and the discrete reflect/refract coin — i.e. visibility
silhouettes are treated as static, the standard reparameterization trade-off,
validated against finite differences away from silhouettes
(tests/test_grad.py).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng
from ..render.camera import generate_rays
from ..render.integrator import RenderConfig, trace_rays

__all__ = ["DIFF_FIELDS", "split_params", "merge_params", "ray_radiance",
           "render_loss", "render_loss_and_grads",
           "render_loss_and_grads_tape", "render_loss_and_grads_bucketed",
           "sgd_step", "make_fit_step", "make_fit_step_replay"]

# The differentiable parameter set named by the north-star [BASELINE.json:5]:
# material albedo/fuzz/IOR + sphere centers/radii (+ checker secondary color
# and triangle vertices, which fall out for free).
DIFF_FIELDS = ("sphere_center", "sphere_radius", "albedo", "albedo2",
               "fuzz", "ref_idx", "tri_v0", "tri_v1", "tri_v2")


def split_params(scene, fields=DIFF_FIELDS):
    """Scene -> (params dict, scene); params are the differentiable leaves."""
    return {f: getattr(scene, f) for f in fields}, scene


def merge_params(scene, params):
    return dataclasses.replace(scene, **params)


def _diff_cfg(cfg: RenderConfig) -> RenderConfig:
    return dataclasses.replace(cfg, differentiable=True)


def ray_radiance(params, scene, camera, cfg: RenderConfig, key, ray_ids,
                 accel=None, intersect_fn: Optional[Callable] = None,
                 method: str = "replay", record_pool: int = 0):
    """(R, 3) radiance as a differentiable function of ``params``.

    ``method="replay"`` (default, fast): record the primitive tape with the
    requested intersector outside the AD graph, then differentiate the O(R)
    tape replay (diff/replay.py) — bit-identical values and gradients to
    ``method="scan"`` (round 2's direct reverse-mode through the monolithic
    wavefront scan, kept as the equivalence oracle; tests/test_replay.py).
    """
    scene = merge_params(scene, params)
    cam_u = rng.camera_uniforms(key, ray_ids)
    o, d = generate_rays(camera, cfg.nx, cfg.ny, cfg.spp, ray_ids, cam_u)
    if method == "replay":
        from .replay import record_paths, record_paths_pool, trace_rays_replay
        sg = jax.lax.stop_gradient
        if record_pool:
            tape = record_paths_pool(sg(scene), camera, cfg, key, ray_ids,
                                     accel=accel, intersect_fn=intersect_fn,
                                     pool_size=record_pool)
        else:
            tape = record_paths(sg(scene), o, d, ray_ids, key, cfg,
                                accel=accel, intersect_fn=intersect_fn)
        return trace_rays_replay(scene, o, d, ray_ids, key, cfg, tape)
    if method != "scan":
        raise ValueError(f"unknown method {method!r}")
    return trace_rays(scene, o, d, ray_ids, key, _diff_cfg(cfg),
                      accel=accel, intersect_fn=intersect_fn)


def render_loss(params, scene, camera, cfg, key, ray_ids, target,
                accel=None, intersect_fn=None, method: str = "replay",
                record_pool: int = 0):
    """Mean squared error between rendered per-ray radiance and ``target``."""
    rad = ray_radiance(params, scene, camera, cfg, key, ray_ids, accel,
                       intersect_fn, method=method, record_pool=record_pool)
    return jnp.mean((rad - target) ** 2)


@partial(jax.jit, static_argnames=("cfg", "intersect_fn", "method",
                                   "record_pool"))
def render_loss_and_grads(params, scene, camera, cfg, key, ray_ids, target,
                          accel=None, intersect_fn=None,
                          method: str = "replay", record_pool: int = 0):
    """(loss, grads-dict) — the driver's gradient gate [BASELINE.json:2]."""
    return jax.value_and_grad(render_loss)(
        params, scene, camera, cfg, key, ray_ids, target,
        accel=accel, intersect_fn=intersect_fn, method=method,
        record_pool=record_pool)


@partial(jax.jit, static_argnames=("cfg",))
def render_loss_and_grads_tape(params, scene, camera, cfg, key, ray_ids,
                               target, tape):
    """(loss, grads) for a pre-recorded (possibly ``live_trips``-trimmed)
    primitive tape — the two-step fast path: record once with any
    intersector (diff/replay.py), trim the all-dead rows on the host, then
    differentiate only the replay."""
    def loss(params):
        s = merge_params(scene, params)
        cam_u = rng.camera_uniforms(key, ray_ids)
        o, d = generate_rays(camera, cfg.nx, cfg.ny, cfg.spp, ray_ids, cam_u)
        from .replay import trace_rays_replay
        rad = trace_rays_replay(s, o, d, ray_ids, key, cfg, tape)
        return jnp.mean((rad - target) ** 2)

    return jax.value_and_grad(loss)(params)


@partial(jax.jit, static_argnames=("cfg", "groups"))
def _loss_grads_planned(params, scene, camera, cfg, key, ray_ids, target,
                        tape, order, groups):
    """value+grad of the bucketed replay loss, as ONE XLA program.

    The depth-sort permutation and the static group slicing happen inside
    the jit, so the whole step is one program launch.  ``groups`` is the
    static
    ((start, size, trips), ...) plan; jit re-traces once per bucket-shape
    combination, which ``plan_buckets`` bounds by rounding trips to
    powers of two."""
    ids_s = jnp.asarray(ray_ids)[order]
    target_s = jnp.asarray(target)[order]
    tape_s = tape[:, order]

    def loss(params):
        s = merge_params(scene, params)
        from .replay import trace_rays_replay
        total = jnp.float32(0.0)
        for g0, n, trips in groups:
            ids_g = ids_s[g0:g0 + n]
            cam_u = rng.camera_uniforms(key, ids_g)
            o, d = generate_rays(camera, cfg.nx, cfg.ny, cfg.spp, ids_g,
                                 cam_u)
            rad = trace_rays_replay(s, o, d, ids_g, key, cfg,
                                    tape_s[:trips, g0:g0 + n])
            total = total + jnp.sum((rad - target_s[g0:g0 + n]) ** 2)
        return total / jnp.float32(target.shape[0] * target.shape[1])

    return jax.value_and_grad(loss)(params)


def render_loss_and_grads_bucketed(params, scene, camera, cfg, key,
                                   ray_ids, target, tape, plan=None,
                                   max_groups: int = 4):
    """(loss, grads) replaying depth-sorted ray buckets (diff/replay.py
    ``plan_buckets``): each bucket runs only its own trip count, cutting
    replay work to ~R x mean path length instead of R x deepest path.
    Loss and gradients equal ``render_loss_and_grads_tape`` on the full
    tape up to f32 summation order (tests/test_replay_planned.py).

    ``plan`` (from ``plan_buckets(tape, max_groups)``) may be passed in
    so repeated calls on the same tape skip the host-side sort.
    """
    from .replay import plan_buckets
    if plan is None:
        plan = plan_buckets(tape, max_groups)
    order, groups = plan
    return _loss_grads_planned(params, scene, camera, cfg, key, ray_ids,
                               target, tape, order, groups)


@partial(jax.jit, static_argnames=("cfg", "intersect_fn", "lr"))
def sgd_step(params, scene, camera, cfg, key, ray_ids, target,
             lr: float = 0.05, accel=None, intersect_fn=None):
    """One inverse-rendering SGD step; returns (loss, new_params)."""
    loss, grads = jax.value_and_grad(render_loss)(
        params, scene, camera, cfg, key, ray_ids, target,
        accel=accel, intersect_fn=intersect_fn)
    new_params = jax.tree_util.tree_map(lambda p, g: p - lr * g, params,
                                        grads)
    return loss, new_params


def make_fit_step_replay(scene, camera, cfg, ray_ids, target, optimizer,
                         max_groups: int = 4, interpret: bool = False):
    """Inverse-rendering step on the fast record->replay path.

    Per step: record the primitive tape of the CURRENT scene, plan depth
    buckets on the host, and differentiate only the bucketed replay.  The
    recorder is the path-tracing kernel (kernels/megakernel.py) or the XLA
    pool recorder (diff/replay.record_paths_pool) with the dense sweep, as
    ``render.routing.kernel_records`` picks from the ids and the scene;
    both stay exact as geometry parameters move.

    Returns ``step(params, opt_state, key) -> (loss, params, opt_state)``.
    """
    import optax

    from ..kernels.megakernel import pack_scene_mega, record_paths_mega
    from ..render.routing import kernel_records
    from .replay import record_paths_pool

    ids_np = np.asarray(ray_ids)
    ray0 = int(ids_np[0]) if len(ids_np) else 0
    kernel = kernel_records(scene, ids_np)
    record_pool = jax.jit(record_paths_pool,
                          static_argnames=("cfg", "pool_size"))

    def step(params, opt_state, key):
        s = merge_params(scene, params)
        if kernel:
            tape = record_paths_mega(pack_scene_mega(s), camera, cfg, key,
                                     ray0=ray0, num_rays=len(ids_np),
                                     interpret=interpret)
        else:
            tape = record_pool(s, camera, cfg, key, ray_ids,
                               pool_size=min(1 << 14, len(ids_np)))
        loss, grads = render_loss_and_grads_bucketed(
            params, scene, camera, cfg, key, ray_ids, target, tape,
            max_groups=max_groups)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return loss, optax.apply_updates(params, updates), opt_state

    return step


def make_fit_step(scene, camera, cfg, ray_ids, target, optimizer,
                  accel=None, intersect_fn=None):
    """Jitted inverse-rendering step around any optax GradientTransformation.

    Returns ``step(params, opt_state, key) -> (loss, params, opt_state)``.
    The plain ``sgd_step`` above needs no state; this is the stateful
    generalization (Adam & friends) used by ``cli fit --opt``.
    """
    import optax

    @jax.jit
    def step(params, opt_state, key):
        loss, grads = jax.value_and_grad(render_loss)(
            params, scene, camera, cfg, key, ray_ids, target,
            accel=accel, intersect_fn=intersect_fn)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return loss, optax.apply_updates(params, updates), opt_state

    return step
