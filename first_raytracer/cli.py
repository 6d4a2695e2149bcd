"""Command-line driver (SURVEY.md §5.6).

The reference hardcodes ``nx/ny/ns`` and the scene choice in ``main.cpp``;
here every driver workload [BASELINE.json:7-11] is a named preset with
overridable flags.

Examples:
    python -m first_raytracer.cli render --preset three-spheres \
        --out out/three.png
    python -m first_raytracer.cli render --preset random-spheres \
        --spp 10 --out out/final.ppm --checkpoint out/final.ckpt.npz
    python -m first_raytracer.cli bench --preset random-spheres --bvh
    python -m first_raytracer.cli fit --fields albedo,fuzz \
        --checkpoint out/fit.npz
    python -m first_raytracer.cli occupancy --preset random-spheres --bvh
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def _build(args):
    from .accel.build import build_bvh
    from .scene.builders import build_preset

    kwargs = {}
    if args.nx:
        kwargs["nx"] = args.nx
    if args.ny:
        kwargs["ny"] = args.ny
    if args.spp:
        kwargs["spp"] = args.spp
    scene, camera, cfg = build_preset(args.preset, **kwargs)
    if args.max_depth:
        cfg = dataclasses.replace(cfg, max_depth=args.max_depth)
    accel = build_bvh(scene, max_leaf=4) if args.bvh else None
    return scene, camera, cfg, accel


def _cmd_render(args):
    from .render.image import write_png, write_ppm
    from .render.progressive import progressive_render
    from .render.api import render_image

    scene, camera, cfg, accel = _build(args)
    mode = args.mode
    if mode == "auto":
        # The kernel or the plain regenerative pool with a BVH, from the
        # scene's primitive count and type (render/routing.py).
        from .render.routing import plain_accel, use_kernel
        if use_kernel(scene):
            mode = "mega"
        else:
            mode = "regenerative"
            if accel is None:
                accel = plain_accel(scene)
    t0 = time.perf_counter()
    if args.checkpoint:
        on_batch = None
        if args.preview:
            # Observability (SURVEY.md §5.5): running-mean preview image
            # after every batch, from the progressive accumulator state.
            os.makedirs(os.path.dirname(args.preview) or ".", exist_ok=True)

            def on_batch(state):
                write_png(args.preview, state.image(cfg))
                print(f"preview @ {state.samples_done}/{cfg.spp} spp "
                      f"-> {args.preview}", file=sys.stderr)
        img = progressive_render(scene, camera, cfg, seed=args.seed,
                                 accel=accel,
                                 checkpoint_path=args.checkpoint,
                                 samples_per_batch=args.batch_spp,
                                 on_batch=on_batch,
                                 mode="mega" if mode == "mega"
                                 else "wavefront")
    elif mode == "mega":
        from .kernels.megakernel import render_image_mega
        img = render_image_mega(scene, camera, cfg, seed=args.seed)
    elif mode == "ring":
        # Ring-sharded scene (parallel/ring.py): geometry partitioned over
        # all devices, shards ppermute'd each bounce.  Degenerate-but-valid
        # on one device; the scale-out path on several.
        from .parallel.mesh import make_render_mesh
        from .parallel.ring import render_image_ring
        img = render_image_ring(scene, camera, cfg,
                                make_render_mesh(num_spp_shards=1),
                                seed=args.seed)
    else:
        img = render_image(scene, camera, cfg, seed=args.seed, accel=accel,
                           mode=mode)
    dt = time.perf_counter() - t0
    out = args.out or f"{args.preset}.png"
    if out == "-":
        # Reference parity: PPM P3 streamed to stdout [E: main.cpp].
        write_ppm("-", img)
        return
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    if out.endswith(".ppm"):
        write_ppm(out, img)
    else:
        write_png(out, img)
    print(f"wrote {out} ({cfg.nx}x{cfg.ny} @ {cfg.spp}spp) in {dt:.2f}s")


def _cmd_bench(args):
    from .core import rng as _rng
    from .render.api import render_ray_batch
    from .utils.profiling import throughput, time_fn
    import jax.numpy as jnp

    scene, camera, cfg, accel = _build(args)
    key = _rng.base_key(args.seed)
    n = min(cfg.num_rays, args.rays or cfg.num_rays)
    ids = jnp.arange(n, dtype=jnp.int32)
    secs = time_fn(render_ray_batch, scene, camera, cfg, key, ids, accel)
    print(json.dumps(throughput(n, 0, secs)))


def _cmd_compare(args):
    """Quantified image diff (PPM/PNG/npz golden), for the pixel-allclose
    gate [BASELINE.json:2]: compare our render against another render or a
    reference binary's PPM output."""
    from .render.image import image_diff_stats, read_image

    stats = image_diff_stats(read_image(args.a), read_image(args.b))
    print(json.dumps(stats))
    if args.max_frac_gt_4 is not None:
        return 0 if stats["frac_pixels_gt_4"] <= args.max_frac_gt_4 else 1
    return 0


def _cmd_fit(args):
    """Inverse-rendering demo [BASELINE.json:11]: perturb scene parameters,
    recover them by SGD on a pixel loss; checkpoints learned params
    (SURVEY.md §5.4 "checkpoint learned params during gradient-descent
    demos")."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from .core import rng as _rng
    from .diff.grad import (make_fit_step, ray_radiance, split_params,
                            sgd_step)

    scene, camera, cfg, accel = _build(args)
    import dataclasses as _dc
    cfg = _dc.replace(cfg, max_depth=min(cfg.max_depth, 8),
                      differentiable=True)
    fields = tuple(f for f in args.fields.split(",") if f)
    key = _rng.base_key(args.seed)
    ids = jnp.arange(cfg.num_rays, dtype=jnp.int32)

    true_params, _ = split_params(scene, fields=fields)
    target = ray_radiance(true_params, scene, camera, cfg, key, ids, accel)

    r = np.random.RandomState(args.seed)
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(
            np.clip(np.asarray(p) * (0.6 + 0.3 * r.rand(*p.shape)), 0.02,
                    None), jnp.float32),
        true_params)

    if args.opt == "sgd":
        raw = jax.jit(lambda p, k: sgd_step(
            p, scene, camera, cfg, k, ids, target, lr=args.lr, accel=accel))
        opt_state = None

        def step(p, s, k):
            loss, p = raw(p, k)
            return loss, p, s
    else:
        import optax
        opt = {"adam": optax.adam, "adamw": optax.adamw,
               "rmsprop": optax.rmsprop}[args.opt](args.lr)
        opt_state = opt.init(params)
        if getattr(args, "fast", False):
            # Tape record + depth-bucketed replay per step
            # (diff/grad.make_fit_step_replay) — the production-throughput
            # differentiable path.
            from .diff.grad import make_fit_step_replay
            step = make_fit_step_replay(scene, camera, cfg, ids, target,
                                        opt)
        else:
            step = make_fit_step(scene, camera, cfg, ids, target, opt,
                                 accel=accel)
    for i in range(args.steps):
        loss, params, opt_state = step(params, opt_state, key)
        if i % args.log_every == 0 or i == args.steps - 1:
            err = jax.tree_util.tree_map(
                lambda a, b: float(jnp.max(jnp.abs(a - b))), params,
                true_params)
            print(json.dumps({"step": i, "loss": float(loss),
                              "max_param_err": err}))
        if args.checkpoint and (i % 20 == 0 or i == args.steps - 1):
            os.makedirs(os.path.dirname(args.checkpoint) or ".",
                        exist_ok=True)
            np.savez(args.checkpoint,
                     **{k: np.asarray(v) for k, v in params.items()})
    return 0


def _cmd_occupancy(args):
    from .utils.metrics import megakernel_occupancy, wavefront_occupancy

    scene, camera, cfg, accel = _build(args)
    out = wavefront_occupancy(scene, camera, cfg, seed=args.seed,
                              accel=accel)
    out["megakernel"] = megakernel_occupancy(scene, camera, cfg,
                                             seed=args.seed)
    print(json.dumps(out, indent=2))


def main(argv=None):
    from .utils.cache import enable_persistent_cache

    enable_persistent_cache()
    p = argparse.ArgumentParser(prog="first_raytracer")
    sub = p.add_subparsers(dest="cmd", required=True)
    cp = sub.add_parser("compare", help="quantified image diff "
                        "(ppm/png/npz); nonzero exit if above threshold")
    cp.set_defaults(fn=_cmd_compare)
    cp.add_argument("a")
    cp.add_argument("b")
    cp.add_argument("--max-frac-gt-4", type=float, default=None,
                    help="fail (exit 1) if more than this fraction of "
                         "pixels differ by >4/255 in any channel")
    for name, fn in [("render", _cmd_render), ("bench", _cmd_bench),
                     ("occupancy", _cmd_occupancy), ("fit", _cmd_fit)]:
        sp = sub.add_parser(name)
        sp.set_defaults(fn=fn)
        sp.add_argument("--preset", default="three-spheres")
        sp.add_argument("--nx", type=int, default=0)
        sp.add_argument("--ny", type=int, default=0)
        sp.add_argument("--spp", type=int, default=0)
        sp.add_argument("--max-depth", type=int, default=0)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--bvh", action="store_true",
                        help="walk a flat BVH (accel/traverse.py) in the "
                             "plain wavefront paths instead of the dense "
                             "sweep")
        if name == "render":
            sp.add_argument("--out", default="")
            sp.add_argument("--checkpoint", default="")
            sp.add_argument("--batch-spp", type=int, default=1)
            sp.add_argument("--preview", default="",
                            help="with --checkpoint: write a running-mean "
                                 "preview PNG after every batch")
            sp.add_argument(
                "--mode", default="auto",
                choices=("auto", "mega", "wavefront", "regenerative",
                         "ring"),
                help="auto: the path-tracing kernel or the plain "
                     "regenerative pool with a BVH, chosen from the "
                     "scene's primitive count "
                     "and type (render/routing.py); mega: the kernel; "
                     "wavefront/regenerative: XLA-orchestrated loops "
                     "(support --bvh); ring: scene geometry sharded over "
                     "all devices, ppermute ring")
        if name == "bench":
            sp.add_argument("--rays", type=int, default=0)
        if name == "fit":
            sp.add_argument("--fields", default="albedo")
            sp.add_argument("--opt", default="sgd",
                            choices=("sgd", "adam", "adamw", "rmsprop"),
                            help="optimizer: plain SGD or an optax "
                                 "transformation (diff.grad.make_fit_step)")
            sp.add_argument("--steps", type=int, default=60)
            sp.add_argument("--lr", type=float, default=0.8)
            sp.add_argument("--log-every", type=int, default=10)
            sp.add_argument("--fast", action="store_true",
                            help="record->replay gradients per step: "
                                 "tape recorder chosen by "
                                 "render/routing.py + depth-bucketed "
                                 "replay (optax optimizers only)")
            sp.add_argument("--checkpoint", default="")
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
