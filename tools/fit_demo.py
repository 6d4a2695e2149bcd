#!/usr/bin/env python
"""Inverse-rendering demo figure: target / perturbed / recovered.

Perturbs the diffuse and metal spheres' albedos in the three-spheres
scene, recovers them with projected Adam on a pixel MSE
(diff/grad.make_fit_step), and writes a side-by-side PNG for the README.
(Fuzz/IOR gradients are validated against finite differences in
tests/test_grad.py; albedo makes the clearest visual demo.)
Runs on any backend (CPU fine: small resolution, wavefront path).

Usage: python tools/fit_demo.py [--out docs/images/fit-demo.png]
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from first_raytracer.core import rng  # noqa: E402
from first_raytracer.diff.grad import (make_fit_step, merge_params,  # noqa: E402
                                       ray_radiance, split_params)
from first_raytracer.render.api import render_image  # noqa: E402
from first_raytracer.render.image import to_uint8, write_png  # noqa: E402
from first_raytracer.scene.builders import PRESETS  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="docs/images/fit-demo.png")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=0.03)
    args = ap.parse_args()

    # Optimization problem: low-res, few-sample, shallow — gradients only
    # need to rank parameter directions, not converge the image.
    scene, cam, cfg = PRESETS["three-spheres"](nx=48, ny=24, spp=4)
    fit_cfg = dataclasses.replace(cfg, max_depth=6)
    fields = ("albedo",)
    key = rng.base_key(0)
    ids = jnp.arange(fit_cfg.num_rays, dtype=jnp.int32)

    true_params, _ = split_params(scene, fields=fields)
    target_rad = ray_radiance(true_params, scene, cam, fit_cfg, key, ids)

    albedo = np.asarray(true_params["albedo"]).copy()
    albedo[1] = [0.75, 0.2, 0.6]   # center diffuse sphere: wrong color
    albedo[2] = [0.2, 0.3, 0.9]    # metal sphere: wrong tint
    params = {"albedo": jnp.asarray(albedo)}
    params0 = params

    opt = optax.adam(args.lr)
    state = opt.init(params)
    step = make_fit_step(scene, cam, fit_cfg, ids, target_rad, opt)
    for i in range(args.steps):
        loss, params, state = step(params, state, key)
        # Projected Adam: keep parameters in their physical range.
        params = {"albedo": jnp.clip(params["albedo"], 0.0, 1.0)}
        if i % 25 == 0 or i == args.steps - 1:
            err = {f: float(jnp.max(jnp.abs(params[f] - true_params[f])))
                   for f in fields}
            print(f"step {i:4d}  loss {float(loss):.3e}  max-err {err}",
                  flush=True)

    # Display renders: higher quality, full depth.
    view_cfg = dataclasses.replace(cfg, nx=240, ny=120, spp=32)
    panels = []
    for p in (true_params, params0, params):
        img = render_image(merge_params(scene, p), cam, view_cfg, seed=0)
        panels.append(to_uint8(np.asarray(img)))
    sep = np.full((view_cfg.ny, 2, 3), 255, np.uint8)
    strip = np.concatenate(
        [panels[0], sep, panels[1], sep, panels[2]], axis=1)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_png(args.out, strip.astype(np.float32) / 255.0, gamma=False)
    print(f"wrote {args.out} (target | perturbed | recovered)")


if __name__ == "__main__":
    main()
