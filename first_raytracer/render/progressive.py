"""Progressive rendering with checkpoint/resume (SURVEY.md §5.3/§5.4).

The reference streams the image to stdout; a killed run is lost.  Here the
complete resumable state is tiny and explicit — accumulated per-pixel
radiance sums, the per-pixel sample count, the seed, and the next sample
index — because the counter RNG makes sample ``s`` of pixel ``p``
reproducible in isolation.  Preemption recovery is therefore just
"continue the sample loop"; a corrupt/partial tile could be re-rendered by
id range (deterministic tile-based recovery).

Checkpoints are plain ``.npz`` (dependency-free, inspectable) or, for
API parity with large-scale training stacks, an orbax PyTree directory —
pick by path: ``*.npz`` -> npz, anything else -> orbax.  Cadence is every
``checkpoint_every`` sample-batches; both backends write atomically (npz
via rename, orbax natively).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

from ..core import rng
from .api import render_ray_batch
from .integrator import RenderConfig

__all__ = ["ProgressiveState", "progressive_render"]


@dataclasses.dataclass
class ProgressiveState:
    """Resumable accumulator."""

    radiance_sum: np.ndarray  # (npix, 3) f64 accumulation
    samples_done: int         # samples per pixel completed
    seed: int

    def image(self, cfg: RenderConfig):
        img = (self.radiance_sum / max(self.samples_done, 1)).astype(
            np.float32)
        return img.reshape(cfg.ny, cfg.nx, 3)[::-1]

    def save(self, path):
        if not str(path).endswith(".npz"):
            self._save_orbax(path)
            return
        tmp = f"{path}.tmp.npz"
        with open(tmp, "wb") as f:
            np.savez(f, radiance_sum=self.radiance_sum,
                     samples_done=self.samples_done, seed=self.seed)
        os.replace(tmp, path)  # atomic: a preempted save never corrupts

    @classmethod
    def load(cls, path):
        if not str(path).endswith(".npz"):
            return cls._load_orbax(path)
        z = np.load(path)
        return cls(radiance_sum=z["radiance_sum"],
                   samples_done=int(z["samples_done"]),
                   seed=int(z["seed"]))

    def _save_orbax(self, path):
        import orbax.checkpoint as ocp

        with ocp.PyTreeCheckpointer() as ckptr:
            ckptr.save(os.path.abspath(path),
                       {"radiance_sum": self.radiance_sum,
                        "samples_done": np.int64(self.samples_done),
                        "seed": np.int64(self.seed)},
                       force=True)

    @classmethod
    def _load_orbax(cls, path):
        import orbax.checkpoint as ocp

        with ocp.PyTreeCheckpointer() as ckptr:
            t = ckptr.restore(os.path.abspath(path))
        return cls(radiance_sum=np.asarray(t["radiance_sum"]),
                   samples_done=int(t["samples_done"]),
                   seed=int(t["seed"]))

    @classmethod
    def fresh(cls, cfg: RenderConfig, seed: int):
        return cls(radiance_sum=np.zeros((cfg.num_pixels, 3), np.float64),
                   samples_done=0, seed=seed)


def progressive_render(scene, camera, cfg: RenderConfig, seed: int = 0,
                       accel=None, checkpoint_path: Optional[str] = None,
                       checkpoint_every: int = 4,
                       samples_per_batch: int = 1,
                       on_batch: Optional[Callable] = None,
                       mode: str = "wavefront"):
    """Render ``cfg.spp`` samples in resumable batches.

    Returns the final (ny, nx, 3) image.  If ``checkpoint_path`` exists the
    render resumes from it; the finished result is bit-identical to a
    non-progressive render with the same seed (same ray ids, same keys).

    ``mode="mega"`` runs each batch on the path-tracing kernel
    (kernels/megakernel.py) — the sample offset is a traced scalar, so
    every batch reuses one compilation.
    """
    if checkpoint_path and os.path.exists(checkpoint_path):
        state = ProgressiveState.load(checkpoint_path)
        if state.seed != seed:
            raise ValueError(
                f"checkpoint seed {state.seed} != requested {seed}")
    else:
        state = ProgressiveState.fresh(cfg, seed)

    key = rng.base_key(seed)
    npix = cfg.num_pixels
    batches_done = 0
    if mode == "mega":
        from ..kernels.megakernel import pack_scene_mega, render_pixels_mega
        pack = pack_scene_mega(scene)
    while state.samples_done < cfg.spp:
        n_s = min(samples_per_batch, cfg.spp - state.samples_done)
        if mode == "mega":
            cfg_b = dataclasses.replace(cfg, spp=n_s)
            rad_sum, _ = render_pixels_mega(
                pack, camera, cfg_b, key, spp0=state.samples_done,
                spp_total=cfg.spp)
            state.radiance_sum += np.asarray(rad_sum, np.float64)
        else:
            # Global ray ids for samples [done, done + n_s) of every pixel.
            pix = np.arange(npix, dtype=np.int64)[:, None]
            smp = np.arange(state.samples_done,
                            state.samples_done + n_s)[None, :]
            ids = jnp.asarray((pix * cfg.spp + smp).reshape(-1), jnp.int32)
            rad = np.asarray(render_ray_batch(scene, camera, cfg, key, ids,
                                              accel))
            state.radiance_sum += rad.reshape(npix, n_s, 3).sum(axis=1)
        state.samples_done += n_s
        batches_done += 1
        if on_batch is not None:
            on_batch(state)
        if checkpoint_path and (batches_done % checkpoint_every == 0
                                or state.samples_done >= cfg.spp):
            state.save(checkpoint_path)
    return state.image(cfg)
