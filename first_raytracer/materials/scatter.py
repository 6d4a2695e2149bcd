"""Masked vectorized material scatter.

Data-parallel counterpart of the reference's virtual
``material::scatter(ray_in, rec, attenuation&, scattered&)`` dispatch into
lambertian / metal / dielectric [E: material.h] (SURVEY.md §2.1, §3.2).
All three materials are evaluated branch-free on every lane and the result is
selected by the per-hit material type id — 3 materials x cheap math makes
masked execution far cheaper than any routing (SURVEY.md §2.2 "EP" row).

Semantics preserved exactly (and mirrored by the oracle):

- lambertian: ``target = p + N + ball();`` scatter direction ``target - p``;
  attenuation = texture value; always scatters.
- metal: ``reflect(unit(d), N) + fuzz * ball()``; absorbed (path killed) when
  the scattered direction leaves below the surface (``dot(dir, N) <= 0``).
- dielectric: Snell refraction with TIR check, Schlick reflectance with the
  reference's ``cosine = ref_idx * dot(d, N)`` outside-branch formula
  (the book's canonical form, kept for parity), stochastic reflect/refract
  choice on the 4th uniform; attenuation = (1,1,1).

Deviation shared with the oracle: scattered directions are normalized (the
reference leaves them unnormalized; only the t-parametrization differs).

Differentiability: with the uniforms held fixed (counter RNG), attenuation and
scatter directions are smooth in albedo/fuzz/ref_idx and in the hit geometry,
which is what the reparameterized-gradient pass differentiates
(BASELINE.json:11, SURVEY.md §7 step 6).  The reflect/refract coin is a
discrete choice; gradients flow through the chosen branch.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.rng import unit_ball_sample
from ..core.vecmath import dot, normalize, reflect, refract, schlick
from ..scene.soa import MAT_DIELECTRIC, MAT_METAL
from ..scene.textures import texture_value

__all__ = ["scatter", "scatter_from_params"]

_NORM_EPS = 1e-20


def scatter(scene, mat_id, direction, hit_p, hit_n, uniforms):
    """Scatter R rays at their hit points.

    Args:
      scene: Scene SoA.
      mat_id: (R,) i32 material id at each hit.
      direction: (R, 3) unit incoming directions.
      hit_p, hit_n: (R, 3) hit point and outward geometric normal.
      uniforms: (R, 4) this bounce's random draws
        (ball sample u1 u2 u3, dielectric coin u4).

    Returns:
      new_dir: (R, 3) unit scattered direction.
      attenuation: (R, 3) throughput multiplier.
      scattered_ok: (R,) bool — False where the path is absorbed
        (the reference's ``scatter() == false`` metal case).
    """
    return scatter_from_params(
        scene.mat_type[mat_id], scene.fuzz[mat_id], scene.ref_idx[mat_id],
        texture_value(scene, mat_id, hit_p), direction, hit_p, hit_n,
        uniforms)


def scatter_from_params(mtype, fuzz, ref_idx, tex, direction, hit_p, hit_n,
                        uniforms):
    """``scatter`` with per-ray material parameters given explicitly.

    Identical math with the (R,)-shaped material rows pre-gathered — the
    entry point for callers that extract the winner's parameters by other
    means than table gathers (the replay path's one-hot matmul payload
    extraction, diff/replay.py).
    """

    ball = unit_ball_sample(uniforms[:, 0], uniforms[:, 1], uniforms[:, 2])
    coin = uniforms[:, 3]

    # --- lambertian [E: material.h lambertian::scatter] ---
    lam_dir = normalize(hit_n + ball, eps=_NORM_EPS)

    # --- metal [E: material.h metal::scatter] ---
    reflected = reflect(direction, hit_n)
    metal_raw = reflected + fuzz[:, None] * ball
    metal_ok = dot(metal_raw, hit_n) > 0.0
    metal_dir = normalize(metal_raw, eps=_NORM_EPS)

    # --- dielectric [E: material.h dielectric::scatter] ---
    d_dot_n = dot(direction, hit_n)
    outside = d_dot_n > 0.0  # ray travelling along the normal => exiting
    outward_n = jnp.where(outside[:, None], -hit_n, hit_n)
    ni_over_nt = jnp.where(outside, ref_idx, 1.0 / ref_idx)
    # Reference's exact cosine formula (|d| = 1 here).
    cosine = jnp.where(outside, ref_idx * d_dot_n, -d_dot_n)
    refracted, can_refract = refract(direction, outward_n, ni_over_nt)
    reflect_prob = jnp.where(can_refract, schlick(cosine, ref_idx), 1.0)
    use_reflect = coin < reflect_prob
    diel_dir = jnp.where(
        use_reflect[:, None],
        normalize(reflected, eps=_NORM_EPS),
        normalize(refracted, eps=_NORM_EPS),
    )

    # --- masked select (replaces virtual dispatch) ---
    is_metal = mtype == MAT_METAL
    is_diel = mtype == MAT_DIELECTRIC
    new_dir = jnp.where(
        is_diel[:, None], diel_dir,
        jnp.where(is_metal[:, None], metal_dir, lam_dir),
    )
    attenuation = jnp.where(is_diel[:, None], 1.0, tex)
    scattered_ok = jnp.where(is_metal, metal_ok, True)
    return new_dir, attenuation, scattered_ok
