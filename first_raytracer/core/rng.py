"""Counter-based stateless RNG.

The reference uses the global, stateful ``drand48()`` scattered through
[E: main.cpp, material.h, camera.h] (SURVEY.md §2.1 "RNG").  A sequential
generator is meaningless for millions of parallel rays, so this design keys
every random draw by *what it is for*: a threefry key derived from
``(ray_id, domain)`` where ``ray_id = pixel_index * spp + sample_index`` and
``domain`` encodes camera-sampling vs. bounce number.  Consequences:

- The render is bit-deterministic for a given seed, independent of device
  count, ray buffer order, or stream compaction (sharding invariance).
- The NumPy CPU oracle (``first_raytracer.oracle``) draws the *identical*
  uniforms by calling these same functions, so per-pixel allclose against the
  oracle is achievable at low spp (SURVEY.md §4.1).

The reference's rejection-sampled ``random_in_unit_sphere()`` /
``random_in_unit_disk()`` are unbounded loops — hostile to fixed-trace XLA
programs — so both are replaced by bounded analytic transforms of fixed
numbers of uniforms that sample the *same distributions* (uniform in the unit
ball / unit disk).

Draw layout per ray (one ray = one (pixel, sample) pair):

- domain 0 (``DOMAIN_CAMERA``): 4 uniforms — pixel jitter (u, v) for
  anti-aliasing + lens disk (u1, u2) for defocus blur.
- domain 1 + d for bounce ``d``: 4 uniforms — unit-ball sample (u1, u2, u3)
  for lambertian/metal scatter + reflect/refract coin for dielectric.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "base_key",
    "ray_uniforms",
    "camera_uniforms",
    "bounce_uniforms",
    "unit_disk_sample",
    "unit_ball_sample",
    "precompute_uniforms",
]

DOMAIN_CAMERA = 0
_DRAWS_PER_DOMAIN = 4

# Threefry-2x32-20 rotation schedule (public Random123 constants).
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def base_key(seed: int):
    """Root key for a render: a (2,) uint32 key-data array.

    (A plain array rather than a typed jax.random key: the per-ray generator
    below is a direct vectorized Threefry-2x32-20 over (ray_id, domain)
    counters, so the path-tracing kernel can draw the same bits in
    registers; ``vmap(fold_in)`` chains per ray would not share that
    arithmetic.)
    """
    kd = jax.random.key_data(jax.random.key(seed))
    return jnp.asarray(kd, jnp.uint32)


def _threefry2x32(k0, k1, c0, c1):
    """Vectorized Threefry-2x32-20: (key0, key1, ctr0, ctr1) -> 2 words.

    All args uint32, broadcast together; pure VPU element-wise ops.
    """
    u32 = jnp.uint32
    ks0 = u32(k0)
    ks1 = u32(k1)
    ks2 = ks0 ^ ks1 ^ u32(_PARITY)
    x0 = c0 + ks0
    x1 = c1 + ks1

    def rotl(x, r):
        return (x << u32(r)) | (x >> u32(32 - r))

    ks = (ks0, ks1, ks2)
    for g in range(5):
        for j in range(4):
            x0 = x0 + x1
            x1 = rotl(x1, _ROTATIONS[(4 * g + j) % 8])
            x1 = x1 ^ x0
        x0 = x0 + ks[(g + 1) % 3]
        x1 = x1 + ks[(g + 2) % 3] + u32(g + 1)
    return x0, x1


def _bits_to_unit_float(bits):
    """uint32 -> f32 in [0, 1) using the top 24 bits."""
    return (bits >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(
        1.0 / (1 << 24))


def _uniforms(key, ray_ids, domains):
    """(..., 4) uniforms for broadcastable uint-convertible ids/domains."""
    ids = jnp.asarray(ray_ids).astype(jnp.uint32)
    dom = jnp.asarray(domains).astype(jnp.uint32)
    ids, dom = jnp.broadcast_arrays(ids, dom)
    a0, a1 = _threefry2x32(key[0], key[1], ids, dom * jnp.uint32(2))
    b0, b1 = _threefry2x32(key[0], key[1], ids,
                           dom * jnp.uint32(2) + jnp.uint32(1))
    return jnp.stack([_bits_to_unit_float(a0), _bits_to_unit_float(a1),
                      _bits_to_unit_float(b0), _bits_to_unit_float(b1)],
                     axis=-1)


def ray_uniforms(key, ray_id, domain):
    """4 uniforms in [0,1) for one ray and one domain (scalar ray_id)."""
    return _uniforms(key, ray_id, domain)


def camera_uniforms(key, ray_ids):
    """(R, 4) uniforms for AA jitter and lens sampling."""
    return _uniforms(key, ray_ids, DOMAIN_CAMERA)


def bounce_uniforms(key, ray_ids, depth):
    """(R, 4) uniforms for bounce ``depth`` (0-based)."""
    return _uniforms(key, ray_ids, jnp.asarray(depth) + 1)


def bounce_uniforms_var(key, ray_ids, depths):
    """(R, 4) uniforms with a *per-ray* bounce depth.

    Identical values to ``bounce_uniforms`` at matching (id, depth) — used by
    the regenerative (compacted-pool) integrator where rays in one batch sit
    at different depths.
    """
    return _uniforms(key, ray_ids, jnp.asarray(depths) + 1)


def unit_disk_sample(u1, u2):
    """Uniform point in the unit disk from two uniforms.

    Bounded replacement for the reference's rejection loop
    ``random_in_unit_disk()`` [E: camera.h]; identical distribution.
    Returns an (..., 2) array.
    """
    r = jnp.sqrt(u1)
    theta = (2.0 * jnp.pi) * u2
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


def unit_ball_sample(u1, u2, u3):
    """Uniform point in the unit ball from three uniforms.

    Bounded replacement for ``random_in_unit_sphere()`` [E: material.h];
    identical distribution (uniform direction x cbrt-radius).
    Returns an (..., 3) array.
    """
    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = (2.0 * jnp.pi) * u2
    radius = jnp.cbrt(u3)
    return radius[..., None] * jnp.stack(
        [r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1
    )


def precompute_uniforms(key, ray_ids, max_depth: int):
    """All uniforms a set of rays can ever consume, as one array.

    Shape ``(R, max_depth + 2, 4)``: slot 0 is the camera domain, slot 1+d is
    bounce ``d`` (the integrator probes depth 0..max_depth inclusive for the
    final miss-only pass).  The NumPy oracle uses this so its per-ray Python
    recursion never touches JAX; the device paths derive the same values lazily
    per bounce.  Both agree bit-for-bit by construction.
    """
    domains = jnp.arange(max_depth + 2)
    return _uniforms(key, jnp.asarray(ray_ids)[:, None], domains[None, :])
