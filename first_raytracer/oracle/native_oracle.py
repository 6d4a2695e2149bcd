"""ctypes binding to the native (C++) oracle renderer.

A second, independent implementation of the reference semantics in the
reference's own language (native/frt_oracle.cpp) — the recursive
``color()`` [E: main.cpp] with the linear ``hitable_list`` scan and
per-material scatter — consuming the identical counter-RNG stream as
core/rng.py.  Tests triangulate: C++ oracle == NumPy oracle == device paths
(SURVEY.md §4.1), to libm-ulp tolerance.

Loads ``native/libfrt_native.so`` (``make -C native``); ``available()``
is False when the .so is missing and callers fall back to the NumPy
oracle.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from ..accel.native import lib_path
from ..core import rng

__all__ = ["available", "render_oracle_native"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    import os
    path = lib_path()
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    if not hasattr(lib, "frt_render_oracle"):  # stale .so
        return None
    lib.frt_render_oracle.restype = None
    lib.frt_render_oracle.argtypes = [
        _F32P, _F32P, _I32P, ctypes.c_int64,                 # spheres
        _F32P, _F32P, _F32P, _I32P, ctypes.c_int64,          # triangles
        _I32P, _I32P, _F32P, _F32P, _F32P, _F32P, _F32P,     # materials
        _F32P,                                               # camera(19)
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,      # nx ny spp
        ctypes.c_int32, ctypes.c_float,                      # depth t_min
        ctypes.c_uint32, ctypes.c_uint32,                    # key
        _I64P, ctypes.c_int64, _F32P,                        # rays, out
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _f32(a):
    return np.ascontiguousarray(np.asarray(a), np.float32)


def _i32(a):
    return np.ascontiguousarray(np.asarray(a), np.int32)


def render_oracle_native(scene, camera, cfg, seed: int = 0, ray_ids=None):
    """Drop-in for oracle.cpu_oracle.render_oracle, running the C++ oracle.

    Returns (ny, nx, 3) f32 top-down image, or (R, 3) per-ray radiance when
    ``ray_ids`` is given.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("libfrt_native.so not built (make -C native)")
    s = scene.as_numpy()
    full_image = ray_ids is None
    if full_image:
        ray_ids = np.arange(cfg.num_rays, dtype=np.int64)
    ray_ids = np.ascontiguousarray(np.asarray(ray_ids), np.int64)

    cam = np.concatenate([
        _f32(camera.origin).reshape(3), _f32(camera.lower_left).reshape(3),
        _f32(camera.horizontal).reshape(3), _f32(camera.vertical).reshape(3),
        _f32(camera.u).reshape(3), _f32(camera.v).reshape(3),
        _f32(camera.lens_radius).reshape(1)])
    key = np.asarray(rng.base_key(seed), np.uint32)

    sph_c = _f32(s.sphere_center)
    sph_r = _f32(s.sphere_radius)
    sph_m = _i32(s.sphere_mat)
    t0, t1, t2 = _f32(s.tri_v0), _f32(s.tri_v1), _f32(s.tri_v2)
    tri_m = _i32(s.tri_mat)
    m_ty, tx_ty = _i32(s.mat_type), _i32(s.tex_type)
    alb, alb2 = _f32(s.albedo), _f32(s.albedo2)
    tsc, fz, ri = _f32(s.tex_scale), _f32(s.fuzz), _f32(s.ref_idx)
    out = np.zeros((len(ray_ids), 3), np.float32)

    def fp(a):
        return a.ctypes.data_as(_F32P)

    def ip(a):
        return a.ctypes.data_as(_I32P)

    lib.frt_render_oracle(
        fp(sph_c), fp(sph_r), ip(sph_m), len(sph_r),
        fp(t0), fp(t1), fp(t2), ip(tri_m), len(tri_m),
        ip(m_ty), ip(tx_ty), fp(alb), fp(alb2), fp(tsc), fp(fz), fp(ri),
        fp(cam), cfg.nx, cfg.ny, cfg.spp, cfg.max_depth,
        float(cfg.t_min), int(key[0]), int(key[1]),
        ray_ids.ctypes.data_as(_I64P), len(ray_ids), fp(out))

    if full_image:
        img = out.reshape(cfg.ny, cfg.nx, cfg.spp, 3).mean(axis=2)
        return img[::-1].astype(np.float32)
    return out
