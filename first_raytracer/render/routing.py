"""Which tracer renders a scene, and which recorder records its tape.

Rendering.  Two paths trace on the card: the path-tracing kernel
(kernels/megakernel.py), whose closest-hit loop visits every primitive,
and the plain XLA regenerative pool (render/regenerative.py) walking a BVH
(accel/traverse.py), whose cost grows with the tree's depth.  Frame times
of 800x450 @ 4spp fields on an H100 (tools/kernel_vs_plain.py --only
large; PERF.md, Findings) put the crossovers between 50,004 and 100,004
spheres and between 10,003 and 20,003 triangles.  ``KERNEL_MAX_COST`` is
the largest sphere count measured faster on the kernel, and a triangle
weighs ``TRIANGLE_WEIGHT`` spheres so that the triangle bound falls on the
largest triangle count measured faster on the kernel.

Recording.  The kernel records one contiguous range of ray ids.  Against
the XLA pool recorder (diff/replay.record_paths_pool, dense sweep) it
recorded 2^17-ray tapes faster on every triangle field measured (2,003 to
80,003 triangles) and on sphere fields up to 5,004 spheres, and slower
from 10,004 spheres on (tools/kernel_vs_plain.py --only record_scale).
"""
from __future__ import annotations

import numpy as np

__all__ = ["sweep_cost", "use_kernel", "plain_accel", "kernel_records",
           "KERNEL_MAX_COST", "TRIANGLE_WEIGHT", "RECORD_MAX_SPHERES"]

KERNEL_MAX_COST = 50_004
TRIANGLE_WEIGHT = 5
RECORD_MAX_SPHERES = 5_004


def sweep_cost(scene) -> int:
    """A scene's primitive count with triangles weighted by
    ``TRIANGLE_WEIGHT``."""
    return scene.num_spheres + TRIANGLE_WEIGHT * scene.num_triangles


def use_kernel(scene) -> bool:
    """True when the path-tracing kernel is the faster tracer for ``scene``;
    otherwise render with ``mode="regenerative"`` and ``plain_accel``."""
    return sweep_cost(scene) <= KERNEL_MAX_COST


def plain_accel(scene):
    """The accel structure of the plain path for scenes past the kernel's
    bound: a BVH."""
    from ..accel.build import build_bvh
    return build_bvh(scene, max_leaf=4)


def kernel_records(scene, ray_ids) -> bool:
    """True when the kernel, not the pool recorder, records the tape of
    ``ray_ids`` in ``scene``: one contiguous, increasing id range in a
    scene of at most ``RECORD_MAX_SPHERES`` spheres."""
    ids = np.asarray(ray_ids)
    contiguous = ids.size == 0 or bool((np.diff(ids) == 1).all())
    return contiguous and scene.num_spheres <= RECORD_MAX_SPHERES
