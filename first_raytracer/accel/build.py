"""Host-side BVH construction -> flattened index arrays.

Data-parallel counterpart of the reference's ``bvh_node`` constructor
[E: bvh.h] (SURVEY.md §3.4): the pointer tree (``hitable *left, *right``)
becomes four flat i32/f32 arrays in depth-first *preorder* with skip links,
so traversal needs no stack at all (SURVEY.md §3.3 "stackless ... flattened
index arrays"):

- preorder: an inner node's left child is ``node + 1``;
- ``skip[node]``: the next preorder index after node's whole subtree — where
  to jump when the node's box is missed (or after a leaf is tested);
- leaves own up to ``max_leaf`` primitives, contiguous in the permuted
  ``prim_ids`` array.

Split policy: median split on the largest-extent centroid axis.  The
reference uses a *random* axis with a qsort median split; any split policy
yields identical closest hits, so we keep the deterministic, higher-quality
choice (and add SAH sweep as an option).  Build runs once on the host in
NumPy, exactly like the reference's host-side recursive build; an optional
C++ builder (native/) accelerates large scenes.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry.aabb import sphere_aabb_np, triangle_aabb_np

__all__ = ["FlatBVH", "build_bvh", "scene_prim_bounds"]


@jax.tree_util.register_dataclass
@dataclass
class FlatBVH:
    """Flattened BVH (a pytree of device arrays; replicated across the mesh
    per the north-star's 'BVH and scene SoA replicated' [BASELINE.json:5])."""

    node_min: jax.Array    # (N, 3) f32 box min
    node_max: jax.Array    # (N, 3) f32 box max
    node_first: jax.Array  # (N,) i32 — leaf: first slot in prim_ids; inner: 0
    node_count: jax.Array  # (N,) i32 — leaf: #prims (>0); inner: 0
    node_skip: jax.Array   # (N,) i32 — preorder index after this subtree
    prim_ids: jax.Array    # (Np,) i32 — permuted global primitive ids

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]

    @property
    def max_leaf(self) -> int:
        # Static python int (arrays are concrete on the host at build time).
        return int(np.max(np.asarray(self.node_count)))


def scene_prim_bounds(scene_np):
    """Per-primitive AABBs in global-id order (spheres then triangles)."""
    mins, maxs = [], []
    if scene_np.sphere_center.shape[0]:
        mn, mx = sphere_aabb_np(scene_np.sphere_center, scene_np.sphere_radius)
        mins.append(mn)
        maxs.append(mx)
    if scene_np.tri_v0.shape[0]:
        mn, mx = triangle_aabb_np(scene_np.tri_v0, scene_np.tri_v1,
                                  scene_np.tri_v2)
        mins.append(mn)
        maxs.append(mx)
    return np.concatenate(mins, 0), np.concatenate(maxs, 0)


def build_bvh(scene, max_leaf: int = 4, use_sah: bool = True,
              backend: str = "auto") -> FlatBVH:
    """Build the flat BVH for a Scene (host-side, runs once).

    backend: "numpy", "native" (C++ via ctypes, bit-identical output), or
    "auto" (native when the shared library is built, else numpy).
    """
    scene_np = scene.as_numpy()
    bmin, bmax = scene_prim_bounds(scene_np)
    n = bmin.shape[0]

    if backend not in ("auto", "numpy", "native"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend != "numpy":
        from . import native
        if native.available():
            (node_min, node_max, node_first, node_count, node_skip,
             prim_ids) = native.build_bvh_native_arrays(
                bmin, bmax, max_leaf, use_sah)
            return FlatBVH(
                node_min=jnp.asarray(node_min),
                node_max=jnp.asarray(node_max),
                node_first=jnp.asarray(node_first),
                node_count=jnp.asarray(node_count),
                node_skip=jnp.asarray(node_skip),
                prim_ids=jnp.asarray(prim_ids),
            )
        if backend == "native":
            raise RuntimeError("native builder requested but not built; "
                               "run `make -C native`")

    centroid = 0.5 * (bmin + bmax)

    # Recursive build into a temporary node list of
    # (box_min, box_max, leaf_ids | (left, right)) then preorder-flatten.
    class Node:
        __slots__ = ("mn", "mx", "ids", "left", "right", "_index", "_first")

    def make(ids):
        nd = Node()
        nd.mn = bmin[ids].min(axis=0)
        nd.mx = bmax[ids].max(axis=0)
        nd.ids = None
        nd.left = nd.right = None
        if len(ids) <= max_leaf:
            nd.ids = ids
            return nd
        ext = centroid[ids].max(axis=0) - centroid[ids].min(axis=0)
        axis = int(np.argmax(ext))
        order = ids[np.argsort(centroid[ids, axis], kind="stable")]
        split = _sah_split(order, axis) if use_sah else len(order) // 2
        split = min(max(split, 1), len(order) - 1)
        nd.left = make(order[:split])
        nd.right = make(order[split:])
        return nd

    def _sah_split(order, axis):
        """Sweep-SAH over the sorted order; O(k) with prefix boxes."""
        k = len(order)
        lmn = np.minimum.accumulate(bmin[order], axis=0)
        lmx = np.maximum.accumulate(bmax[order], axis=0)
        rmn = np.minimum.accumulate(bmin[order][::-1], axis=0)[::-1]
        rmx = np.maximum.accumulate(bmax[order][::-1], axis=0)[::-1]

        def area(mn, mx):
            e = np.maximum(mx - mn, 0.0)
            return e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]

        i = np.arange(1, k)
        cost = area(lmn, lmx)[:-1] * i + area(rmn, rmx)[1:] * (k - i)
        return int(np.argmin(cost)) + 1

    root = make(np.arange(n, dtype=np.int64))

    # Preorder flatten with skip links.
    nodes = []
    prim_perm = []

    def emit(nd):
        idx = len(nodes)
        nodes.append(nd)
        nd._index = idx  # type: ignore[attr-defined]
        if nd.ids is not None:
            nd._first = len(prim_perm)  # type: ignore[attr-defined]
            prim_perm.extend(nd.ids.tolist())
        else:
            emit(nd.left)
            emit(nd.right)

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n + 64))
    try:
        emit(root)

        n_nodes = len(nodes)
        node_min = np.stack([nd.mn for nd in nodes]).astype(np.float32)
        node_max = np.stack([nd.mx for nd in nodes]).astype(np.float32)
        node_first = np.zeros(n_nodes, np.int32)
        node_count = np.zeros(n_nodes, np.int32)
        node_skip = np.zeros(n_nodes, np.int32)

        def fill_skip(nd, skip):
            node_skip[nd._index] = skip
            if nd.ids is not None:
                node_first[nd._index] = nd._first
                node_count[nd._index] = len(nd.ids)
            else:
                fill_skip(nd.left, nd.right._index)
                fill_skip(nd.right, skip)

        fill_skip(root, n_nodes)
    finally:
        sys.setrecursionlimit(old_limit)

    return FlatBVH(
        node_min=jnp.asarray(node_min),
        node_max=jnp.asarray(node_max),
        node_first=jnp.asarray(node_first),
        node_count=jnp.asarray(node_count),
        node_skip=jnp.asarray(node_skip),
        prim_ids=jnp.asarray(np.asarray(prim_perm, np.int32)),
    )
