"""Scene representation: structure-of-arrays pytrees.

The reference builds a heap of polymorphic ``hitable*`` objects, each owning a
``material*`` [E: main.cpp random_scene(), hitable_list.h] (SURVEY.md §3.1).
On the device there is no virtual dispatch and no pointer graph: the scene is a flat
SoA — sphere centers/radii, triangle vertices, and a materials table — living
as replicated device arrays.  Primitives reference materials by integer id;
geometry references *nothing* by pointer.

Primitive ids are global: ``0 .. num_spheres-1`` are spheres,
``num_spheres .. num_spheres+num_triangles-1`` are triangles.  The BVH and the
integrator speak in these ids only.

``Scene`` is a registered pytree dataclass, so it can be passed through
``jit``/``grad`` directly — gradients w.r.t. ``sphere_center``,
``sphere_radius``, ``albedo``, ``fuzz``, ``ref_idx`` fall out of autodiff
(the differentiable pass of BASELINE.json:11).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["Scene", "MAT_LAMBERTIAN", "MAT_METAL", "MAT_DIELECTRIC",
           "TEX_CONSTANT", "TEX_CHECKER", "SceneBuilder"]

# Material type ids: masked vectorized branches replace the reference's
# virtual scatter() dispatch [E: material.h] (SURVEY.md §2.2 "EP" row).
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2

# Texture type ids [E: texture.h]: constant_texture / checker_texture.
TEX_CONSTANT = 0
TEX_CHECKER = 1


@jax.tree_util.register_dataclass
@dataclass
class Scene:
    """Flat SoA scene. All leaves are jnp arrays (a valid jit/grad input)."""

    # Spheres [E: sphere.h].  Negative radius is legal and means a flipped
    # normal (the reference's hollow-glass trick in the book's ch.13 scene).
    sphere_center: jax.Array  # (Ns, 3) f32
    sphere_radius: jax.Array  # (Ns,)   f32
    sphere_mat: jax.Array     # (Ns,)   i32 -> materials table row

    # Triangles [E: triangle.h / main.cpp custom extension, BASELINE.json:9].
    tri_v0: jax.Array  # (Nt, 3) f32
    tri_v1: jax.Array  # (Nt, 3) f32
    tri_v2: jax.Array  # (Nt, 3) f32
    tri_mat: jax.Array  # (Nt,)  i32

    # Materials table [E: material.h, texture.h].
    mat_type: jax.Array   # (Nm,) i32 in {MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC}
    tex_type: jax.Array   # (Nm,) i32 in {TEX_CONSTANT, TEX_CHECKER}
    albedo: jax.Array     # (Nm, 3) f32 — constant color / checker "even" color
    albedo2: jax.Array    # (Nm, 3) f32 — checker "odd" color (unused for constant)
    tex_scale: jax.Array  # (Nm,)  f32 — checker frequency (the book's 10.0)
    fuzz: jax.Array       # (Nm,)  f32 — metal fuzz radius
    ref_idx: jax.Array    # (Nm,)  f32 — dielectric refraction index

    @property
    def num_spheres(self) -> int:
        return self.sphere_center.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_primitives(self) -> int:
        return self.num_spheres + self.num_triangles

    @property
    def num_materials(self) -> int:
        return self.mat_type.shape[0]

    def prim_mat(self) -> jax.Array:
        """(Np,) material id per global primitive id."""
        return jnp.concatenate([self.sphere_mat, self.tri_mat])

    def as_numpy(self) -> "Scene":
        """Host copy for the NumPy oracle and the host-side BVH builder."""
        return dataclasses.replace(
            self, **{f.name: np.asarray(getattr(self, f.name))
                     for f in dataclasses.fields(self)}
        )


@dataclass
class SceneBuilder:
    """Imperative builder mirroring the reference's scene-construction style.

    ``random_scene()`` in the reference pushes ``new sphere(...)`` into a
    list [E: main.cpp]; here each ``add_*`` appends rows to Python lists and
    ``build()`` freezes them into the SoA ``Scene``.  Host-side only.
    """

    spheres: list = field(default_factory=list)      # (center, radius, mat_id)
    triangles: list = field(default_factory=list)    # (v0, v1, v2, mat_id)
    materials: list = field(default_factory=list)    # dict rows

    def _add_material(self, mat_type, tex_type=TEX_CONSTANT,
                      albedo=(0.0, 0.0, 0.0), albedo2=(0.0, 0.0, 0.0),
                      tex_scale=10.0, fuzz=0.0, ref_idx=1.0) -> int:
        self.materials.append(dict(
            mat_type=mat_type, tex_type=tex_type, albedo=tuple(albedo),
            albedo2=tuple(albedo2), tex_scale=tex_scale, fuzz=fuzz,
            ref_idx=ref_idx))
        return len(self.materials) - 1

    def lambertian(self, albedo) -> int:
        return self._add_material(MAT_LAMBERTIAN, albedo=albedo)

    def checker_lambertian(self, even, odd, scale=10.0) -> int:
        return self._add_material(MAT_LAMBERTIAN, tex_type=TEX_CHECKER,
                                  albedo=even, albedo2=odd, tex_scale=scale)

    def metal(self, albedo, fuzz=0.0) -> int:
        # The reference clamps fuzz to 1 in the metal constructor
        # [E: material.h metal::metal].
        return self._add_material(MAT_METAL, albedo=albedo,
                                  fuzz=min(float(fuzz), 1.0))

    def dielectric(self, ref_idx) -> int:
        return self._add_material(MAT_DIELECTRIC, ref_idx=float(ref_idx))

    def sphere(self, center, radius, mat_id: int) -> None:
        self.spheres.append((tuple(center), float(radius), int(mat_id)))

    def triangle(self, v0, v1, v2, mat_id: int) -> None:
        self.triangles.append((tuple(v0), tuple(v1), tuple(v2), int(mat_id)))

    def build(self) -> Scene:
        if not self.materials:
            raise ValueError("scene has no materials")
        f32 = jnp.float32
        i32 = jnp.int32
        ns = len(self.spheres)
        nt = len(self.triangles)
        return Scene(
            sphere_center=jnp.array(
                [s[0] for s in self.spheres], dtype=f32).reshape(ns, 3),
            sphere_radius=jnp.array([s[1] for s in self.spheres], dtype=f32),
            sphere_mat=jnp.array([s[2] for s in self.spheres], dtype=i32),
            tri_v0=jnp.array([t[0] for t in self.triangles], dtype=f32).reshape(nt, 3),
            tri_v1=jnp.array([t[1] for t in self.triangles], dtype=f32).reshape(nt, 3),
            tri_v2=jnp.array([t[2] for t in self.triangles], dtype=f32).reshape(nt, 3),
            tri_mat=jnp.array([t[3] for t in self.triangles], dtype=i32),
            mat_type=jnp.array([m["mat_type"] for m in self.materials], dtype=i32),
            tex_type=jnp.array([m["tex_type"] for m in self.materials], dtype=i32),
            albedo=jnp.array([m["albedo"] for m in self.materials], dtype=f32),
            albedo2=jnp.array([m["albedo2"] for m in self.materials], dtype=f32),
            tex_scale=jnp.array([m["tex_scale"] for m in self.materials], dtype=f32),
            fuzz=jnp.array([m["fuzz"] for m in self.materials], dtype=f32),
            ref_idx=jnp.array([m["ref_idx"] for m in self.materials], dtype=f32),
        )
