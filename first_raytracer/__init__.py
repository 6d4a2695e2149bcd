"""A differentiable path tracer in JAX.

Brand-new framework with the capabilities of the reference
``jammm/first_raytracer`` (a C++ *Ray Tracing in One Weekend*-lineage
renderer; see SURVEY.md), re-architected for data-parallel accelerators:
wavefront integrator, a path-tracing GPU kernel, flattened BVH,
counter-based RNG, masked material dispatch, and mesh-sharded multi-device
rendering with end-to-end gradients.
"""
from .render.api import render_image, render_ray_batch
from .render.camera import Camera, make_camera
from .render.integrator import RenderConfig
from .scene.builders import PRESETS, build_preset
from .scene.soa import Scene, SceneBuilder

__version__ = "0.4.0"

__all__ = [
    "Camera", "make_camera", "RenderConfig", "Scene", "SceneBuilder",
    "PRESETS", "build_preset", "render_image", "render_ray_batch",
    "__version__",
]
