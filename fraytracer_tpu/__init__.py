"""fraytracer_tpu — a differentiable SDF renderer for the GPU.

A from-scratch JAX/XLA/Pallas framework replicating (and extending) the
capabilities of the F# CPU sphere-tracer FrayTracer
(https://github.com/JanWosnitza/FrayTracer, mounted read-only at
``/root/reference``): immutable composable SDF scene graphs with CSG,
sphere-traced rendering with Lambert shading and hard shadows, spectral
ray tests with dispersive materials and Fresnel secondary rays — plus what
the reference never had: exact AD normals, pixel gradients w.r.t. every
scene parameter, multi-device sharded rendering, and a Pallas march
kernel for the GPU.

Quick start::

    import fraytracer_tpu as ft

    s = ft.Scene(
        root=ft.sphere((0, 0, 0), 1.0, material=ft.solid(0.8, 0.2, 0.2)),
        background=(0.1, 0.1, 0.1),
        lights=(ft.directional_light((-0.5, -1, 1), (0.5, 0.5, 0.5)),),
    )
    camera = ft.look_at((0, 0, -10), (0, 0, 0), fov_degrees=60)
    img = ft.render(ft.flatten(s), camera, ft.RenderConfig(width=256, height=256))
"""

from .camera import Camera, camera_rays, look_at
from .ops.march import MarchConfig, march
from .ops.sdf import (material_at, prim_bounds, prim_distances, root_bound,
                      scene_distance, scene_normal)
from .ops.shade import surface_hit, trace
from .ops.tonemap import tonemap
from .render import (RenderConfig, render, render_image, render_rays,
                     render_scene, render_with_stats)
from .scene.flatten import FlatScene, flatten
from .scene.nodes import (Light, Material, Scene, SdfNode, box, capsule, cone,
                          dielectric, directional_light, emissive, intersect,
                          mirror, plane, point_light, procedural,
                          smooth_union, solid, sphere, subtract, torus,
                          triangle, union)
from .types import MarchResult, Rays, SurfaceHit, make_rays

__version__ = "0.1.0"

__all__ = [
    "Camera", "camera_rays", "look_at",
    "MarchConfig", "march",
    "material_at", "prim_bounds", "prim_distances", "root_bound",
    "scene_distance", "scene_normal",
    "surface_hit", "trace", "tonemap",
    "RenderConfig", "render", "render_image", "render_rays", "render_scene",
    "render_with_stats",
    "FlatScene", "flatten",
    "Light", "Material", "Scene", "SdfNode", "box", "capsule", "cone",
    "dielectric", "directional_light", "emissive", "intersect", "mirror",
    "plane", "point_light", "procedural", "smooth_union", "solid",
    "sphere", "subtract",
    "torus", "triangle", "union",
    "MarchResult", "Rays", "SurfaceHit", "make_rays",
]
