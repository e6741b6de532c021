"""spira_tpu — a differentiable spectral path tracer in JAX.

Built from scratch in JAX/Pallas/pjit with the capabilities of the SPIRA
Julia/Metal renderer (jenkinsm13/julia-spira); see SURVEY.md for the
structural analysis of the reference and BASELINE.md for targets.

Public API mirrors the reference package exports
(`/root/reference/src/SPIRA.jl:10-13`: Scene, Camera, Material, Sphere, Ray,
render, create_scene, render_hybrid_gpu, render_with_cpu) in SoA/pytree form.
"""

from .accel.bvh import FlatBVH, build_bvh_for_triangles, build_two_level
from .core import rng, vecmath
from .render import (
    render,
    render_flat,
    render_hdr,
    render_hybrid_gpu,
    render_with_cpu,
)
from .scene.obj import cube, icosphere, load_obj_mesh, parse_obj
from .scene.camera import Camera, default_camera, generate_rays, make_camera
from .scene.geometry import (
    Spheres,
    Triangles,
    make_spheres,
    make_triangles,
)
from .scene.materials import Materials, make_materials
from .scene.scene import (
    Scene,
    cornell_camera,
    create_cornell_box,
    create_mesh_scene,
    create_scene,
    make_scene,
)

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "FlatBVH",
    "build_bvh_for_triangles",
    "build_two_level",
    "cube",
    "icosphere",
    "load_obj_mesh",
    "parse_obj",
    "Materials",
    "Scene",
    "Spheres",
    "Triangles",
    "cornell_camera",
    "create_cornell_box",
    "create_mesh_scene",
    "create_scene",
    "default_camera",
    "generate_rays",
    "make_camera",
    "make_materials",
    "make_scene",
    "make_spheres",
    "make_triangles",
    "render",
    "render_hybrid_gpu",
    "render_with_cpu",
    "render_flat",
    "render_hdr",
    "rng",
    "vecmath",
]
