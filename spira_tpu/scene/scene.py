"""Scene pytree and built-in scene builders.

The Scene *is* the device representation (SoA pytrees) — contrast with the
reference which keeps `Scene(spheres, materials)` structs
(`/root/reference/src/spira-metal-optimized.jl:351-354`) and flattens them per
render (`prepare_scene_data` `:515-542`).
"""

from __future__ import annotations

from typing import Any, Optional

import jax.numpy as jnp

from ..core.types import pytree_dataclass, replace
from .geometry import (
    Spheres,
    Triangles,
    empty_spheres,
    empty_triangles,
    make_spheres,
)
from .materials import Materials, make_materials


@pytree_dataclass
class Scene:
    """spheres + triangle soup + materials (+ optional BVH, attached later).

    ``bvh`` is ``None`` for brute-force intersection, or a
    :class:`spira_tpu.accel.bvh.FlatBVH` pytree for accelerated traversal.
    """

    spheres: Spheres
    triangles: Triangles
    materials: Materials
    bvh: Optional[Any] = None
    # Pair-record tables for the Pallas packet-traversal megakernel
    # (`spira_tpu.accel.pairs.PackedBVH`); attach with
    # `spira_tpu.accel.pairs.attach_packed`.
    packed: Optional[Any] = None
    # 16-wide node tables (`spira_tpu.accel.wide.WideBVH`); attach with
    # `spira_tpu.accel.wide.attach_wide`.
    wide: Optional[Any] = None

    def with_bvh(self, bvh) -> "Scene":
        return replace(self, bvh=bvh)


def make_scene(
    spheres=None, triangles=None, materials=None, bvh=None, packed=None,
    wide=None,
) -> Scene:
    return Scene(
        spheres=spheres if spheres is not None else empty_spheres(),
        triangles=triangles if triangles is not None else empty_triangles(),
        materials=materials,
        bvh=bvh,
        packed=packed,
        wide=wide,
    )


def create_scene() -> Scene:
    """The reference default demo scene, reproduced exactly.

    Materials and spheres from `create_scene` at
    `/root/reference/src/spira-metal-optimized.jl:429-510` (indices converted
    to 0-based): diffuse red, grey ground, mirror metal, glass-like metal 0.9,
    white light with emission 5.
    """
    materials = make_materials(
        [
            dict(albedo=(0.7, 0.3, 0.3), metallic=0.0, roughness=0.5),
            dict(albedo=(0.5, 0.5, 0.5), metallic=0.0, roughness=0.9),
            dict(albedo=(0.8, 0.8, 0.8), metallic=1.0, roughness=0.0),
            dict(albedo=(0.8, 0.8, 1.0), metallic=0.9, roughness=0.0),
            dict(
                albedo=(1.0, 1.0, 1.0),
                emission=(5.0, 5.0, 5.0),
                metallic=0.0,
                roughness=0.0,
            ),
        ]
    )
    spheres = make_spheres(
        [
            ((0.0, 0.0, 0.0), 0.5, 0),
            ((0.0, -100.5, 0.0), 100.0, 1),
            ((1.0, 0.0, 0.0), 0.5, 2),
            ((-1.0, 0.0, 0.0), 0.5, 3),
            ((0.0, 5.0, 0.0), 1.0, 4),
        ]
    )
    return make_scene(spheres=spheres, materials=materials)


def create_cornell_box(light_emission=(15.0, 15.0, 15.0)) -> Scene:
    """Cornell-style box (BASELINE.json config 2): emissive area light at the
    ceiling, colored diffuse walls, one metal and one dielectric sphere.

    Not present in the reference (its docs claim spectral/Cornell content that
    the code lacks — SURVEY.md §0); geometry here is the classic layout
    normalized to a 2×2×2 box centered at the origin.
    """
    import numpy as np

    from .geometry import concat_triangles, make_triangles

    materials = make_materials(
        [
            dict(albedo=(0.73, 0.73, 0.73)),  # 0 white walls
            dict(albedo=(0.65, 0.05, 0.05)),  # 1 red left wall
            dict(albedo=(0.12, 0.45, 0.15)),  # 2 green right wall
            dict(albedo=(1.0, 1.0, 1.0), emission=light_emission),  # 3 light
            dict(albedo=(0.9, 0.9, 0.9), metallic=1.0, roughness=0.05),  # 4
            dict(  # 5 glass sphere (dielectric, dispersive flint-like glass)
                albedo=(1.0, 1.0, 1.0),
                metallic=1.0,
                roughness=0.0,
                ior=1.5,
                transmission=1.0,
                cauchy_b=0.0042,
            ),
        ]
    )

    def quad(p0, p1, p2, p3, mat):
        verts = np.asarray([p0, p1, p2, p3], np.float32)
        faces = np.asarray([[0, 1, 2], [0, 2, 3]], np.int64)
        return make_triangles(verts, faces, mat)

    s = 1.0  # half-extent
    quads = [
        # floor (normal up)
        quad((-s, -s, -s), (s, -s, -s), (s, -s, s), (-s, -s, s), 0),
        # ceiling
        quad((-s, s, -s), (-s, s, s), (s, s, s), (s, s, -s), 0),
        # back wall (z = -s)
        quad((-s, -s, -s), (-s, s, -s), (s, s, -s), (s, -s, -s), 0),
        # left wall (x = -s) red
        quad((-s, -s, s), (-s, s, s), (-s, s, -s), (-s, -s, -s), 1),
        # right wall (x = s) green
        quad((s, -s, -s), (s, s, -s), (s, s, s), (s, -s, s), 2),
        # ceiling light patch
        quad(
            (-0.35, s - 1e-3, -0.35),
            (-0.35, s - 1e-3, 0.35),
            (0.35, s - 1e-3, 0.35),
            (0.35, s - 1e-3, -0.35),
            3,
        ),
    ]
    triangles = concat_triangles(quads)
    spheres = make_spheres(
        [
            ((-0.45, -0.7, -0.35), 0.3, 4),  # metal
            ((0.45, -0.7, 0.25), 0.3, 5),  # glass
        ]
    )
    return make_scene(spheres=spheres, triangles=triangles, materials=materials)


def create_mesh_scene(obj_path: str | None = None, subdivisions: int = 3) -> Scene:
    """The bunny-tier scene (BASELINE.json config 3 /
    `/root/reference/tests/bunny-test.jl`): a triangle mesh on a ground
    sphere under the demo light, traversed through a two-level flat BVH.

    Loads the Stanford bunny (or any OBJ) from ``obj_path`` when given;
    otherwise substitutes a subdivided icosphere — the reference's own
    fallback when the bunny download fails
    (`/root/reference/examples/julia-raytracer.jl:687-691`).
    """
    from ..accel.bvh import build_two_level
    from .obj import icosphere, load_obj_mesh

    materials = make_materials(
        [
            dict(albedo=(0.65, 0.55, 0.45), metallic=0.0, roughness=0.6),  # mesh
            dict(albedo=(0.5, 0.5, 0.5), metallic=0.0, roughness=0.9),  # ground
            dict(albedo=(1.0, 1.0, 1.0), emission=(5.0, 5.0, 5.0)),  # light
            dict(albedo=(0.8, 0.8, 0.8), metallic=1.0, roughness=0.05),  # mirror
        ]
    )
    if obj_path is not None:
        mesh = load_obj_mesh(
            obj_path, material=0, center=True, normalize=True, scale=0.6,
            translate=(0.0, 0.1, 0.0),
        )
    else:
        mesh = icosphere(
            center=(0.0, 0.1, 0.0), radius=0.6, subdivisions=subdivisions,
            material=0,
        )
    mirror = icosphere(center=(1.3, 0.0, -0.6), radius=0.45, subdivisions=2,
                       material=3)
    bvh, triangles = build_two_level([mesh, mirror])
    spheres = make_spheres(
        [
            ((0.0, -100.5, 0.0), 100.0, 1),
            ((0.0, 5.0, 0.0), 1.0, 2),
        ]
    )
    return make_scene(
        spheres=spheres, triangles=triangles, materials=materials, bvh=bvh
    )


def cornell_camera(aspect_ratio=1.0):
    from .camera import make_camera

    return make_camera(
        lookfrom=(0.0, 0.0, 3.4),
        lookat=(0.0, 0.0, 0.0),
        vup=(0.0, 1.0, 0.0),
        vfov=40.0,
        aspect_ratio=aspect_ratio,
    )
