"""The bunny tier (BASELINE config 3).

The reference's test downloads the real Stanford bunny OBJ at test time
(`/root/reference/tests/bunny-test.jl:9-34`).  Nothing here touches the
network: a caller with the real OBJ on disk passes its path, and the
default is :func:`procedural_bunny` — a bunny-class mesh (72,960 triangles
across 9 sub-meshes, matching the real bunny's 69k scale) built from
deformed icospheres, exercising the same machinery: a two-level BVH over
multiple meshes and 69k-scale leaf tables.
"""

from __future__ import annotations

import numpy as np

from .geometry import Triangles, concat_triangles, make_triangles
from .obj import icosphere_mesh, load_obj_mesh


def _part(subdivisions, scale3, rotate_deg, translate, material=0,
          squash=None) -> Triangles:
    """Deformed icosphere: per-axis scale -> optional taper -> Euler-Y/Z/X
    rotate -> translate."""
    verts, faces = icosphere_mesh(subdivisions)
    v = verts * np.asarray(scale3, np.float64)
    if squash is not None:
        # taper along +y: lerp xz scale from 1 at y_min to `squash` at y_max
        y = v[:, 1]
        t = (y - y.min()) / max(y.max() - y.min(), 1e-9)
        s = 1.0 + (squash - 1.0) * t
        v[:, 0] *= s
        v[:, 2] *= s
    rx, ry, rz = [np.deg2rad(a) for a in rotate_deg]
    for axis, ang in ((0, rx), (1, ry), (2, rz)):
        if ang:
            c, s = np.cos(ang), np.sin(ang)
            i, j = [(1, 2), (0, 2), (0, 1)][axis]
            vi, vj = v[:, i].copy(), v[:, j].copy()
            v[:, i] = c * vi - s * vj
            v[:, j] = s * vi + c * vj
    v += np.asarray(translate, np.float64)
    return make_triangles(v.astype(np.float32), faces, material)


def procedural_bunny(material: int = 0, scale: float = 1.0):
    """Bunny-class multi-mesh body (~66k triangles) for offline benches.

    Returns a list of Triangles parts (one per anatomical blob) so callers
    build a genuine two-level BVH, like the reference's scene-over-meshes
    structure (`Mesh` ctor,
    /root/reference/examples/julia-raytracer-optimized.jl:274-303).
    """
    s = scale
    parts = [
        # body: big squashed ellipsoid (20480 tris)
        _part(5, (0.52 * s, 0.42 * s, 0.62 * s), (8, 0, 0),
              (0.0, 0.38 * s, 0.0), material),
        # head (20480 tris)
        _part(5, (0.26 * s, 0.26 * s, 0.3 * s), (0, 0, 0),
              (0.0, 0.78 * s, 0.48 * s), material),
        # ears: two long tapered ellipsoids (2 x 5120 tris)
        _part(4, (0.09 * s, 0.34 * s, 0.13 * s), (18, 0, 12),
              (-0.14 * s, 1.18 * s, 0.38 * s), material, squash=0.55),
        _part(4, (0.09 * s, 0.34 * s, 0.13 * s), (18, 0, -12),
              (0.14 * s, 1.18 * s, 0.38 * s), material, squash=0.55),
        # haunches (2 x 5120 tris)
        _part(4, (0.2 * s, 0.26 * s, 0.3 * s), (0, 0, 0),
              (-0.38 * s, 0.22 * s, -0.3 * s), material),
        _part(4, (0.2 * s, 0.26 * s, 0.3 * s), (0, 0, 0),
              (0.38 * s, 0.22 * s, -0.3 * s), material),
        # front feet (2 x 5120 tris)
        _part(4, (0.11 * s, 0.1 * s, 0.26 * s), (0, 0, 0),
              (-0.2 * s, 0.06 * s, 0.42 * s), material),
        _part(4, (0.11 * s, 0.1 * s, 0.26 * s), (0, 0, 0),
              (0.2 * s, 0.06 * s, 0.42 * s), material),
        # tail (1280 tris)
        _part(3, (0.11 * s, 0.11 * s, 0.11 * s), (0, 0, 0),
              (0.0, 0.34 * s, -0.66 * s), material),
    ]
    return parts


def create_bunny_scene(obj_path: str | None = None):
    """Config-3 scene: the bunny (the OBJ at ``obj_path`` when given, else
    the procedural stand-in) over a ground sphere under the demo light,
    with a two-level BVH at the builder's default leaf size.

    Returns (scene, info) where info records which mesh was used, its
    triangle count, its node count and which builder built the trees.
    """
    from ..accel.bvh import build_two_level
    from ..accel.native import last_builder
    from .materials import make_materials
    from .geometry import make_spheres
    from .scene import make_scene

    materials = make_materials(
        [
            dict(albedo=(0.75, 0.71, 0.68), metallic=0.0, roughness=0.6),
            dict(albedo=(0.5, 0.5, 0.5), metallic=0.0, roughness=0.9),
            dict(albedo=(1.0, 1.0, 1.0), emission=(5.0, 5.0, 5.0)),
        ]
    )
    if obj_path is not None:
        mesh = load_obj_mesh(
            obj_path, material=0, center=True, normalize=True, scale=0.8,
            translate=(0.0, 0.25, 0.0),
        )
        parts = [mesh]
        source = "stanford-obj"
    else:
        parts = procedural_bunny(material=0, scale=0.62)
        source = "procedural"

    bvh, triangles = build_two_level(parts)
    spheres = make_spheres(
        [
            # ground top at y=0 so the bunny's feet rest on it
            ((0.0, -100.0, 0.0), 100.0, 1),
            ((0.0, 5.0, 0.0), 1.0, 2),
        ]
    )
    scene = make_scene(
        spheres=spheres, triangles=triangles, materials=materials, bvh=bvh
    )
    info = dict(source=source, triangles=int(triangles.count),
                nodes=int(bvh.node_count), builder=last_builder())
    return scene, info


def bunny_camera(aspect_ratio):
    from .camera import make_camera

    return make_camera(
        lookfrom=(0.0, 0.9, 2.6),
        lookat=(0.0, 0.45, 0.0),
        vup=(0.0, 1.0, 0.0),
        vfov=50.0,
        aspect_ratio=aspect_ratio,
    )
