"""Triangle-mesh scene through the two-level flat BVH — the counterpart of
the reference's bunny renderers (`/root/reference/tests/bunny-test.jl`,
`/root/reference/examples/julia-raytracer-optimized.jl`).

Pass an OBJ path (e.g. the Stanford bunny) to render it; without one, a
subdivided icosphere stands in — the reference's own fallback behavior
(`/root/reference/examples/julia-raytracer.jl:687-691`).

    python examples/mesh_bvh.py [model.obj] [out.png]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import spira_tpu as st

obj = sys.argv[1] if len(sys.argv) > 1 and sys.argv[1].endswith(".obj") else None
out = sys.argv[-1] if sys.argv[-1].endswith(".png") else "mesh_render.png"

scene = st.create_mesh_scene(obj_path=obj)
camera = st.make_camera(
    lookfrom=(0.0, 1.0, 3.0), lookat=(0.0, 0.0, 0.0), vfov=50.0,
    aspect_ratio=640 / 360,
)
img = st.render(
    scene, camera, 640, 360, samples_per_pixel=32, max_depth=5,
    output_path=out,
)
print(f"wrote {out} ({scene.triangles.count} triangles)")
