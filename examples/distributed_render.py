"""Tile/spp-sharded rendering over a device mesh; run unchanged on one GPU,
several GPUs of one host, or (for dry runs) virtual CPU devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/distributed_render.py

On several hosts, launch one process per host; `initialize()` wires up the
cluster and the same code renders the globally-sharded frame.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import jax

import spira_tpu as st
from spira_tpu.io import image as img_io
from spira_tpu.parallel.distributed import (
    gather_image,
    initialize,
    is_primary,
)
from spira_tpu.parallel.mesh import make_mesh, replicate
from spira_tpu.parallel.sharded import render_flat_sharded

initialize()
W, H, SPP = 640, 320, 32

n_dev = jax.device_count()
n_spp = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
mesh = make_mesh(n_tile=n_dev // n_spp, n_spp=n_spp)
print(f"mesh: {dict(mesh.shape)} over {n_dev} devices")

scene = replicate(st.create_scene(), mesh)
camera = replicate(st.default_camera(W / H), mesh)

flat = render_flat_sharded(
    scene, camera, width=W, height=H, mesh=mesh, spp=SPP, max_depth=4,
    engine="fused",
)
img = gather_image(flat)

if is_primary():
    hdr = img_io.assemble_image(img, W, H)
    img_io.save_png(
        "distributed_render.png",
        img_io.to_uint8(img_io.tonemap_gamma(hdr)),
    )
    print("wrote distributed_render.png")
