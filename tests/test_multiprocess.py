"""True N>=2-process distributed validation (BASELINE: gradient parity at
"1 chip, 1 host, and N>=2 hosts").

Spawns two OS processes that bring up `jax.distributed` over localhost,
render one tile+spp-sharded frame on a 2x(4-device) global CPU mesh, run
one gradient step with the cross-process all-reduce, and gather the frame
via `process_allgather`.  The parent then checks the multi-process image
against the single-process renderer (sharding-invariant PCG sampling) and
gradient agreement across processes.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_render_and_grads(tmp_path):
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "_mp_worker.py")
    # strip JAX env so each worker boots a clean CPU backend and sets its
    # own platform and device count before jax.distributed.initialize
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    procs = [
        subprocess.Popen(
            [sys.executable, worker, f"127.0.0.1:{port}", "2", str(i),
             str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-4000:]}"

    img = np.load(tmp_path / "image.npy")
    g0 = np.load(tmp_path / "grads_0.npy")
    g1 = np.load(tmp_path / "grads_1.npy")

    # both processes hold the identical psum-reduced gradient
    assert np.isfinite(g0).all() and np.abs(g0).max() > 0
    np.testing.assert_array_equal(g0, g1)

    # multi-process frame == single-process frame (PCG keyed on global
    # pixel/sample ids -> sharding-invariant; tolerance for psum order)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from spira_tpu.kernels.megakernel import render_flat_fused
    from spira_tpu.scene.camera import make_camera
    from spira_tpu.scene.scene import create_scene

    W, H, SPP, DEPTH = 64, 32, 4, 2
    scene = create_scene()
    cam = make_camera(
        lookfrom=(0.0, 1.0, 3.0), lookat=(0.0, 0.0, 0.0), aspect_ratio=W / H
    )
    ref = np.asarray(
        render_flat_fused(
            scene, cam, width=W, height=H, spp=SPP, max_depth=DEPTH
        )
    )
    np.testing.assert_allclose(img, ref, rtol=1e-4, atol=1e-5)

    # ---- the mesh path crossed the process boundary too: wavefront
    # forward + backward train step through the BVH walk (phase 2)
    m0 = np.load(tmp_path / "mesh_params_0.npy")
    m1 = np.load(tmp_path / "mesh_params_1.npy")
    assert np.isfinite(m0).all()
    # identical post-step params across processes == the psum'd gradient
    # (and Adam update) agreed bitwise across the process boundary
    np.testing.assert_array_equal(m0, m1)

    # multi-process mesh frame == the same (4 tile x 2 spp) sharded render
    # in one process (the wavefront folds tile ids into its keys, so the
    # reference is sharded the same way, on this process's 8 devices)
    mesh_img = np.load(tmp_path / "mesh_image.npy")
    from spira_tpu.parallel.mesh import make_mesh
    from spira_tpu.parallel.sharded import render_flat_sharded
    from spira_tpu.scene.scene import create_mesh_scene

    mref = np.asarray(render_flat_sharded(
        create_mesh_scene(subdivisions=1), cam, width=W, height=H,
        mesh=make_mesh(n_tile=4, n_spp=2), spp=SPP, max_depth=DEPTH,
        engine="wavefront",
    ))
    assert np.isfinite(mesh_img).all() and mesh_img.std() > 1e-3
    np.testing.assert_allclose(mesh_img, mref, rtol=1e-4, atol=1e-5)
