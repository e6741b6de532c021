"""Worker process for the true multi-process distributed test.

Launched N times by tests/test_multiprocess.py.  Each process owns 4
virtual CPU devices; together they form one 8-device global mesh — the
same topology as two 4-card hosts, exercising `jax.distributed`
coordination, cross-process collectives (psum over the spp axis, gradient
all-reduce) and `process_allgather` (`parallel.distributed.gather_image`).

Usage: python _mp_worker.py <coordinator> <num_procs> <proc_id> <outdir>
"""

import os
import sys

coordinator, num_procs, proc_id, outdir = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
)

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Distributed init MUST precede anything that initialises the XLA backend —
# importing the package materialises device arrays (colorimetry tables), so
# this mirrors real multi-host programs: init first, import the app after.
jax.distributed.initialize(
    coordinator_address=coordinator, num_processes=num_procs,
    process_id=proc_id,
)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spira_tpu.parallel import distributed as dist  # noqa: E402

# exercises the already-initialized guard (no-op path)
dist.initialize(
    coordinator_address=coordinator, num_processes=num_procs,
    process_id=proc_id,
)
assert jax.process_count() == num_procs, jax.process_count()
assert jax.device_count() == 4 * num_procs

from spira_tpu.parallel.sharded import render_flat_sharded  # noqa: E402
from spira_tpu.scene.camera import make_camera  # noqa: E402
from spira_tpu.scene.scene import create_scene  # noqa: E402
from spira_tpu.core.types import replace  # noqa: E402

W, H, SPP, DEPTH = 64, 32, 4, 2
scene = create_scene()
cam = make_camera(
    lookfrom=(0.0, 1.0, 3.0), lookat=(0.0, 0.0, 0.0), aspect_ratio=W / H
)
mesh = dist.global_mesh(n_tile=4, n_spp=2)

flat = render_flat_sharded(
    scene, cam, width=W, height=H, mesh=mesh, spp=SPP, max_depth=DEPTH,
    engine="fused",
)
img = dist.gather_image(flat)  # exercises process_allgather cross-process

# one inverse step: grad of an MSE-style loss wrt replicated albedo — the
# shard_map transpose inserts the cross-process gradient all-reduce
from jax import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402


def loss_fn(albedo):
    mats = replace(scene.materials, albedo=albedo)
    sc = replace(scene, materials=mats)
    flat = render_flat_sharded(
        sc, cam, width=W, height=H, mesh=mesh, spp=SPP, max_depth=DEPTH,
        engine="fused",
    )
    return jnp.mean(flat ** 2)


grads = jax.jit(jax.grad(loss_fn))(scene.materials.albedo)
grads = np.asarray(jax.device_get(grads))

if dist.is_primary():
    np.save(os.path.join(outdir, "image.npy"), img)
np.save(os.path.join(outdir, f"grads_{proc_id}.npy"), grads)
print(f"worker {proc_id}: ok image={img.shape} gmax={np.abs(grads).max():.6f}",
      flush=True)

# ---- phase 2: the MESH PATH across the process boundary.  Sharded
# wavefront forward through the stackless BVH walk + one train step whose
# backward replays through the same walk, with the gradient all-reduce
# crossing processes.
from spira_tpu.diff.inverse import make_inverse_step  # noqa: E402
from spira_tpu.parallel.mesh import replicate  # noqa: E402
from spira_tpu.parallel.sharded import render_flat_sharded as _rfs  # noqa: E402
from spira_tpu.scene.scene import create_mesh_scene  # noqa: E402

mscene = replicate(create_mesh_scene(subdivisions=1), mesh)
mcam = replicate(cam, mesh)
mflat = _rfs(
    mscene, mcam, width=W, height=H, mesh=mesh, spp=SPP, max_depth=DEPTH,
    engine="wavefront",
)
mimg = dist.gather_image(mflat)

mstep, minit = make_inverse_step(
    width=W, height=H, spp=SPP, max_depth=DEPTH, mesh=mesh,
)
mparams = {"albedo": mscene.materials.albedo * 0.5}
mopt = minit(mparams)
mparams, mopt, mloss = mstep(mparams, mopt, mscene, mcam, mflat, 0)
mupd = np.asarray(jax.device_get(mparams["albedo"]))

if dist.is_primary():
    np.save(os.path.join(outdir, "mesh_image.npy"), mimg)
np.save(os.path.join(outdir, f"mesh_params_{proc_id}.npy"), mupd)
print(f"worker {proc_id}: mesh ok loss={float(mloss):.6f} "
      f"pmax={np.abs(mupd).max():.6f}", flush=True)
