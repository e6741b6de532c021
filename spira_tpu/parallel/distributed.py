"""Multi-host execution: initialization, tile ownership, result gather.

Entirely new-build (SURVEY.md §2.8: the reference is single-process,
single-device).  The model:

* `initialize()` wraps `jax.distributed.initialize` — call once per host
  process before any JAX computation; a no-op for single-process runs.
* One *global* mesh spans every device of every host
  (`jax.devices()` post-init is the global device list); rendering uses the
  same `render_flat_sharded` — XLA partitions the program and hands the
  collectives to NCCL (NVLink within a host, the network across hosts).
* Each host owns the contiguous pixel rows of its addressable shards
  (`host_row_ranges`); `gather_image` all-gathers shards so every host (or
  just host 0) can assemble and write the full frame.
* Inverse rendering needs no extra code: parameters are replicated, so the
  backward pass's gradient `psum` is the cross-host all-reduce (overlapped
  with the backward sweep by XLA's scheduler — BASELINE.json north star).

Validated single-host on the virtual CPU mesh (tests) and via the driver's
`dryrun_multichip`; several hosts only change `initialize()` arguments.
"""

from __future__ import annotations

import jax
import numpy as np

from ..utils.metrics import logger
from .mesh import make_mesh


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Bring up the JAX distributed runtime (several hosts).

    With no arguments, JAX auto-detects the cluster from its environment
    (where a cluster manager provides one; otherwise pass the coordinator
    address, process count and id); silently a no-op when the runtime is
    already up or the run is single-process.
    """
    # must not touch the backend before jax.distributed.initialize —
    # jax.process_count() would initialise XLA and poison the init.
    try:
        from jax._src import distributed as _dist_state

        if _dist_state.global_state.client is not None:
            return  # already initialized
    except (ImportError, AttributeError):
        pass  # private API moved; fall through and let initialize() tell us
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        logger.info(
            "distributed: process %d/%d, %d local / %d global devices",
            jax.process_index(),
            jax.process_count(),
            jax.local_device_count(),
            jax.device_count(),
        )
    except Exception as e:
        if "already initialized" in str(e).lower():
            return  # fallback path when the private-state probe is gone
        if num_processes not in (None, 1):
            raise
        logger.debug("single-process run (distributed init skipped: %s)", e)


def global_mesh(n_tile: int | None = None, n_spp: int = 1):
    """Mesh over every chip of every host (devices are globally ordered, so
    the tile axis maps hosts to contiguous row blocks)."""
    return make_mesh(n_tile=n_tile, n_spp=n_spp, devices=jax.devices())


def host_row_ranges(height: int, mesh) -> dict[int, list[tuple[int, int]]]:
    """rows owned by each process: {process_index: [(row_start, row_end)]}.

    Rows are counted bottom-up (wavefront convention); each tile-axis mesh
    position owns ``height // n_tile`` contiguous rows.
    """
    n_tile = mesh.shape["tile"]
    rows_per = height // n_tile
    out: dict[int, list[tuple[int, int]]] = {}
    devs = np.asarray(mesh.devices)  # (n_tile, n_spp)
    for t in range(n_tile):
        proc = devs[t, 0].process_index
        out.setdefault(proc, []).append((t * rows_per, (t + 1) * rows_per))
    return out


def gather_image(flat_sharded) -> np.ndarray:
    """All-gather a tile-sharded flat image so the host holds every pixel.

    Single-process: a plain device_get.  Multi-host: a cross-host gather of
    the addressable shards (DCN traffic only for the final frame — the
    render itself never communicates across tiles).
    """
    if jax.process_count() == 1:
        return np.asarray(flat_sharded)
    from jax.experimental import multihost_utils

    return np.asarray(
        multihost_utils.process_allgather(flat_sharded, tiled=True)
    )


def is_primary() -> bool:
    return jax.process_index() == 0
