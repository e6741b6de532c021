"""Device-mesh construction and sharding helpers.

The reference has no multi-device execution at all (SURVEY.md §2.8: CPU
scanline threads + single-GPU thread-per-ray).  This design scales along
the renderer's natural parallel axes:

* ``tile``  — contiguous pixel-row blocks of the image (the data/context-
  parallel axis): each device owns ``height / n_tile`` rows; the scene, BVH
  and spectral tables are replicated per device (BASELINE.json north star).
* ``spp``   — Monte-Carlo samples (a pure data-parallel axis): sample ranges
  are split across devices and mean-reduced with a `psum`.

The mesh follows the algorithm alone: the cards of one host reach each
other all to all over NVLink, and XLA hands the `psum` to NCCL.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_tile: int | None = None, n_spp: int = 1, devices=None) -> Mesh:
    """Build a (tile, spp) mesh.  Defaults to all devices on the tile axis."""
    if devices is None:
        devices = jax.devices()
    if n_tile is None:
        n_tile = len(devices) // n_spp
    n = n_tile * n_spp
    if n > len(devices):
        raise ValueError(
            f"mesh {n_tile}x{n_spp} needs {n} devices, have {len(devices)}"
        )
    grid = np.asarray(devices[:n]).reshape(n_tile, n_spp)
    return Mesh(grid, ("tile", "spp"))


def tile_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the flat ray/pixel axis over ``tile`` (replicated over spp)."""
    return NamedSharding(mesh, P("tile"))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def replicate(tree, mesh: Mesh):
    """Place every leaf of a pytree replicated on the mesh (scene/BVH/
    spectral tables per BASELINE.json: replicated per chip)."""
    sh = replicated_sharding(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)
