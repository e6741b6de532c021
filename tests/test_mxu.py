"""MXU superleaf packing (`accel/mxu.py`): coefficient + traversal
equivalence.

The NumPy oracle evaluates the PACKED Plücker tables, differentially
tested against brute-force Möller–Trumbore — coefficient-sign or
bin-packing bugs fail here."""

import jax.numpy as jnp
import numpy as np
import pytest

from spira_tpu.accel.bvh import build_bvh_for_triangles
from spira_tpu.accel.mxu import (
    BLOCK_ROWS,
    pack_bvh_mxu,
    traverse_mxu_numpy,
)
from spira_tpu.integrator.intersect import intersect_triangles
from spira_tpu.scene.obj import icosphere


def _mesh(subdiv=2):
    tris = icosphere(material=3, subdivisions=subdiv)
    bvh = build_bvh_for_triangles(tris, leaf_size=4, use_native=False)
    return tris, bvh


def test_pack_structure():
    tris, bvh = _mesh(3)  # 1280 tris
    p = pack_bvh_mxu(bvh, tris)
    assert p.coeff_uv.shape == (p.n_leaves * BLOCK_ROWS, 384)
    assert p.coeff_t.shape == (p.n_leaves * BLOCK_ROWS, 128)
    assert p.coeff_pay.shape == (p.n_leaves * BLOCK_ROWS, 128)
    # bin packing keeps blocks near-full: >= 60% average fill
    assert p.n_leaves <= -(-int(tris.count) // 80)
    assert p.nodes.shape[0] % 8 == 0
    # one unit-normal row set per packed triangle
    pay = np.asarray(p.coeff_pay).reshape(p.n_leaves, BLOCK_ROWS, 128)
    lens = np.linalg.norm(pay[:, 0:3, :], axis=1).reshape(-1)
    filled = lens > 0
    assert filled.sum() == tris.count
    np.testing.assert_allclose(lens[filled], 1.0, atol=1e-4)


@pytest.mark.parametrize("superleaf", [32, 128])
def test_mxu_traversal_matches_brute_force(superleaf):
    tris, bvh = _mesh(2)
    p = pack_bvh_mxu(bvh, tris, superleaf=superleaf)
    rng = np.random.RandomState(7)
    origins = rng.randn(80, 3).astype(np.float32) * 1.5
    dirs = rng.randn(80, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    brute = intersect_triangles(tris, jnp.asarray(origins), jnp.asarray(dirs))
    hit = np.asarray(brute.hit)
    t_ref = np.asarray(brute.t)
    for k in range(origins.shape[0]):
        t, n, mat = traverse_mxu_numpy(p, origins[k], dirs[k])
        if hit[k]:
            assert np.isclose(t, t_ref[k], rtol=1e-4, atol=1e-5)
            assert mat == 3
            assert np.isclose(np.linalg.norm(n), 1.0, atol=1e-4)
        else:
            assert not np.isfinite(t)


def test_degenerate_single_leaf():
    tris, bvh = _mesh(1)  # 80 tris -> a single superleaf under one node
    p = pack_bvh_mxu(bvh, tris)
    assert p.n_leaves == 1
    t, n, mat = traverse_mxu_numpy(p, np.array([0.0, 0.0, 3.0]),
                                   np.array([0.0, 0.0, -1.0]))
    assert np.isfinite(t) and mat == 3


# ---- pair-record tree over superleaf blocks (SuperleafBVH) ----


def test_superleaf_pack_structure():
    from spira_tpu.accel.mxu import pack_bvh_superleaf

    tris, bvh = _mesh(3)  # 1280 tris
    p = pack_bvh_superleaf(bvh, tris)
    assert p.coeff_uv.shape == (p.n_blocks * BLOCK_ROWS, 384)
    assert p.pairs.shape[0] % 8 == 0
    assert p.pairs.shape[1] == 16
    assert p.depth >= 1
    # leaf children point at block indices, internal ones at pair rows
    pairs = np.asarray(p.pairs[: p.n_pairs])
    for rec in pairs:
        for half in (0, 1):
            ptr, cnt = int(rec[8 * half + 6]), int(rec[8 * half + 7])
            if cnt > 0:
                assert 0 <= ptr < p.n_blocks
            elif cnt == 0:
                assert 0 <= ptr < p.n_pairs


@pytest.mark.parametrize("superleaf", [32, 128])
def test_superleaf_traversal_matches_brute_force(superleaf):
    from spira_tpu.accel.mxu import pack_bvh_superleaf, traverse_superleaf_numpy

    tris, bvh = _mesh(2)
    p = pack_bvh_superleaf(bvh, tris, superleaf=superleaf)
    rng = np.random.RandomState(11)
    origins = rng.randn(80, 3).astype(np.float32) * 1.5
    dirs = rng.randn(80, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    brute = intersect_triangles(tris, jnp.asarray(origins), jnp.asarray(dirs))
    hit = np.asarray(brute.hit)
    t_ref = np.asarray(brute.t)
    for k in range(origins.shape[0]):
        t, n, mat = traverse_superleaf_numpy(p, origins[k], dirs[k])
        if hit[k]:
            assert np.isclose(t, t_ref[k], rtol=1e-4, atol=1e-5)
            assert mat == 3
            assert np.isclose(np.linalg.norm(n), 1.0, atol=1e-4)
        else:
            assert not np.isfinite(t)


def test_superleaf_root_cut_single_block():
    """A mesh small enough that the root itself is the superleaf cut: the
    packing synthesizes one pair record whose first half is the lone leaf."""
    from spira_tpu.accel.mxu import pack_bvh_superleaf, traverse_superleaf_numpy

    tris, bvh = _mesh(1)  # 80 tris -> single block
    p = pack_bvh_superleaf(bvh, tris)
    assert p.n_blocks == 1
    t, n, mat = traverse_superleaf_numpy(
        p, np.array([0.0, 0.0, 3.0]), np.array([0.0, 0.0, -1.0])
    )
    assert np.isfinite(t) and mat == 3
