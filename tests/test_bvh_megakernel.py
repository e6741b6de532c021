"""Pair-table BVH packing (host-side NumPy): oracle tests.

The reference's own broken traversal (left child never pushed,
/root/reference/examples/spira-metal-raytracer.jl:606) motivates the
differential testing here: the NumPy pair-table oracle against brute force,
and the Baldwin-Weber leaf operands against Moller-Trumbore.
"""

import numpy as np

from spira_tpu.accel.bvh import build_bvh_for_triangles, build_two_level
from spira_tpu.accel.pairs import pack_bvh, traverse_packed_numpy
from spira_tpu.scene.obj import icosphere


def _random_rays(n, seed=0, spread=2.5):
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return origins, dirs


def _brute_force_t(tris, origins, dirs, t_min=1e-3):
    """Reference nearest-t by testing every triangle (float64)."""
    v0 = np.asarray(tris.v0, np.float64)
    e1 = np.asarray(tris.e1, np.float64)
    e2 = np.asarray(tris.e2, np.float64)
    o = origins[:, None, :].astype(np.float64)
    d = dirs[:, None, :].astype(np.float64)
    pv = np.cross(d, e2[None])
    det = np.sum(e1[None] * pv, axis=-1)
    ok = np.abs(det) > 1e-9
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    tv = o - v0[None]
    u = np.sum(tv * pv, axis=-1) * inv
    qv = np.cross(tv, e1[None])
    v = np.sum(d * qv, axis=-1) * inv
    t = np.sum(e2[None] * qv, axis=-1) * inv
    valid = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > t_min)
    t = np.where(valid, t, np.inf)
    return t.min(axis=1)


def test_pack_oracle_matches_brute_force():
    mesh = icosphere(center=(0.0, 0.0, 0.0), radius=1.0, subdivisions=2,
                     material=0)
    bvh = build_bvh_for_triangles(mesh)
    packed = pack_bvh(bvh, mesh)
    origins, dirs = _random_rays(200, seed=1)
    t_ref = _brute_force_t(mesh, origins, dirs)
    for k in range(origins.shape[0]):
        t, _, _ = traverse_packed_numpy(packed, origins[k], dirs[k])
        if np.isinf(t_ref[k]):
            assert np.isinf(t), k
        else:
            assert abs(t - t_ref[k]) < 1e-3, (k, t, t_ref[k])


def test_pack_oracle_two_level_redirects():
    m0 = icosphere(center=(-0.8, 0.0, 0.0), radius=0.5, subdivisions=1,
                   material=0)
    m1 = icosphere(center=(0.9, 0.2, 0.1), radius=0.4, subdivisions=2,
                   material=1)
    bvh, tris = build_two_level([m0, m1])
    packed = pack_bvh(bvh, tris)
    origins, dirs = _random_rays(200, seed=2)
    t_ref = _brute_force_t(tris, origins, dirs)
    for k in range(origins.shape[0]):
        t, _, mid = traverse_packed_numpy(packed, origins[k], dirs[k])
        if np.isinf(t_ref[k]):
            assert np.isinf(t), k
        else:
            assert abs(t - t_ref[k]) < 1e-3, (k, t, t_ref[k])


def test_bw_operands_match_mt_barycentrics():
    """The Baldwin-Weber packing (pairs._bw_operands) must reproduce
    Moller-Trumbore's (t, u, v) for arbitrary triangles and rays: the two
    leaf forms are different factorizations of the same intersection."""
    from spira_tpu.accel.pairs import _bw_operands

    rng = np.random.default_rng(7)
    v0 = rng.normal(size=(64, 3)).astype(np.float32)
    e1 = rng.normal(size=(64, 3)).astype(np.float32)
    e2 = rng.normal(size=(64, 3)).astype(np.float32)
    n = np.cross(e1, e2)
    nrm = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    bw = _bw_operands(v0, e1, e2, nrm)  # (64, 12)

    o, d = _random_rays(64, seed=8, spread=1.5)
    # MT reference (float64)
    pv = np.cross(d.astype(np.float64), e2.astype(np.float64))
    det = np.sum(e1 * pv, axis=-1)
    tv = o - v0
    u_mt = np.sum(tv * pv, axis=-1) / det
    qv = np.cross(tv.astype(np.float64), e1.astype(np.float64))
    v_mt = np.sum(d * qv, axis=-1) / det
    t_mt = np.sum(e2 * qv, axis=-1) / det
    # BW evaluation, exactly as the kernel computes it
    nh, dn = bw[:, 0:3], bw[:, 3]
    den = np.sum(nh * d, axis=-1)
    t_bw = (dn - np.sum(nh * o, axis=-1)) / den
    p = o + t_bw[:, None] * d
    u_bw = np.sum(bw[:, 4:7] * p, axis=-1) + bw[:, 7]
    v_bw = np.sum(bw[:, 8:11] * p, axis=-1) + bw[:, 11]

    ok = np.abs(det) > 1e-6
    scale = 1.0 + np.abs(t_mt[ok])
    assert np.allclose(t_bw[ok], t_mt[ok], atol=1e-3 * scale.max(),
                       rtol=1e-3)
    assert np.allclose(u_bw[ok], u_mt[ok], atol=2e-3, rtol=2e-3)
    assert np.allclose(v_bw[ok], v_mt[ok], atol=2e-3, rtol=2e-3)
