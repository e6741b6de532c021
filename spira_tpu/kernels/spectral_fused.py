"""Fused hero-wavelength spectral tracer (small scenes, physical semantics).

The spectral twin of :mod:`spira_tpu.kernels.megakernel`: the whole
spp × bounce spectral transport loop as one fused computation with
component-split state — but with per-path wavelength lanes and spectral
throughput.  The design difference from the wavefront spectral estimator
(`spira_tpu/integrator/spectral.py`):

* Material SPDs are **Chebyshev-compressed** (``colorimetry.N_CHEB``
  coefficients per spectrum, fitted from the 24-bin tables at pack time).
  Evaluating an SPD at a wavelength becomes a Clenshaw recurrence of
  elementwise ops — no table gathers in the hot loop, so the static
  primitive unroll carries its spectra as broadcast scalars exactly like
  RGB fields.  Accuracy vs the exact tables is a few percent on saturated
  colors (tested); the wavefront engine remains the exact path.
* The sky gradient always satisfies r ≤ g ≤ b, so its Smits upsample is a
  single-ordering blend of three Chebyshev-fitted basis spectra.
* Wavelength lanes (hero + 3 stratified rotations) are separate scalar
  registers; scatter geometry is decided at the hero wavelength; dispersive
  refraction collapses the path to the hero lane (×W) — the same estimator
  as the wavefront spectral path.
* The film converts spectral radiance → CIE XYZ with the analytic CMF fits
  per sample and accumulates XYZ; linear sRGB comes out at the end.

Runs as fused-XLA (differentiable w.r.t. the Chebyshev coefficient tables,
hence the SPDs).  Its Pallas-Triton form measured slower than this on an
H100 and was removed (PERF.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import colorimetry as cl
from ..core import pcg
from .megakernel import (
    CUTOFF,
    FUSED_TRI_LIMIT,
    INF,
    RR_CAP,
    RR_START,
    SCATTER_EPS,
    T_MIN,
    _dot3,
    _norm3,
    _select,
    cam_tuple,
    pack_camera_jnp,
)

W = cl.N_WAVELENGTHS
D = cl.N_CHEB

# PCG stream ids: 0 = raygen, then per bounce.
_S_LOBE = 1
_S_FUZZ = 2
_S_GLASS = 3
_N_STREAMS = 3
_S_WAVELENGTH = 10_000  # one-off stream for hero-λ selection
_S_LENS = 10_001  # one-off stream for the thin-lens disk sample


def _cheb(coeffs, x):
    """Clenshaw evaluation of Chebyshev scalars at unit-interval x."""
    b1 = jnp.zeros_like(x)
    b2 = jnp.zeros_like(x)
    for c in coeffs[:0:-1]:
        b1, b2 = 2.0 * x * b1 - b2 + c, b1
    return x * b1 - b2 + coeffs[0]


_SKY_WHITE = tuple(np.asarray(cl.SMITS_CHEB["white"], np.float32))
_SKY_CYAN = tuple(np.asarray(cl.SMITS_CHEB["cyan"], np.float32))
_SKY_BLUE = tuple(np.asarray(cl.SMITS_CHEB["blue"], np.float32))


def make_brute_intersect_spectral(spheres, triangles):
    """Static-unroll nearest-hit over spectral primitive tuples.

    Returns ``intersect(o3, d3, active) -> (hit, t_safe, n3, smats)`` where
    ``t_safe`` is the hit distance (1.0 on miss), ``n3`` the geometric
    normal pre-face-forward ((0,1,0) on miss), and ``smats`` the per-lane
    material bundle ``(metal, rough, ior, trans, cauchy, alb_cheb[D],
    emi_cheb[D])``.  This is the default hook of
    :func:`trace_tile_spectral`; a traversal kernel can substitute its
    nearest hit here (mirroring the RGB tracer's ``intersect_fn``)."""

    def intersect(o3, d3, active=None):
        ox, oy, oz = o3
        dx, dy, dz = d3
        best_t = jnp.full_like(dx, INF)
        ncx = jnp.zeros_like(dx)
        ncy = jnp.zeros_like(dx)
        ncz = jnp.zeros_like(dx)
        inv_r = jnp.zeros_like(dx)
        m_metal = jnp.zeros_like(dx)
        m_rough = jnp.zeros_like(dx)
        m_ior = jnp.ones_like(dx)
        m_trans = jnp.zeros_like(dx)
        m_cauchy = jnp.zeros_like(dx)
        m_alb = [jnp.zeros_like(dx) for _ in range(D)]
        m_emi = [jnp.zeros_like(dx) for _ in range(D)]
        hit_is_tri = jnp.zeros_like(dx, dtype=jnp.bool_)
        tnx = jnp.zeros_like(dx)
        tny = jnp.zeros_like(dx)
        tnz = jnp.zeros_like(dx)

        for sph in spheres:
            cx, cy, cz, r = sph[0], sph[1], sph[2], sph[3]
            met, rough, ior, trans, cauchy = (
                sph[4], sph[5], sph[6], sph[7], sph[8],
            )
            alb_c = sph[9 : 9 + D]
            emi_c = sph[9 + D : 9 + 2 * D]
            ocx = ox - cx
            ocy = oy - cy
            ocz = oz - cz
            half_b = _dot3(ocx, ocy, ocz, dx, dy, dz)
            c = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - r * r
            disc = half_b * half_b - c
            disc_ok = disc > 0.0
            sqrtd = jnp.where(
                disc_ok, jnp.sqrt(jnp.where(disc_ok, disc, 1.0)), 0.0
            )
            root0 = -half_b - sqrtd
            root1 = -half_b + sqrtd
            root = _select(root0 > T_MIN, root0, root1)
            hit_k = disc_ok & (root > T_MIN) & (root < best_t)
            best_t = _select(hit_k, root, best_t)
            ncx = _select(hit_k, cx, ncx)
            ncy = _select(hit_k, cy, ncy)
            ncz = _select(hit_k, cz, ncz)
            inv_r = _select(hit_k, 1.0 / r, inv_r)
            m_metal = _select(hit_k, met, m_metal)
            m_rough = _select(hit_k, rough, m_rough)
            m_ior = _select(hit_k, ior, m_ior)
            m_trans = _select(hit_k, trans, m_trans)
            m_cauchy = _select(hit_k, cauchy, m_cauchy)
            m_alb = [_select(hit_k, a, m) for a, m in zip(alb_c, m_alb)]
            m_emi = [_select(hit_k, e, m) for e, m in zip(emi_c, m_emi)]
            hit_is_tri = hit_is_tri & ~hit_k

        for tri in triangles:
            (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, nxc, nyc,
             nzc) = tri[:12]
            met, rough, ior, trans, cauchy = (
                tri[12], tri[13], tri[14], tri[15], tri[16],
            )
            alb_c = tri[17 : 17 + D]
            emi_c = tri[17 + D : 17 + 2 * D]
            pvx = dy * e2z - dz * e2y
            pvy = dz * e2x - dx * e2z
            pvz = dx * e2y - dy * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            det_ok = jnp.abs(det) > 1e-12
            inv_det = jnp.where(
                det_ok, 1.0 / jnp.where(det_ok, det, 1.0), 0.0
            )
            tvx = ox - v0x
            tvy = oy - v0y
            tvz = oz - v0z
            uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det
            tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
            hit_k = (
                det_ok
                & (jnp.abs(det) > 1e-9)
                & (uu >= 0.0)
                & (vv >= 0.0)
                & (uu + vv <= 1.0)
                & (tt > T_MIN)
                & (tt < best_t)
            )
            best_t = _select(hit_k, tt, best_t)
            tnx = _select(hit_k, nxc, tnx)
            tny = _select(hit_k, nyc, tny)
            tnz = _select(hit_k, nzc, tnz)
            hit_is_tri = hit_is_tri | hit_k
            m_metal = _select(hit_k, met, m_metal)
            m_rough = _select(hit_k, rough, m_rough)
            m_ior = _select(hit_k, ior, m_ior)
            m_trans = _select(hit_k, trans, m_trans)
            m_cauchy = _select(hit_k, cauchy, m_cauchy)
            m_alb = [_select(hit_k, a, m) for a, m in zip(alb_c, m_alb)]
            m_emi = [_select(hit_k, e, m) for e, m in zip(emi_c, m_emi)]

        hit = best_t < INF
        best_t = _select(hit, best_t, 1.0)
        px = ox + best_t * dx
        py = oy + best_t * dy
        pz = oz + best_t * dz
        nx = (px - ncx) * inv_r
        ny = (py - ncy) * inv_r
        nz = (pz - ncz) * inv_r
        nx, ny, nz = _norm3(nx, ny, nz)
        nx = _select(hit_is_tri, tnx, nx)
        ny = _select(hit_is_tri, tny, ny)
        nz = _select(hit_is_tri, tnz, nz)
        nx = _select(hit, nx, 0.0)
        ny = _select(hit, ny, 1.0)
        nz = _select(hit, nz, 0.0)
        smats = (
            m_metal, m_rough, m_ior, m_trans, m_cauchy,
            tuple(m_alb), tuple(m_emi),
        )
        return hit, best_t, (nx, ny, nz), smats

    return intersect


def trace_tile_spectral(
    pixel,
    row_f,
    col_f,
    cam,
    spheres,
    triangles=(),
    *,
    seed,
    spp: int,
    max_depth: int,
    du: float,
    dv: float,
    remat: bool = True,
    sample_offset=0,
    intersect_fn=None,
):
    """Spectral transport for a tile of pixels; returns summed XYZ
    (x, y, z) tile arrays.

    spheres: list of tuples (cx, cy, cz, r, metal, rough, ior, trans,
    cauchy_b, alb_cheb[D], emi_cheb[D]); triangles likewise with
    (v0, e1, e2, n) geometry prefix.  Packed by
    :func:`pack_scene_spectral`.

    ``intersect_fn`` (see :func:`make_brute_intersect_spectral` for the
    contract) overrides the nearest-hit query — a traversal kernel plugs
    in here and shares the shading below.
    """
    (ox0, oy0, oz0, llcx, llcy, llcz, hx, hy, hz, vx, vy, vz) = cam[:12]
    if intersect_fn is None:
        intersect_fn = make_brute_intersect_spectral(spheres, triangles)

    def stream_id(s, b, which):
        return s * np.uint32(max_depth * _N_STREAMS + 1) + np.uint32(
            b * _N_STREAMS + which
        )

    def sample_body(s, acc):
        acc_x, acc_y, acc_z = acc
        s = s + sample_offset
        s32 = s.astype(jnp.uint32) if hasattr(s, "astype") else np.uint32(s)

        # ---- wavelength lanes: hero + stratified rotations
        u_l, ju, jv, _ = pcg.uniform4(
            pixel, s32, jnp.uint32(_S_WAVELENGTH) + s32 * 0, seed
        )
        lam = []
        for j in range(W):
            frac = jnp.mod(u_l + np.float32(j / W), 1.0)
            lam.append(
                np.float32(cl.LAMBDA_MIN) + frac * np.float32(cl.LAMBDA_RANGE)
            )
        lam_x = [  # unit-interval coordinate per lane (for Chebyshev)
            2.0 * (l - np.float32(cl.LAMBDA_MIN)) / np.float32(cl.LAMBDA_RANGE)
            - 1.0
            for l in lam
        ]

        # ---- primary ray
        u = (col_f + ju) / du
        v = (row_f + jv) / dv
        dx = llcx + u * hx + v * vx - ox0
        dy = llcy + u * hy + v * vy - oy0
        dz = llcz + u * hz + v * vz - oz0
        if len(cam) >= 19:
            # thin-lens raygen (dedicated one-off stream; the wavelength
            # draw has only one spare output)
            lu1, lu2, _, _ = pcg.uniform4(
                pixel, s32, jnp.uint32(_S_LENS) + s32 * 0, seed
            )
            (cux, cuy, cuz, cvx, cvy, cvz, lr) = cam[12:19]
            rad = lr * jnp.sqrt(lu1)
            phi = np.float32(2.0 * np.pi) * lu2
            cp = jnp.cos(phi)
            sp_ = jnp.sin(phi)
            offx = rad * (cp * cux + sp_ * cvx)
            offy = rad * (cp * cuy + sp_ * cvy)
            offz = rad * (cp * cuz + sp_ * cvz)
            dx, dy, dz = dx - offx, dy - offy, dz - offz
            dx, dy, dz = _norm3(dx, dy, dz)
            ox = ox0 + offx
            oy = oy0 + offy
            oz = oz0 + offz
        else:
            dx, dy, dz = _norm3(dx, dy, dz)
            ox = jnp.zeros_like(dx) + ox0
            oy = jnp.zeros_like(dx) + oy0
            oz = jnp.zeros_like(dx) + oz0

        thr = [jnp.ones_like(dx) for _ in range(W)]
        rad = [jnp.zeros_like(dx) for _ in range(W)]
        alive = jnp.ones_like(dx, dtype=jnp.bool_)
        collapsed = jnp.zeros_like(dx, dtype=jnp.bool_)

        for b in range(max_depth):
            # ---- nearest hit (brute static unroll or the plugged-in BVH)
            hit, best_t, (nx, ny, nz), smats = intersect_fn(
                (ox, oy, oz), (dx, dy, dz), alive
            )
            (m_metal, m_rough, m_ior, m_trans, m_cauchy,
             m_alb, m_emi) = smats

            # ---- sky: single-ordering Smits blend (r <= g <= b always)
            t_sky = 0.5 * (dy + 1.0)
            sky_r = 1.0 - t_sky + 0.5 * t_sky
            sky_g = 1.0 - t_sky + 0.7 * t_sky
            sky_b = 1.0 - t_sky + 1.0 * t_sky
            miss = alive & ~hit
            for j in range(W):
                white = _cheb(_SKY_WHITE, lam_x[j])
                cyan = _cheb(_SKY_CYAN, lam_x[j])
                blue = _cheb(_SKY_BLUE, lam_x[j])
                sky_spd = jnp.maximum(
                    sky_r * white + (sky_g - sky_r) * cyan
                    + (sky_b - sky_g) * blue,
                    0.0,
                )
                rad[j] = rad[j] + _select(miss, thr[j] * sky_spd, 0.0)

            # ---- emission (per-λ Chebyshev eval of the selected material)
            live = alive & hit
            alb_lam = []
            for j in range(W):
                emi_j = jnp.maximum(_cheb(m_emi, lam_x[j]), 0.0)
                rad[j] = rad[j] + _select(live, thr[j] * emi_j, 0.0)
                alb_lam.append(jnp.maximum(_cheb(m_alb, lam_x[j]), 0.0))

            # ---- geometry (normals come resolved from intersect_fn)
            px = ox + best_t * dx
            py = oy + best_t * dy
            pz = oz + best_t * dz
            entering = _dot3(dx, dy, dz, nx, ny, nz) < 0.0
            sgn = _select(entering, 1.0, -1.0)
            nx, ny, nz = nx * sgn, ny * sgn, nz * sgn

            # ---- randomness
            u_lobe, u_rr, u_d1, u_d2 = pcg.uniform4(
                pixel, s32, stream_id(s32, b, _S_LOBE), seed
            )
            f1, f2, f3, f4 = pcg.uniform4(
                pixel, s32, stream_id(s32, b, _S_FUZZ), seed
            )
            g1, g2 = pcg.box_muller(f1, f2)
            g3, _ = pcg.box_muller(f3, f4)
            u_trans, u_fres, _, _ = pcg.uniform4(
                pixel, s32, stream_id(s32, b, _S_GLASS), seed
            )

            # ---- specular: mirror + fuzz
            d_dot_n = _dot3(dx, dy, dz, nx, ny, nz)
            rx = dx - 2.0 * d_dot_n * nx
            ry = dy - 2.0 * d_dot_n * ny
            rz = dz - 2.0 * d_dot_n * nz
            ux_, uy_, uz_ = _norm3(g1, g2, g3)
            sx, sy, sz = _norm3(
                rx + m_rough * ux_, ry + m_rough * uy_, rz + m_rough * uz_
            )

            # ---- dielectric at the hero wavelength: n(λ) = ior + B/λ²(µm)
            lam_um = lam[0] * np.float32(1e-3)
            ior_h = m_ior + m_cauchy / (lam_um * lam_um)
            eta = _select(entering, 1.0 / ior_h, ior_h)
            cos_i = jnp.clip(-d_dot_n, 0.0, 1.0)
            sin2_t = eta * eta * jnp.maximum(0.0, 1.0 - cos_i * cos_i)
            tir = sin2_t > 1.0
            # double-where on cos_t² > 0, not just ~tir: at sin2_t == 1
            # sqrt'(0) = inf, and the untaken lobe's zero cotangent times
            # inf is NaN in the backward pass
            cos_t2 = 1.0 - sin2_t
            cos_ok = cos_t2 > 0.0
            cos_t = jnp.where(
                cos_ok, jnp.sqrt(jnp.where(cos_ok, cos_t2, 1.0)), 0.0
            )
            fx = eta * dx + (eta * cos_i - cos_t) * nx
            fy = eta * dy + (eta * cos_i - cos_t) * ny
            fz = eta * dz + (eta * cos_i - cos_t) * nz
            fx, fy, fz = _norm3(fx, fy, fz)
            r0 = ((1.0 - ior_h) / (1.0 + ior_h)) ** 2
            one_m = 1.0 - cos_i
            schlick = r0 + (1.0 - r0) * one_m * one_m * one_m * one_m * one_m
            refl_choice = tir | (u_fres < schlick)
            is_glass = u_trans < m_trans
            gx = _select(refl_choice, sx, fx)
            gy = _select(refl_choice, sy, fy)
            gz = _select(refl_choice, sz, fz)
            sx = _select(is_glass, gx, sx)
            sy = _select(is_glass, gy, sy)
            sz = _select(is_glass, gz, sz)
            refracting = is_glass & ~refl_choice
            dispersive = refracting & (m_cauchy > 0.0)

            # ---- diffuse: cosine hemisphere
            phi = np.float32(2.0 * np.pi) * u_d1
            sq = jnp.sqrt(u_d2)
            ddx = jnp.cos(phi) * sq
            ddy = jnp.sin(phi) * sq
            ddz = jnp.sqrt(jnp.maximum(0.0, 1.0 - u_d2))
            pick_y = jnp.abs(nx) > 0.1
            ax = _select(pick_y, 0.0, 1.0)
            ay = _select(pick_y, 1.0, 0.0)
            bux = ay * nz
            buy = -ax * nz
            buz = ax * ny - ay * nx
            bux, buy, buz = _norm3(bux, buy, buz)
            bvx = ny * buz - nz * buy
            bvy = nz * bux - nx * buz
            bvz = nx * buy - ny * bux
            cx_, cy_, cz_ = _norm3(
                ddx * bux + ddy * bvx + ddz * nx,
                ddx * buy + ddy * bvy + ddz * ny,
                ddx * buz + ddy * bvz + ddz * nz,
            )

            spec = u_lobe < m_metal
            ndx = _select(spec, sx, cx_)
            ndy = _select(spec, sy, cy_)
            ndz = _select(spec, sz, cz_)
            spec_dispersive = spec & dispersive

            # ---- spectral throughput update + hero collapse
            do_collapse = spec_dispersive & ~collapsed
            new_thr = []
            for j in range(W):
                tj = thr[j] * alb_lam[j]
                if j == 0:
                    tj = _select(do_collapse, tj * np.float32(W), tj)
                else:
                    tj = _select(do_collapse, 0.0, tj)
                new_thr.append(tj)
            collapsed = collapsed | do_collapse

            survived = live
            if b > RR_START:
                tmax = new_thr[0]
                for j in range(1, W):
                    tmax = jnp.maximum(tmax, new_thr[j])
                p_cont = jax.lax.stop_gradient(jnp.clip(tmax, 1e-6, RR_CAP))
                kill = u_rr > p_cont
                keep = ~kill
                inv_p = 1.0 / p_cont
                new_thr = [_select(keep, t * inv_p, t) for t in new_thr]
                survived = survived & keep
                tmax = new_thr[0]
                for j in range(1, W):
                    tmax = jnp.maximum(tmax, new_thr[j])
                survived = survived & (tmax >= CUTOFF)

            out_side = _dot3(ndx, ndy, ndz, nx, ny, nz) >= 0.0
            osgn = _select(out_side, 1.0, -1.0)
            nox = px + SCATTER_EPS * osgn * nx
            noy = py + SCATTER_EPS * osgn * ny
            noz = pz + SCATTER_EPS * osgn * nz

            ox = _select(survived, nox, ox)
            oy = _select(survived, noy, oy)
            oz = _select(survived, noz, oz)
            dx = _select(survived, ndx, dx)
            dy = _select(survived, ndy, dy)
            dz = _select(survived, ndz, dz)
            thr = [_select(survived, nt, t) for nt, t in zip(new_thr, thr)]
            alive = survived

        # ---- film: spectral radiance → XYZ (MC over λ, pdf = 1/range)
        sx_ = jnp.zeros_like(row_f)
        sy_ = jnp.zeros_like(row_f)
        sz_ = jnp.zeros_like(row_f)
        for j in range(W):
            cmx, cmy, cmz = cl.cmf_xyz_components(lam[j])  # analytic fits
            sx_ = sx_ + rad[j] * cmx
            sy_ = sy_ + rad[j] * cmy
            sz_ = sz_ + rad[j] * cmz
        scale = np.float32(cl.LAMBDA_RANGE / cl.Y_INTEGRAL / W)
        return (acc_x + sx_ * scale, acc_y + sy_ * scale, acc_z + sz_ * scale)

    zeros = jnp.zeros_like(row_f) + jnp.float32(0) * jnp.asarray(
        sample_offset, jnp.float32
    )
    body = jax.checkpoint(sample_body) if remat else sample_body
    return jax.lax.fori_loop(0, spp, body, (zeros, zeros, zeros))


# ----------------------------------------------------------------------------
# Packing + fused-XLA wrapper
# ----------------------------------------------------------------------------

N_SPH_SPEC = 9 + 2 * D
N_TRI_SPEC = 17 + 2 * D


#: The Chebyshev least-squares fit is a fixed linear map of the SPD table —
#: precompute its pseudo-inverse once (host) and apply it as one einsum
#: inside jit, fully differentiable.
_CHEB_PINV = np.linalg.pinv(
    np.polynomial.chebyshev.chebvander(
        2.0 * (cl.SPD_GRID - cl.LAMBDA_MIN) / cl.LAMBDA_RANGE - 1.0, D - 1
    ).astype(np.float64)
).astype(np.float32)  # (D, K)


def pack_scene_spectral_jnp(scene):
    """Traced spectral scene tables: spheres (S, 9+2D), triangles
    (T, 17+2D).  Call inside jit — eager calls dispatch per-op device
    programs."""
    mats = scene.materials
    pinv = jnp.asarray(_CHEB_PINV)

    def lin_fit(table):
        return jnp.einsum(
            "dk,mk->md", pinv, table, precision=jax.lax.Precision.HIGHEST
        )

    alb_cheb = lin_fit(mats.albedo_spd)
    emi_cheb = lin_fit(mats.emission_spd)

    ms = scene.spheres.material
    sph = jnp.concatenate(
        [
            scene.spheres.centers,
            scene.spheres.radii[:, None],
            mats.metallic[ms][:, None],
            mats.roughness[ms][:, None],
            mats.ior[ms][:, None],
            mats.transmission[ms][:, None],
            (mats.cauchy_b[ms] if mats.cauchy_b is not None
             else mats.ior[ms] * 0.0)[:, None],
            alb_cheb[ms],
            emi_cheb[ms],
        ],
        axis=1,
    )
    mt = scene.triangles.material
    t = scene.triangles.count
    tri = jnp.concatenate(
        [
            scene.triangles.v0,
            scene.triangles.e1,
            scene.triangles.e2,
            scene.triangles.normal,
            mats.metallic[mt][:, None],
            mats.roughness[mt][:, None],
            mats.ior[mt][:, None],
            mats.transmission[mt][:, None],
            (mats.cauchy_b[mt] if mats.cauchy_b is not None
             else mats.ior[mt] * 0.0)[:, None],
            alb_cheb[mt],
            emi_cheb[mt],
        ],
        axis=1,
    ) if t > 0 else jnp.zeros((1, N_TRI_SPEC), jnp.float32)
    return sph, tri


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_depth", "n_spheres",
                     "n_tris", "inclusive_uv"),
)
def _fused_spectral_xla(
    seed, scene, camera, *, width, height, spp, max_depth,
    n_spheres, n_tris, inclusive_uv,
):
    sph_arr, tri_arr = pack_scene_spectral_jnp(scene)
    row = jax.lax.broadcasted_iota(jnp.int32, (height, width), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (height, width), 1)
    spheres = [
        tuple(sph_arr[k, f] for f in range(N_SPH_SPEC))
        for k in range(n_spheres)
    ]
    triangles = [
        tuple(tri_arr[k, f] for f in range(N_TRI_SPEC)) for k in range(n_tris)
    ]
    x, y, z = trace_tile_spectral(
        (row * width + col).astype(jnp.uint32),
        row.astype(jnp.float32),
        col.astype(jnp.float32),
        cam_tuple(pack_camera_jnp(camera), camera.has_lens),
        spheres,
        triangles,
        seed=seed,
        spp=spp,
        max_depth=max_depth,
        du=np.float32(width - 1 if inclusive_uv else width),
        dv=np.float32(height - 1 if inclusive_uv else height),
    )
    inv = np.float32(1.0 / spp)
    xyz = jnp.stack([x * inv, y * inv, z * inv], axis=-1)
    return jnp.reshape(cl.xyz_to_rgb(xyz), (height * width, 3))


def render_flat_fused_spectral(
    scene,
    camera,
    *,
    width: int,
    height: int,
    spp: int = 16,
    max_depth: int = 4,
    seed: int = 0,
    inclusive_uv: bool = True,
):
    """Fused spectral render → flat (H*W, 3) linear-sRGB buffer."""
    if scene.triangles.count > FUSED_TRI_LIMIT:
        raise ValueError(
            f"fused spectral engine supports at most {FUSED_TRI_LIMIT} "
            f"triangles; large meshes use the wavefront spectral path"
        )
    return _fused_spectral_xla(
        jnp.int32(seed),
        scene,
        camera,
        width=width,
        height=height,
        spp=spp,
        max_depth=max_depth,
        n_spheres=scene.spheres.count,
        n_tris=scene.triangles.count,
        inclusive_uv=inclusive_uv,
    )
