"""Fused path-trace megakernel (sphere scenes, physical semantics).

The JAX realization of the standalone MSL megakernel
(`/root/reference/src/spira_path_trace_kernel.metal:140-269`, SURVEY.md §2.3):
ray generation, the full spp × bounce loop, intersection, BSDF scatter,
Russian roulette and accumulation fused into one dispatch — only the final
HDR image is written to device memory.  As in the Metal kernel, each GPU
thread owns one pixel; per-thread `break`s become lane masks.

The tracer core (:func:`trace_tile`) is backend-agnostic jnp and runs two
ways:

* :func:`render_flat_megakernel` — a Pallas kernel through Triton, one
  block of ``BLOCK`` pixels per program, scene constants read as scalars;
  the path state of each pixel stays in registers for the whole spp ×
  bounce loop;
* :func:`render_flat_fused` — the same math as a single XLA computation over
  the whole image: portable and differentiable.

Layout notes (why this beats the generic wavefront path in
`spira_tpu.integrator`):
  * state is component-split scalars-of-tiles — no (N, 3) minor-dim padding;
  * per-sphere material data is pre-gathered host-side and intersection runs
    as a static Python loop over spheres reading broadcast scalars — no
    gathers anywhere;
  * randomness is the PCG4D counter hash (`spira_tpu.core.pcg`) — ~10 uint32
    ops per 4 draws vs ~20 threefry rounds, stateless, identical across
    backends and in interpret mode.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..core import pcg

INF = np.float32(1e20)
T_MIN = np.float32(1e-3)
SCATTER_EPS = np.float32(1e-4)
RR_START = 3
RR_CAP = np.float32(0.95)
CUTOFF = np.float32(0.01)

# Per-bounce PCG stream ids (stream 0 = ray generation).
_S_LOBE = 1  # lobe select / RR / diffuse disk (4 uniforms)
_S_FUZZ = 2  # metal fuzz normals (4 uniforms -> 3 gaussians)
_S_GLASS = 3  # transmission / fresnel draws
_N_STREAMS = 3

N_TRI_FIELDS = 24  # v0(3) e1(3) e2(3) n(3) | albedo3 emission3 metal rough ior trans
#: fused engines statically unroll the primitive loops; beyond this many
#: triangles the wavefront+BVH path wins (and compile times explode).
FUSED_TRI_LIMIT = 32


def _norm3(x, y, z):
    inv = jax.lax.rsqrt(x * x + y * y + z * z + 1e-20)
    return x * inv, y * inv, z * inv


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _select(m, a, b):
    return jnp.where(m, a, b)


def init_hit_state(dx):
    """Fresh nearest-hit registers for one wavefront intersection query."""
    return dict(
        best_t=jnp.full_like(dx, INF),
        ncx=jnp.zeros_like(dx),
        ncy=jnp.zeros_like(dx),
        ncz=jnp.zeros_like(dx),
        inv_r=jnp.zeros_like(dx),
        m_ar=jnp.zeros_like(dx),
        m_ag=jnp.zeros_like(dx),
        m_ab=jnp.zeros_like(dx),
        m_er=jnp.zeros_like(dx),
        m_eg=jnp.zeros_like(dx),
        m_eb=jnp.zeros_like(dx),
        m_metal=jnp.zeros_like(dx),
        m_rough=jnp.zeros_like(dx),
        m_ior=jnp.ones_like(dx),
        m_trans=jnp.zeros_like(dx),
        hit_is_tri=jnp.zeros_like(dx, dtype=jnp.bool_),
        tnx=jnp.zeros_like(dx),
        tny=jnp.zeros_like(dx),
        tnz=jnp.zeros_like(dx),
    )


def sphere_unroll(spheres, o3, d3, st):
    """Static-unroll sphere intersection updating hit state ``st`` in place
    (the dict is mutated and returned).  Same math as the reference quadratic
    (`/root/reference/src/spira-metal-optimized.jl:700-799`)."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    best_t = st["best_t"]
    for sph in spheres:
        (cx, cy, cz, r, ar, ag, ab_, er, eg, eb, met, rough, ior,
         trans) = sph[:14]
        ocx = ox - cx
        ocy = oy - cy
        ocz = oz - cz
        half_b = _dot3(ocx, ocy, ocz, dx, dy, dz)
        c = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - r * r
        disc = half_b * half_b - c
        # double-where: sqrt'(0)=inf would poison the backward pass
        # through the masked-off branch (camera/geometry gradients)
        disc_ok = disc > 0.0
        sqrtd = jnp.where(
            disc_ok, jnp.sqrt(jnp.where(disc_ok, disc, 1.0)), 0.0
        )
        root0 = -half_b - sqrtd
        root1 = -half_b + sqrtd
        root = _select(root0 > T_MIN, root0, root1)
        hit_k = disc_ok & (root > T_MIN) & (root < best_t)
        best_t = _select(hit_k, root, best_t)
        st["ncx"] = _select(hit_k, cx, st["ncx"])
        st["ncy"] = _select(hit_k, cy, st["ncy"])
        st["ncz"] = _select(hit_k, cz, st["ncz"])
        st["inv_r"] = _select(hit_k, 1.0 / r, st["inv_r"])
        _select_mats(st, hit_k, (ar, ag, ab_, er, eg, eb, met, rough, ior,
                                 trans))
        st["hit_is_tri"] = st["hit_is_tri"] & ~hit_k
    st["best_t"] = best_t
    return st


def tri_unroll(triangles, o3, d3, st):
    """Static-unroll Möller–Trumbore over broadcast triangle scalars,
    updating hit state ``st``."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    best_t = st["best_t"]
    for tri in triangles:
        (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z,
         nxc, nyc, nzc, ar, ag, ab_, er, eg, eb, met, rough, ior,
         trans) = tri[:22]
        # Möller–Trumbore on broadcast scalars
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
            (jnp.abs(det) > 1e-9)
            & (uu >= 0.0)
            & (vv >= 0.0)
            & (uu + vv <= 1.0)
            & (tt > T_MIN)
            & (tt < best_t)
        )
        best_t = _select(hit_k, tt, best_t)
        st["tnx"] = _select(hit_k, nxc, st["tnx"])
        st["tny"] = _select(hit_k, nyc, st["tny"])
        st["tnz"] = _select(hit_k, nzc, st["tnz"])
        st["hit_is_tri"] = st["hit_is_tri"] | hit_k
        _select_mats(st, hit_k, (ar, ag, ab_, er, eg, eb, met, rough, ior,
                                 trans))
    st["best_t"] = best_t
    return st


_MAT_KEYS = ("m_ar", "m_ag", "m_ab", "m_er", "m_eg", "m_eb", "m_metal",
             "m_rough", "m_ior", "m_trans")


def _select_mats(st, mask, fields):
    for key, val in zip(_MAT_KEYS, fields):
        st[key] = _select(mask, val, st[key])


def finish_intersect(o3, d3, st):
    """Resolve hit state into ``(hit, p3, n3, mats10)``."""
    ox, oy, oz = o3
    dx, dy, dz = d3
    best_t = st["best_t"]
    hit = best_t < INF
    # miss lanes carry best_t = INF; inf*0 in the untaken branch of a
    # select still NaNs the backward pass — clamp to a safe value.
    best_t = _select(hit, best_t, 1.0)
    px = ox + best_t * dx
    py = oy + best_t * dy
    pz = oz + best_t * dz
    nx = (px - st["ncx"]) * st["inv_r"]
    ny = (py - st["ncy"]) * st["inv_r"]
    nz = (pz - st["ncz"]) * st["inv_r"]
    nx, ny, nz = _norm3(nx, ny, nz)
    nx = _select(st["hit_is_tri"], st["tnx"], nx)
    ny = _select(st["hit_is_tri"], st["tny"], ny)
    nz = _select(st["hit_is_tri"], st["tnz"], nz)
    mats = tuple(st[k] for k in _MAT_KEYS)
    return hit, (px, py, pz), (nx, ny, nz), mats


def make_brute_intersect(spheres, triangles=()):
    """The fused engines' intersector: static unrolls over broadcast scalars.

    Returns ``intersect(o3, d3, active) -> (hit, p3, n3, mats10)`` where p3
    is the hit point (miss lanes clamped to t=1 so no inf propagates), n3
    the unit geometric normal (miss lanes arbitrary — the caller masks), and
    mats10 the per-lane material fields
    (ar, ag, ab, er, eg, eb, metallic, roughness, ior, transmission).
    """

    def intersect(o3, d3, active=None):
        st = init_hit_state(d3[0])
        st = sphere_unroll(spheres, o3, d3, st)
        st = tri_unroll(triangles, o3, d3, st)
        return finish_intersect(o3, d3, st)

    return intersect


def trace_tile(
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
    remat: bool = False,
    sample_offset=0,
    intersect_fn=None,
):
    """Trace ``spp`` samples for a tile of pixels; returns summed (r, g, b).

    pixel: uint32 per-lane counters; row_f/col_f: float pixel coordinates
    (row counted from the image bottom); cam: 12 broadcastable scalars
    (origin, lower-left corner, horizontal, vertical); spheres: list of
    14-scalar tuples (packed by :func:`pack_scene_jnp`); triangles: list of
    24-scalar tuples (v0, e1, e2, unit normal, material fields) — both
    primitive loops are static unrolls over broadcast scalars.

    ``intersect_fn`` (``(o3, d3, active) -> (hit, p3, n3, mats10)``)
    overrides the nearest-hit query: a traversal kernel plugs in here and
    shares the exact shading/scatter math below.
    """
    (ox0, oy0, oz0, llcx, llcy, llcz, hx, hy, hz, vx, vy, vz) = cam[:12]
    if intersect_fn is None:
        intersect_fn = make_brute_intersect(spheres, triangles)

    def stream_id(s, b, which):
        return (
            s * np.uint32(max_depth * _N_STREAMS + 1)
            + np.uint32(b * _N_STREAMS + which)
        )

    def sample_body(s, acc):
        acc_r, acc_g, acc_b = acc
        s = s + sample_offset
        s32 = s.astype(jnp.uint32) if hasattr(s, "astype") else np.uint32(s)

        ju, jv, lu1, lu2 = pcg.uniform4(pixel, s32, stream_id(s32, 0, 0), seed)
        u = (col_f + ju) / du
        v = (row_f + jv) / dv
        dx = llcx + u * hx + v * vx - ox0
        dy = llcy + u * hy + v * vy - oy0
        dz = llcz + u * hz + v * vz - oz0
        if len(cam) >= 19:
            # thin-lens: polar disk sample from the raygen draw's two spare
            # outputs, offset along the camera's u/v basis (the fused-engine
            # form of /root/reference/examples/julia-raytracer.jl:290-295)
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

        tr = jnp.ones_like(dx)
        tg = jnp.ones_like(dx)
        tb = jnp.ones_like(dx)
        lr = jnp.zeros_like(dx)
        lg = jnp.zeros_like(dx)
        lb = jnp.zeros_like(dx)
        alive = jnp.ones_like(dx, dtype=jnp.bool_)

        for b in range(max_depth):
            hit, (px, py, pz), (nx, ny, nz), mats = intersect_fn(
                (ox, oy, oz), (dx, dy, dz), alive
            )
            (m_ar, m_ag, m_ab, m_er, m_eg, m_eb, m_metal, m_rough, m_ior,
             m_trans) = mats
            # ---- miss: sky gradient (MSL kernel :196-199)
            t_sky = 0.5 * (dy + 1.0)
            miss = alive & ~hit
            lr += _select(miss, tr * (1.0 - t_sky + 0.5 * t_sky), 0.0)
            lg += _select(miss, tg * (1.0 - t_sky + 0.7 * t_sky), 0.0)
            lb += _select(miss, tb * (1.0 - t_sky + 1.0 * t_sky), 0.0)

            live = alive & hit
            # ---- emission accumulate (MSL kernel :214)
            lr += _select(live, tr * m_er, 0.0)
            lg += _select(live, tg * m_eg, 0.0)
            lb += _select(live, tb * m_eb, 0.0)

            # Miss lanes would normalize a zero vector; chained rsqrt
            # backward factors then overflow to inf (NaN via inf·0).  Give
            # them a fixed unit normal instead — their output is masked.
            nx = _select(hit, nx, 0.0)
            ny = _select(hit, ny, 1.0)
            nz = _select(hit, nz, 0.0)
            entering = _dot3(dx, dy, dz, nx, ny, nz) < 0.0
            sgn = _select(entering, 1.0, -1.0)
            nx, ny, nz = nx * sgn, ny * sgn, nz * sgn

            # ---- randomness for this bounce
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

            # ---- specular lobe: mirror + roughness fuzz
            d_dot_n = _dot3(dx, dy, dz, nx, ny, nz)
            rx = dx - 2.0 * d_dot_n * nx
            ry = dy - 2.0 * d_dot_n * ny
            rz = dz - 2.0 * d_dot_n * nz
            ux, uy, uz = _norm3(g1, g2, g3)
            sx, sy, sz = _norm3(
                rx + m_rough * ux, ry + m_rough * uy, rz + m_rough * uz
            )

            # ---- dielectric sub-lobe (Schlick Fresnel + Snell)
            eta = _select(entering, 1.0 / m_ior, m_ior)
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
            r0 = ((1.0 - m_ior) / (1.0 + m_ior)) ** 2
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

            # ---- diffuse lobe: cosine hemisphere via disk projection
            # (MSL kernel :73-93)
            phi = np.float32(2.0 * np.pi) * u_d1
            sq = jnp.sqrt(u_d2)
            ddx = jnp.cos(phi) * sq
            ddy = jnp.sin(phi) * sq
            ddz = jnp.sqrt(jnp.maximum(0.0, 1.0 - u_d2))
            # orthonormal basis about n (branchless helper-axis pick)
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

            # ---- throughput *= albedo
            ntr = tr * m_ar
            ntg = tg * m_ag
            ntb = tb * m_ab

            survived = live
            if b > RR_START:
                # Russian roulette (MSL kernel :246-253); sampling decision —
                # detached so the fused path stays gradient-correct.
                p_cont = jax.lax.stop_gradient(
                    jnp.clip(
                        jnp.maximum(ntr, jnp.maximum(ntg, ntb)), 1e-6, RR_CAP
                    )
                )
                kill = u_rr > p_cont
                keep = ~kill
                inv_p = 1.0 / p_cont
                ntr = _select(keep, ntr * inv_p, ntr)
                ntg = _select(keep, ntg * inv_p, ntg)
                ntb = _select(keep, ntb * inv_p, ntb)
                survived = survived & keep
                survived = survived & (
                    jnp.maximum(ntr, jnp.maximum(ntg, ntb)) >= CUTOFF
                )

            # offset along the hemisphere the new direction leaves through
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
            tr = _select(survived, ntr, tr)
            tg = _select(survived, ntg, tg)
            tb = _select(survived, ntb, tb)
            alive = survived

        return (acc_r + lr, acc_g + lg, acc_b + lb)

    # `+ 0*sample_offset` matches the accumulator's varying-over-mesh-axes
    # type to the loop output when sample_offset comes from lax.axis_index
    # under shard_map (no-op, folded by XLA).
    zeros = jnp.zeros_like(row_f) + jnp.float32(0) * jnp.asarray(
        sample_offset, jnp.float32
    )

    # remat=True (fused-XLA path): per-sample checkpoint — reverse-mode keeps
    # only the accumulator per sample and replays the sample's paths
    # (path-replay backprop), so the fused path differentiates at full
    # resolution without a residual tape.  The Pallas kernel is forward-only
    # and sets remat=False.
    body = jax.checkpoint(sample_body) if remat else sample_body
    return jax.lax.fori_loop(0, spp, body, (zeros, zeros, zeros))


# ----------------------------------------------------------------------------
# Pallas kernel through Triton: one block of flat pixels per program
# ----------------------------------------------------------------------------

#: Pixels per Triton program and its warps: one pixel per thread, whose
#: path state (~40 floats) stays in registers for the whole spp × bounce
#: loop.  64 pixels on 2 warps measured fastest of (64, 2), (128, 4),
#: (256, 4) and (256, 8) on an H100 at the flagship shape (PERF.md).
BLOCK = 64
NUM_WARPS = 2


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def pad_table(table):
    """Zero-pad a 2-D table to power-of-two rows and columns (the Triton
    route loads only power-of-two shapes; the kernel reads it as scalars)."""
    n, f = table.shape
    return jnp.pad(table, ((0, _pow2(n) - n), (0, _pow2(f) - f)))


def pack_triangles_jnp(scene):
    """Traced (T, 24) triangle table (differentiable in material fields)."""
    tris, mats = scene.triangles, scene.materials
    m = tris.material
    t = tris.count
    return jnp.concatenate(
        [
            tris.v0,
            tris.e1,
            tris.e2,
            tris.normal,
            mats.albedo[m],
            mats.emission[m],
            mats.metallic[m][:, None],
            mats.roughness[m][:, None],
            mats.ior[m][:, None],
            mats.transmission[m][:, None],
            jnp.zeros((t, 2), jnp.float32),
        ],
        axis=1,
    )


def pack_scene_jnp(scene):
    """Traced (S, 16) scene table — differentiable in the material fields
    (the gather is the only indexing; gradients flow back to Materials)."""
    sph, mats = scene.spheres, scene.materials
    m = sph.material
    s = sph.count
    return jnp.concatenate(
        [
            sph.centers,
            sph.radii[:, None],
            mats.albedo[m],
            mats.emission[m],
            mats.metallic[m][:, None],
            mats.roughness[m][:, None],
            mats.ior[m][:, None],
            mats.transmission[m][:, None],
            jnp.zeros((s, 2), jnp.float32),
        ],
        axis=1,
    )


def pack_camera_jnp(camera):
    """Traced (1, 20) camera record (differentiable in the camera frame):
    origin, llc, horizontal, vertical, lens u/v basis, lens_radius, pad."""
    return jnp.concatenate(
        [
            camera.origin,
            camera.lower_left_corner,
            camera.horizontal,
            camera.vertical,
            camera.u,
            camera.v,
            jnp.reshape(camera.lens_radius, (1,)),
            jnp.zeros(1, jnp.float32),
        ]
    )[None, :]


def cam_tuple(cam_arr, has_lens: bool):
    """Scalar camera tuple for the tracers: 12 pinhole fields, or 19 with
    the thin-lens extension (u, v basis + lens_radius).  ``has_lens`` is the
    camera's static construction flag — pinhole renders keep the exact
    12-field raygen (bit-identical to pre-lens builds)."""
    return tuple(cam_arr[0, k] for k in range(19 if has_lens else 12))


@functools.partial(
    jax.jit,
    static_argnames=(
        "width", "height", "spp", "max_depth", "n_spheres", "n_tris",
        "inclusive_uv", "interpret",
    ),
)
def _launch(
    seed, scene, camera, *, width, height, spp, max_depth,
    n_spheres, n_tris, inclusive_uv, interpret,
):
    """The megakernel: each program traces ``BLOCK`` consecutive flat
    pixels (row-major from the image bottom — the fused twin's pixel ids);
    camera and scene tables are read as broadcast scalars.  Packing happens
    inside jit, so one call is one dispatch."""
    tri_arr = (
        pack_triangles_jnp(scene)
        if n_tris > 0
        else jnp.zeros((1, N_TRI_FIELDS), jnp.float32)
    )
    has_lens = camera.has_lens
    n = width * height
    n_pad = pl.cdiv(n, BLOCK) * BLOCK

    def kernel(seed_ref, cam_ref, sph_ref, tri_ref, out_r, out_g, out_b):
        p = pl.program_id(0) * BLOCK + jax.lax.broadcasted_iota(
            jnp.int32, (BLOCK,), 0
        )
        row = p // width
        col = p - row * width
        r, g, b = trace_tile(
            p.astype(jnp.uint32),
            row.astype(jnp.float32),
            col.astype(jnp.float32),
            cam_tuple(cam_ref, has_lens),
            [tuple(sph_ref[k, f] for f in range(14))
             for k in range(n_spheres)],
            [tuple(tri_ref[k, f] for f in range(22)) for k in range(n_tris)],
            seed=seed_ref[0],
            spp=spp,
            max_depth=max_depth,
            du=np.float32(width - 1 if inclusive_uv else width),
            dv=np.float32(height - 1 if inclusive_uv else height),
        )
        out_r[...] = r
        out_g[...] = g
        out_b[...] = b

    out = jax.ShapeDtypeStruct((n_pad,), jnp.float32)
    block = pl.BlockSpec((BLOCK,), lambda i: (i,))
    r, g, b = pl.pallas_call(
        kernel,
        grid=(n_pad // BLOCK,),
        out_shape=(out, out, out),
        in_specs=[pl.no_block_spec] * 4,
        out_specs=(block, block, block),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        interpret=interpret,
        name="spira_megakernel",
    )(
        jnp.reshape(seed, (1,)).astype(jnp.int32),
        pad_table(pack_camera_jnp(camera)),
        pad_table(pack_scene_jnp(scene)),
        pad_table(tri_arr),
    )
    # the tail past H*W is padding
    return jnp.stack([r[:n], g[:n], b[:n]], axis=-1) * np.float32(1.0 / spp)


def render_flat_megakernel(
    scene,
    camera,
    *,
    width: int,
    height: int,
    spp: int = 16,
    max_depth: int = 4,
    seed: int = 0,
    inclusive_uv: bool = True,
    interpret: bool = False,
):
    """Pallas-kernel render → flat (H*W, 3) bottom-up HDR buffer.

    Same estimator family as ``render_flat(semantics="physical")`` (different
    RNG stream, so agreement is statistical).  Small scenes (static unroll).
    """
    _check_fused_supported(scene)
    return _launch(
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
        interpret=interpret,
    )


# ----------------------------------------------------------------------------
# Fused-XLA wrapper (same tracer, whole image, one XLA computation)
# ----------------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_depth", "inclusive_uv"),
)
def _fused_xla(seed, scene, camera, *, width, height, spp, max_depth,
               inclusive_uv):
    acc = fused_rows(
        scene, camera, width=width, n_rows=height, row_start=0,
        sample_offset=0, spp=spp, max_depth=max_depth, seed=seed,
        du=np.float32(width - 1 if inclusive_uv else width),
        dv=np.float32(height - 1 if inclusive_uv else height),
    )
    return acc * np.float32(1.0 / spp)


def render_flat_fused(
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
    """Fused-XLA render → flat (H*W, 3) bottom-up HDR buffer (sphere scenes).

    Identical math + RNG to the Pallas kernel (agreement to float ULP),
    compiled as one fused XLA computation — the portable path, and the
    *differentiable* fast path: the scene table is
    traced, so gradients flow to every material field and to the camera
    frame (the per-sample checkpoint in :func:`trace_tile` keeps backward
    memory flat)."""
    _check_fused_supported(scene)
    return _fused_xla(
        jnp.int32(seed),
        scene,
        camera,
        width=width,
        height=height,
        spp=spp,
        max_depth=max_depth,
        inclusive_uv=inclusive_uv,
    )


def fused_rows(
    scene,
    camera,
    *,
    width: int,
    n_rows: int,
    row_start,
    sample_offset,
    spp: int,
    max_depth: int,
    seed,
    du: float,
    dv: float,
    remat: bool = True,
):
    """Fused tracer over a row-range — the shard body of the tile/spp-sharded
    renderer.  Because the PCG counters are keyed on the *global* pixel id
    and absolute sample index, the rendered image is sharding-invariant:
    any mesh shape produces the same pixels (up to reduction order).

    Returns the per-row-range radiance **sum** over its spp range,
    (n_rows*width, 3).
    """
    row = row_start + jax.lax.broadcasted_iota(jnp.int32, (n_rows, width), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (n_rows, width), 1)
    cam = cam_tuple(pack_camera_jnp(camera), camera.has_lens)
    sph_arr = pack_scene_jnp(scene)
    spheres = [
        tuple(sph_arr[k, f] for f in range(14))
        for k in range(scene.spheres.count)
    ]
    tri_arr = pack_triangles_jnp(scene)
    triangles = [
        tuple(tri_arr[k, f] for f in range(22))
        for k in range(scene.triangles.count)
    ]
    r, g, b = trace_tile(
        (row * width + col).astype(jnp.uint32),
        row.astype(jnp.float32),
        col.astype(jnp.float32),
        cam,
        spheres,
        triangles,
        seed=seed,
        spp=spp,
        max_depth=max_depth,
        du=du,
        dv=dv,
        remat=remat,
        sample_offset=sample_offset,
    )
    return jnp.reshape(jnp.stack([r, g, b], axis=-1), (n_rows * width, 3))


def _check_fused_supported(scene):
    if scene.triangles.count > FUSED_TRI_LIMIT:
        raise ValueError(
            f"fused engines statically unroll primitives and support at most "
            f"{FUSED_TRI_LIMIT} triangles (got {scene.triangles.count}); "
            f"large meshes use the wavefront+BVH path"
        )



# ----------------------------------------------------------------------------
# Hybrid differentiable render: table-chosen forward, fused-XLA backward
# ----------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _hybrid_vjp_fn(width, height, spp, grad_spp, max_depth, inclusive_uv,
                   fwd_engine):
    """custom_vjp closure over the static render config (cached per config).

    Forward runs ``fwd_engine`` (``"pallas"``: the Triton kernel;
    ``"fused"``: the fused-XLA twin); backward replays the *fused-XLA
    twin* — the same tracer and PCG stream — via its VJP at ``grad_spp``
    samples.  Because every sample is an identically distributed estimator
    of the pixel radiance, the ``grad_spp``-sample mean's VJP is an
    unbiased estimator of the full-``spp`` gradient (stochastic-gradient
    subsampling; ``grad_spp == spp`` reproduces the exact fused gradient,
    which is what the FD tests pin down).
    """
    kw = dict(width=width, height=height, max_depth=max_depth,
              inclusive_uv=inclusive_uv)
    forward = {"pallas": render_flat_megakernel,
               "fused": render_flat_fused}[fwd_engine]

    @jax.custom_vjp
    def f(scene, camera, seed):
        return forward(scene, camera, spp=spp, seed=seed, **kw)

    def fwd(scene, camera, seed):
        return f(scene, camera, seed), (scene, camera, seed)

    def bwd(res, g):
        scene, camera, seed = res

        def replay(sc, cam):
            return render_flat_fused(sc, cam, spp=grad_spp, seed=seed, **kw)

        _, vjp = jax.vjp(replay, scene, camera)
        d_scene, d_camera = vjp(g)
        return d_scene, d_camera, np.zeros((), jax.dtypes.float0)

    f.defvjp(fwd, bwd)
    return f


def render_flat_hybrid_grad(
    scene,
    camera,
    *,
    width: int,
    height: int,
    spp: int = 16,
    max_depth: int = 4,
    seed: int = 0,
    grad_spp: int | None = None,
    inclusive_uv: bool = True,
):
    """Differentiable flat render with the fastest forward.

    Forward: the engine table's ``small`` engine for this platform
    (:data:`spira_tpu.render.ENGINE_TABLE`).  Backward: path-replay through
    the fused-XLA twin's VJP over ``grad_spp`` samples (default: all
    ``spp``).  With ``grad_spp < spp`` the gradient is the standard
    stochastic-subsampled estimator — unbiased, ~spp/grad_spp less
    backward work — while the forward image/loss stays exact full-spp.
    This is the BASELINE "forward+backward per chip" configuration (see
    bench.py).
    """
    from ..render import engine_row

    f = _hybrid_vjp_fn(
        width, height, spp,
        grad_spp if grad_spp is not None else spp,
        max_depth, inclusive_uv,
        engine_row()["small"],
    )
    return f(scene, camera, jnp.int32(seed))
