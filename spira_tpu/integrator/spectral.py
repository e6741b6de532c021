"""Hero-wavelength spectral path tracing.

New capability (the reference's docs claim spectral rendering; its code has
none — SURVEY.md §0).  Design:

* Each path carries ``N_WAVELENGTHS`` wavelengths: a hero λ drawn uniformly
  over the visible range plus stratified rotations λ_j = wrap(λ_h + jΔ/W) —
  the wavelength axis is a small vectorized per-ray minor axis (the
  "TP-analogue" axis of SURVEY.md §2.8).
* Scatter geometry (lobe choice, directions) is decided once per path using
  the hero wavelength; spectral throughput is per-λ via the material SPD
  tables.
* Dispersive refraction (cauchy_b > 0) makes direction λ-dependent: on the
  first such event the path collapses to its hero wavelength (other lanes
  zeroed, hero ×W) — the standard unbiased hero-wavelength treatment.
* At the film each sample converts spectral radiance → XYZ via the CIE fits
  and → linear sRGB, so everything downstream (accumulation, tone mapping,
  sharding) is unchanged.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..core import colorimetry as cl
from ..core import rng as srng
from ..core import vecmath as vm
from ..core.vecmath import SCATTER_EPS
from . import bsdf
from .intersect import intersect_scene
from .path_trace import RR_CAP, RR_START, THROUGHPUT_CUTOFF

W = cl.N_WAVELENGTHS


def sample_wavelengths(key, n_rays):
    """Hero + stratified-rotation wavelengths, (N, W); pdf = 1/Δ each."""
    u = srng.uniform(srng.bounce_key(key, 0, srng.Stream.WAVELENGTH), (n_rays, 1))
    offsets = jnp.arange(W, dtype=jnp.float32)[None, :] / W
    frac = jnp.mod(u + offsets, 1.0)
    return cl.LAMBDA_MIN + frac * cl.LAMBDA_RANGE


def trace_spectral(
    scene,
    origins,
    directions,
    sample_key,
    *,
    max_depth: int,
    russian_roulette: bool = True,
    remat: bool = True,
    intersect_fn=None,
):
    """Estimate RGB radiance for a wavefront via spectral transport.

    ``intersect_fn`` (``(scene, o, d, alive) -> Hit``) overrides the
    nearest-hit query, e.g. the sorted-packet traversal
    (`kernels.bvh_megakernel.make_sorted_tile_intersect`).
    Returns (N, 3) linear sRGB.
    """
    n = origins.shape[0]
    lam = sample_wavelengths(sample_key, n)  # (N, W)

    zeros = origins * 0.0
    zeros_w = jnp.zeros((n, W), origins.dtype) + zeros[:, :1]
    init = (
        origins,
        directions,
        zeros_w + 1.0,  # spectral throughput (N, W)
        zeros_w,  # spectral radiance (N, W)
        zeros[:, 0] < 1.0,  # alive
        zeros[:, 0] > 1.0,  # collapsed-to-hero flag (all False)
    )

    step = partial(_bounce, scene=scene, sample_key=sample_key, lam=lam,
                   russian_roulette=russian_roulette,
                   intersect_fn=intersect_fn)
    body = lambda carry, b: (step(carry, b), None)
    if remat:
        body = jax.checkpoint(body)
    (_, _, _, radiance, _, _), _ = jax.lax.scan(
        body, init, jnp.arange(max_depth)
    )

    xyz = cl.spectrum_to_xyz(radiance, lam)
    return cl.xyz_to_rgb(xyz)


def _bounce(carry, bounce_idx, *, scene, sample_key, lam, russian_roulette,
            intersect_fn=None):
    o, d, throughput, radiance, alive, collapsed = carry
    n = o.shape[0]
    materials = scene.materials

    if intersect_fn is None:
        hit = intersect_scene(scene, o, d)
    else:
        hit = intersect_fn(scene, o, d, alive)
    mat = bsdf.gather_materials(materials, hit.material)

    # SPD lookups: (N, W) albedo/emission at each carried wavelength.
    # SPD table rows route through the one-hot selection like the RGB
    # fields (bsdf.take_rows: exact at full precision, deterministic VJP).
    oh = bsdf.one_hot_rows(hit.material, materials.count)
    alb = cl.sample_spd(bsdf.take_rows(oh, materials.albedo_spd), lam)
    emi = cl.sample_spd(bsdf.take_rows(oh, materials.emission_spd), lam)

    # Sky: RGB gradient upsampled per wavelength (device-side 3-basis blend).
    sky_rgb = bsdf.sky_color(d)  # (N, 3)
    sky_spd = _upsample_device(sky_rgb, lam)  # (N, W)

    miss = alive & ~hit.hit
    radiance = radiance + jnp.where(miss[:, None], throughput * sky_spd, 0.0)

    live_hit = alive & hit.hit
    radiance = radiance + jnp.where(live_hit[:, None], throughput * emi, 0.0)

    t_safe = jnp.where(hit.hit, hit.t, 1.0)  # keep INF out of reverse-mode
    hit_point = o + t_safe[:, None] * d
    entering = vm.dot(d, hit.normal) < 0.0
    n_ff = vm.where(entering, hit.normal, -hit.normal)

    # --- lobe selection (hero-λ decides geometry) ---
    k_lobe = srng.bounce_key(sample_key, bounce_idx, srng.Stream.LOBE_SELECT)
    u = srng.uniform(k_lobe, (n, 3))
    u_lobe, u_trans, u_fresnel = u[:, 0], u[:, 1], u[:, 2]
    specular_sel = u_lobe < mat["metallic"]

    mirror = vm.normalize(vm.reflect(d, n_ff))
    k_fuzz = srng.bounce_key(sample_key, bounce_idx, srng.Stream.METAL_FUZZ)
    fuzz = srng.unit_vector(k_fuzz, (n,))
    fuzzed = vm.normalize(mirror + mat["roughness"][:, None] * fuzz)

    # Dielectric with dispersion: n(λ_hero) = ior + B/λ² (λ in µm).
    lam_hero_um = lam[:, 0] * 1e-3
    ior_hero = mat["ior"] + mat["cauchy_b"] / (lam_hero_um**2)
    eta = jnp.where(entering, 1.0 / ior_hero, ior_hero)
    refracted, tir = vm.refract(d, n_ff, eta[:, None])
    refracted = vm.normalize(refracted)
    cos_i = jnp.clip(-vm.dot(d, n_ff), 0.0, 1.0)
    r0 = ((1.0 - ior_hero) / (1.0 + ior_hero)) ** 2
    schlick = r0 + (1.0 - r0) * (1.0 - cos_i) ** 5
    reflect_choice = tir | (u_fresnel < schlick)
    glass_dir = vm.where(reflect_choice, fuzzed, refracted)

    is_glass = specular_sel & (u_trans < mat["transmission"])
    refracting = is_glass & ~reflect_choice
    dispersive = refracting & (mat["cauchy_b"] > 0.0)
    spec_dir = vm.where(is_glass, glass_dir, fuzzed)

    k_diff = srng.bounce_key(sample_key, bounce_idx, srng.Stream.DIFFUSE_DIR)
    diffuse_dir = srng.cosine_hemisphere(k_diff, n_ff)

    new_dir = vm.where(specular_sel, spec_dir, diffuse_dir)

    # Collapse to hero on first dispersive refraction.
    do_collapse = dispersive & ~collapsed
    hero_mask = jnp.zeros((1, W)).at[0, 0].set(1.0)
    collapse_scale = jnp.where(
        do_collapse[:, None], hero_mask * jnp.float32(W), jnp.ones((1, W))
    )
    new_throughput = throughput * alb * collapse_scale
    collapsed = collapsed | do_collapse

    going_out = vm.dot(new_dir, n_ff) >= 0.0
    offset_n = vm.where(going_out, n_ff, -n_ff)
    new_origin = hit_point + SCATTER_EPS * offset_n

    survived = live_hit
    if russian_roulette:
        p_cont = jnp.clip(jnp.max(new_throughput, axis=-1), 1e-6, RR_CAP)
        p_cont = jax.lax.stop_gradient(p_cont)
        k_rr = srng.bounce_key(sample_key, bounce_idx, srng.Stream.ROULETTE)
        u_rr = srng.uniform(k_rr, (n,))
        rr_active = bounce_idx > RR_START
        rr_kill = rr_active & (u_rr > p_cont)
        new_throughput = jnp.where(
            (rr_active & ~rr_kill)[:, None],
            new_throughput / p_cont[:, None],
            new_throughput,
        )
        survived = survived & ~rr_kill
        survived = survived & (
            jnp.max(new_throughput, axis=-1) >= THROUGHPUT_CUTOFF
        )

    o = vm.where(survived, new_origin, o)
    d = vm.where(survived, new_dir, d)
    throughput = jnp.where(survived[:, None], new_throughput, throughput)
    alive = survived
    return o, d, throughput, radiance, alive, collapsed


def _upsample_device(rgb, lam):
    """Device-side Smits upsample: blend the resampled basis spectra sampled
    at each ray's wavelengths.  rgb (N,3) in [0, scale]; lam (N,W) → (N,W)."""
    basis = cl._SMITS_RESAMPLED

    def at(name):
        return cl.sample_spd(jnp.asarray(basis[name]), lam)

    white = at("white")
    cyan = at("cyan")
    magenta = at("magenta")
    yellow = at("yellow")
    red = at("red")
    green = at("green")
    blue = at("blue")

    scale = jnp.maximum(jnp.max(rgb, axis=-1, keepdims=True), 1.0)
    rgbn = rgb / scale
    r, g, b = rgbn[:, 0:1], rgbn[:, 1:2], rgbn[:, 2:3]

    out = jnp.zeros_like(white)
    c1 = (r <= g) & (g <= b)
    out = jnp.where(c1, r * white + (g - r) * cyan + (b - g) * blue, out)
    c2 = (r <= b) & (b < g)
    out = jnp.where(c2, r * white + (b - r) * cyan + (g - b) * green, out)
    c3 = (g < r) & (r <= b)
    out = jnp.where(c3, g * white + (r - g) * magenta + (b - r) * blue, out)
    c4 = (g <= b) & (b < r)
    out = jnp.where(c4, g * white + (b - g) * magenta + (r - b) * red, out)
    c5 = (b < r) & (r <= g)
    out = jnp.where(c5, b * white + (r - b) * yellow + (g - r) * green, out)
    c6 = (b < g) & (g < r)
    out = jnp.where(c6, b * white + (g - b) * yellow + (r - g) * red, out)
    return jnp.maximum(out * scale, 0.0)
