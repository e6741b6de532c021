"""BSDF sampling (scatter) over a wavefront of hits.

Two scatter models, selected by the integrator's ``semantics`` switch
(SURVEY.md §7 "two reference semantics to choose between"):

* ``physical`` — the radiometrically faithful model of the standalone MSL
  megakernel (`/root/reference/src/spira_path_trace_kernel.metal:218-243`):
  lobe select by ``u < metallic``; metal = mirror + roughness·(uniform unit
  vector); diffuse = cosine-weighted hemisphere; extended here with a
  dielectric lobe (Schlick Fresnel reflect/refract) the reference only claims
  in docs.
* ``reference`` — bug-compatible with the CPU fallback renderer
  (`/root/reference/src/spira-metal-optimized.jl:1396-1407`): diffuse
  direction = normalize(normal + normalize(box-0.5)), metal perturbation =
  roughness·(box-0.5) *unnormalized*, and the 0.5 diffuse darkening factor is
  applied by the integrator.  Used for golden-image parity with the
  reference (BASELINE.json config 1).

Everything is branch-free masked select — no per-ray control flow.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import rng as srng
from ..core import vecmath as vm


def one_hot_rows(idx, count):
    """(N, count) float32 one-hot of int indices."""
    return (idx[:, None] == jnp.arange(count, dtype=idx.dtype)[None, :]).astype(
        jnp.float32
    )


def take_rows(one_hot, table):
    """rows[i] = table[idx[i]] as a one-hot product; table (M,) or (M, K).

    At ``Precision.HIGHEST`` the product selects rows exactly (1*x + 0*y =
    x in float32) and its transpose is a deterministic product too, where a
    gather's would scatter-add with atomics.  At default precision a GPU
    would run it in TF32 and round the selected values to ~3 digits.
    """
    return jnp.matmul(one_hot, table, precision=jax.lax.Precision.HIGHEST)


def gather_materials(materials, mat_idx):
    """Per-ray material fields from per-ray 0-based material indices
    (one-hot row selection, see :func:`take_rows`)."""
    oh = one_hot_rows(mat_idx, materials.count)
    cauchy = (
        materials.cauchy_b
        if materials.cauchy_b is not None
        else materials.ior * 0.0
    )
    return {
        "albedo": take_rows(oh, materials.albedo),
        "emission": take_rows(oh, materials.emission),
        "metallic": take_rows(oh, materials.metallic),
        "roughness": take_rows(oh, materials.roughness),
        "ior": take_rows(oh, materials.ior),
        "transmission": take_rows(oh, materials.transmission),
        "cauchy_b": take_rows(oh, cauchy),
    }


def scatter_physical(skey, bounce_idx, d_in, normal_out, mat):
    """Sample scatter directions for the faithful model.

    Args:
      skey: per-sample RNG key; draws are folded with (bounce_idx, stream).
      d_in: (N,3) unit incoming directions.
      normal_out: (N,3) outward geometric normals.
      mat: gathered material dict.
    Returns (new_dir (N,3), attenuation (N,3)).
    """
    n_rays = d_in.shape[0]
    entering = vm.dot(d_in, normal_out) < 0.0
    n_ff = vm.where(entering, normal_out, -normal_out)

    k_lobe = srng.bounce_key(skey, bounce_idx, srng.Stream.LOBE_SELECT)
    u = srng.uniform(k_lobe, (n_rays, 3))
    u_lobe, u_trans, u_fresnel = u[:, 0], u[:, 1], u[:, 2]

    specular_sel = u_lobe < mat["metallic"]

    mirror = vm.normalize(vm.reflect(d_in, n_ff))
    k_fuzz = srng.bounce_key(skey, bounce_idx, srng.Stream.METAL_FUZZ)
    fuzz = srng.unit_vector(k_fuzz, (n_rays,))
    fuzzed = vm.normalize(mirror + mat["roughness"][:, None] * fuzz)

    # Dielectric sub-lobe: with probability `transmission`, the specular lobe
    # behaves as glass (Fresnel-weighted reflect/refract) instead of metal.
    eta = jnp.where(entering, 1.0 / mat["ior"], mat["ior"])
    refracted, tir = vm.refract(d_in, n_ff, eta[:, None])
    refracted = vm.normalize(refracted)
    cos_i = jnp.clip(-vm.dot(d_in, n_ff), 0.0, 1.0)
    r0 = ((1.0 - mat["ior"]) / (1.0 + mat["ior"])) ** 2
    schlick = r0 + (1.0 - r0) * (1.0 - cos_i) ** 5
    reflect_choice = tir | (u_fresnel < schlick)
    glass_dir = vm.where(reflect_choice, fuzzed, refracted)

    is_glass = specular_sel & (u_trans < mat["transmission"])
    spec_dir = vm.where(is_glass, glass_dir, fuzzed)

    k_diff = srng.bounce_key(skey, bounce_idx, srng.Stream.DIFFUSE_DIR)
    diffuse_dir = srng.cosine_hemisphere(k_diff, n_ff)

    new_dir = vm.where(specular_sel, spec_dir, diffuse_dir)
    attenuation = mat["albedo"]
    return new_dir, attenuation


def scatter_reference(skey, bounce_idx, d_in, normal_out, mat):
    """Bug-compatible scatter of `render_with_cpu`
    (`/root/reference/src/spira-metal-optimized.jl:1396-1407`).

    Returns (new_dir, attenuation) — attenuation includes the 0.5 diffuse
    factor the reference applies (`:1401`).
    """
    n_rays = d_in.shape[0]
    k_lobe = srng.bounce_key(skey, bounce_idx, srng.Stream.LOBE_SELECT)
    u_lobe = srng.uniform(k_lobe, (n_rays,))
    # Julia: `rand() > metallic` → diffuse.
    diffuse_sel = u_lobe > mat["metallic"]

    k_diff = srng.bounce_key(skey, bounce_idx, srng.Stream.DIFFUSE_DIR)
    box = srng.uniform_box3(k_diff, (n_rays,)) - 0.5
    unit = vm.normalize(box)  # normalize(rand(Vec3) - 0.5), `:1399`
    diffuse_dir = vm.normalize(normal_out + unit)

    k_fuzz = srng.bounce_key(skey, bounce_idx, srng.Stream.METAL_FUZZ)
    fuzz_box = srng.uniform_box3(k_fuzz, (n_rays,)) - 0.5  # unnormalized, `:1404`
    mirror = vm.reflect(d_in, normal_out)
    metal_dir = vm.normalize(mirror + mat["roughness"][:, None] * fuzz_box)

    new_dir = vm.where(diffuse_sel, diffuse_dir, metal_dir)
    attenuation = jnp.where(
        diffuse_sel[:, None], mat["albedo"] * 0.5, mat["albedo"]
    )
    return new_dir, attenuation


def sky_color(directions):
    """Sky gradient shared by every reference integrator
    (`/root/reference/src/spira_path_trace_kernel.metal:196-199`)."""
    t = 0.5 * (directions[..., 1] + 1.0)
    white = jnp.ones(3, directions.dtype)
    blue = jnp.asarray([0.5, 0.7, 1.0], directions.dtype)
    return (1.0 - t)[..., None] * white + t[..., None] * blue
