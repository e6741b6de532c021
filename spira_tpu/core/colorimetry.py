"""Colorimetry: CIE color matching, RGB↔SPD conversion, wavelength grids.

Spectral rendering is a capability the reference only *claims* in its docs
(`/root/reference/README.md:10`, SURVEY.md §0) — this subsystem is new-build,
designed for an accelerator: smooth analytic CMF fits (pure elementwise
math, no table gathers in the hot path) and small per-material SPD tables.

Public-constant sources:
  * CIE 1931 2° color matching functions — multi-lobe piecewise-Gaussian fits
    from Wyman, Sloan & Shirley, "Simple Analytic Approximations to the CIE XYZ
    Color Matching Functions", JCGT 2013 (published constants).
  * RGB→reflectance-SPD basis — Smits, "An RGB to Spectrum Conversion for
    Reflectances", 1999 (published 10-bin basis spectra).
  * XYZ→linear-sRGB matrix — IEC 61966-2-1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Visible range integrated by the spectral renderer (nm).
LAMBDA_MIN = 380.0
LAMBDA_MAX = 730.0
LAMBDA_RANGE = LAMBDA_MAX - LAMBDA_MIN

#: wavelengths carried per path (hero + 3 stratified rotations)
N_WAVELENGTHS = 4

#: bins of per-material SPD tables
N_SPD_BINS = 24

SPD_GRID = np.linspace(LAMBDA_MIN, LAMBDA_MAX, N_SPD_BINS).astype(np.float32)


def _gauss(x, mu, s1, s2):
    """Piecewise Gaussian of Wyman et al.: σ = s1 below μ, s2 above."""
    s = jnp.where(x < mu, s1, s2)
    t = (x - mu) / s
    return jnp.exp(-0.5 * t * t)


def cmf_xyz_components(lam):
    """CIE 1931 2° (x̄, ȳ, z̄) at wavelengths ``lam`` (nm, any shape) as a
    tuple of three same-shape arrays — pure elementwise ops, safe inside
    Pallas kernels (no minor-dim-3 stack).  Wyman et al. 2013 fits."""
    x = (
        1.056 * _gauss(lam, 599.8, 37.9, 31.0)
        + 0.362 * _gauss(lam, 442.0, 16.0, 26.7)
        - 0.065 * _gauss(lam, 501.1, 20.4, 26.2)
    )
    y = 0.821 * _gauss(lam, 568.8, 46.9, 40.5) + 0.286 * _gauss(
        lam, 530.9, 16.3, 31.1
    )
    z = 1.217 * _gauss(lam, 437.0, 11.8, 36.0) + 0.681 * _gauss(
        lam, 459.0, 26.0, 13.8
    )
    return x, y, z


def cmf_xyz(lam):
    """CIE 1931 2° x̄,ȳ,z̄ at wavelengths ``lam`` (nm, any shape).

    Returns (..., 3).  Wyman et al. 2013 multi-lobe fits.
    """
    return jnp.stack(cmf_xyz_components(lam), axis=-1)


def _y_integral() -> float:
    lam = np.linspace(LAMBDA_MIN, LAMBDA_MAX, 1024)
    y = np.asarray(cmf_xyz(jnp.asarray(lam)))[:, 1]
    return float(np.trapezoid(y, lam))


#: ∫ȳ(λ)dλ over the integration range — the luminance normalizer so a flat
#: unit spectrum has Y = 1.
Y_INTEGRAL = _y_integral()

# IEC 61966-2-1 XYZ → linear sRGB.
XYZ_TO_SRGB = np.asarray(
    [
        [3.2406, -1.5372, -0.4986],
        [-0.9689, 1.8758, 0.0415],
        [0.0557, -0.2040, 1.0570],
    ],
    np.float32,
)

#: Componentwise E→D65 adaptation: our emitters/sky are upsampled against an
#: equal-energy illuminant; scaling XYZ by the D65 white point makes a flat
#: spectrum land on sRGB (1,1,1).
D65_WHITE = np.asarray([0.95047, 1.0, 1.08883], np.float32)


def xyz_to_rgb(xyz):
    """(..., 3) XYZ → linear sRGB with E→D65 adaptation."""
    adapted = xyz * jnp.asarray(D65_WHITE)
    return jnp.einsum(
        "...j,ij->...i", adapted, jnp.asarray(XYZ_TO_SRGB),
        precision=jax.lax.Precision.HIGHEST,
    )


def spectrum_to_xyz(values, lam):
    """MC estimate of XYZ from spectral samples.

    values: (..., W) radiance at wavelengths lam (..., W) drawn uniformly
    over [LAMBDA_MIN, LAMBDA_MAX) — pdf 1/range; normalized by ∫ȳ.
    """
    cmf = cmf_xyz(lam)  # (..., W, 3)
    est = jnp.mean(values[..., None] * cmf, axis=-2) * (
        LAMBDA_RANGE / Y_INTEGRAL
    )
    return est


# ----------------------------------------------------------------------------
# Smits RGB → reflectance SPD
# ----------------------------------------------------------------------------

_SMITS_GRID = np.linspace(380.0, 720.0, 10)
_SMITS = {
    "white": [1.0000, 1.0000, 0.9999, 0.9993, 0.9992, 0.9998, 1.0000, 1.0000, 1.0000, 1.0000],
    "cyan": [0.9710, 0.9426, 1.0007, 1.0007, 1.0007, 1.0007, 0.1564, 0.0000, 0.0000, 0.0000],
    "magenta": [1.0000, 1.0000, 0.9685, 0.2229, 0.0000, 0.0458, 0.8369, 1.0000, 1.0000, 0.9959],
    "yellow": [0.0001, 0.0000, 0.1088, 0.6651, 1.0000, 1.0000, 0.9996, 0.9586, 0.9685, 0.9840],
    "red": [0.1012, 0.0515, 0.0000, 0.0000, 0.0000, 0.0000, 0.8325, 1.0149, 1.0149, 1.0149],
    "green": [0.0000, 0.0000, 0.0273, 0.7937, 1.0000, 0.9418, 0.1719, 0.0000, 0.0000, 0.0025],
    "blue": [1.0000, 1.0000, 0.8916, 0.3323, 0.0000, 0.0000, 0.0003, 0.0369, 0.0483, 0.0496],
}


def _smits_on_grid(grid: np.ndarray) -> dict:
    return {
        k: np.interp(grid, _SMITS_GRID, np.asarray(v)).astype(np.float32)
        for k, v in _SMITS.items()
    }


_SMITS_RESAMPLED = _smits_on_grid(SPD_GRID)


def rgb_to_spd(rgb: np.ndarray, grid: np.ndarray | None = None) -> np.ndarray:
    """Smits' RGB → smooth reflectance spectrum on ``grid`` (host-side NumPy).

    rgb: (..., 3) in [0, ∞) — values above 1 scale the unit-domain result.
    Returns (..., K) with K = len(grid).
    """
    basis = (
        _SMITS_RESAMPLED if grid is None else _smits_on_grid(np.asarray(grid))
    )
    k = len(next(iter(basis.values())))
    rgb = np.asarray(rgb, np.float64)
    scale = np.maximum(rgb.max(axis=-1, keepdims=True), 1.0)
    r, g, b = (rgb / scale)[..., 0], (rgb / scale)[..., 1], (rgb / scale)[..., 2]
    out = np.zeros(rgb.shape[:-1] + (k,))

    def B(name):
        return basis[name]

    # Smits' algorithm: six orderings of (r, g, b).
    out = np.where(
        ((r <= g) & (g <= b))[..., None],
        r[..., None] * B("white") + (g - r)[..., None] * B("cyan") + (b - g)[..., None] * B("blue"),
        out,
    )
    out = np.where(
        ((r <= b) & (b < g))[..., None],
        r[..., None] * B("white") + (b - r)[..., None] * B("cyan") + (g - b)[..., None] * B("green"),
        out,
    )
    out = np.where(
        ((g < r) & (r <= b))[..., None],
        g[..., None] * B("white") + (r - g)[..., None] * B("magenta") + (b - r)[..., None] * B("blue"),
        out,
    )
    out = np.where(
        ((g <= b) & (b < r))[..., None],
        g[..., None] * B("white") + (b - g)[..., None] * B("magenta") + (r - b)[..., None] * B("red"),
        out,
    )
    out = np.where(
        ((b < r) & (r <= g))[..., None],
        b[..., None] * B("white") + (r - b)[..., None] * B("yellow") + (g - r)[..., None] * B("green"),
        out,
    )
    out = np.where(
        ((b < g) & (g < r))[..., None],
        b[..., None] * B("white") + (g - b)[..., None] * B("yellow") + (r - g)[..., None] * B("red"),
        out,
    )
    return np.clip(out * scale[..., :], 0.0, None).astype(np.float32)


def sample_spd(table, lam):
    """Linearly interpolate SPD ``table`` at wavelengths ``lam`` on SPD_GRID.

    Two layouts: a shared 1-D table (K,) sampled at any-shaped ``lam``, or
    batched tables (..., K) with per-batch wavelengths (..., W) sharing
    leading dims.  jnp, differentiable in ``table``.
    """
    k = table.shape[-1]
    pos = (lam - LAMBDA_MIN) / (LAMBDA_MAX - LAMBDA_MIN) * (k - 1)
    pos = jnp.clip(pos, 0.0, k - 1.0)
    i0 = jnp.floor(pos).astype(jnp.int32)
    i1 = jnp.minimum(i0 + 1, k - 1)
    w = pos - i0.astype(pos.dtype)
    if table.ndim == 1:
        v0 = table[i0]
        v1 = table[i1]
    else:
        v0 = jnp.take_along_axis(table, i0, axis=-1)
        v1 = jnp.take_along_axis(table, i1, axis=-1)
    return v0 * (1.0 - w) + v1 * w


# ----------------------------------------------------------------------------
# Chebyshev SPD compression (for the fused spectral engine)
# ----------------------------------------------------------------------------
#: Chebyshev degree used by the fused spectral tracer — evaluation is a
#: D-step recurrence of elementwise ops, so SPDs become per-material scalar
#: coefficient sets instead of gather-indexed tables.
N_CHEB = 12


def _lambda_to_unit(lam):
    """Map [LAMBDA_MIN, LAMBDA_MAX] → [-1, 1]."""
    return 2.0 * (lam - LAMBDA_MIN) / (LAMBDA_MAX - LAMBDA_MIN) - 1.0


def chebyshev_fit(table: np.ndarray, degree: int = N_CHEB) -> np.ndarray:
    """Least-squares Chebyshev fit of SPD tables.

    table: (..., K) values on SPD_GRID → coeffs (..., degree).  Host-side
    NumPy (runs once at scene pack time).
    """
    table = np.asarray(table, np.float64)
    x = _lambda_to_unit(SPD_GRID.astype(np.float64))
    # Vandermonde of Chebyshev polynomials T_0..T_{degree-1} at the grid.
    v = np.polynomial.chebyshev.chebvander(x, degree - 1)  # (K, D)
    coeffs, *_ = np.linalg.lstsq(v, table.reshape(-1, table.shape[-1]).T,
                                 rcond=None)
    return np.ascontiguousarray(
        coeffs.T.reshape(table.shape[:-1] + (degree,))
    ).astype(np.float32)


def chebyshev_eval(coeffs, lam):
    """Evaluate Chebyshev coefficients at wavelengths.

    coeffs: sequence of D broadcastable scalars/arrays (or an (..., D)
    array); lam: any shape.  Pure elementwise jnp — usable inside Pallas.
    """
    x = _lambda_to_unit(lam)
    if hasattr(coeffs, "shape"):
        coeffs = [coeffs[..., i] for i in range(coeffs.shape[-1])]
    # Clenshaw recurrence.
    b1 = jnp.zeros_like(x)
    b2 = jnp.zeros_like(x)
    for c in reversed(coeffs[1:]):
        b1, b2 = 2.0 * x * b1 - b2 + c, b1
    return x * b1 - b2 + coeffs[0]


#: Chebyshev coefficients of the Smits basis spectra (for device-side
#: upsampling of the analytic sky gradient, where r <= g <= b always holds).
SMITS_CHEB = {
    name: chebyshev_fit(vals[None, :])[0]
    for name, vals in _SMITS_RESAMPLED.items()
}
