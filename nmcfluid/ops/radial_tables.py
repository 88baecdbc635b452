"""Inverse-CDF tables for Green's-function in-ball radius sampling.

The reference rejection-samples the radial density with an empirical
envelope bound and up to 1000 attempts (distributions.h:362-409,590-599).
That bound becomes catastrophically loose at large sqrt(lam)*R (acceptance
~1% for the fluid's sigma=350 on scene-sized balls), so a fixed small
attempt count would bias the source term. Instead we tabulate the
inverse CDF of the *scale-free* radial density of t = r/R, parameterized by
Z = sqrt(lam)*R, once per (dim, lam) in float64 on the host, and sample
with one uniform + a bilinear gather — exact to table resolution, O(1)
per draw, no data-dependent looping.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp

_N_Z = 128           # log-spaced Z rows
_N_U = 257           # quantile columns
_Z_MIN, _Z_MAX = 1e-3, 4e3
_N_S = 8193          # integration grid per row


def _scaled_g2d(t, Z):
    """e^{z} * 2pi * G_ball2D(r)|_{r=tR} up to positive factors (f64)."""
    import scipy.special as sp
    z = Z * t
    return sp.k0e(z) - sp.i0e(z) * (sp.k0e(Z) / sp.i0e(Z)) * np.exp(
        2.0 * (z - Z))


def _scaled_g3d(t, Z):
    import scipy.special as sp  # noqa: F401  (parallel structure)
    z = Z * t
    sh = lambda x: -np.expm1(-2.0 * x) / 2.0   # e^{-x} sinh x
    return (1.0 - (sh(z) / sh(Z)) * np.exp(2.0 * (z - Z))) / np.maximum(
        t, 1e-12)


def build_table(dim: int) -> np.ndarray:
    """(N_Z, N_U) table of t = r/R quantiles for the screened density."""
    zs = np.geomspace(_Z_MIN, _Z_MAX, _N_Z)
    us = np.linspace(0.0, 1.0, _N_U)
    s = np.linspace(1e-7, 1.0, _N_S)
    out = np.empty((_N_Z, _N_U))
    for i, Z in enumerate(zs):
        g = _scaled_g2d(s, Z) if dim == 2 else _scaled_g3d(s, Z)
        # radial density ~ s^{dim-1} * G * e^{-z}; e^{-z} = e^{-Z s}
        rho = np.maximum(s ** (dim - 1) * g * np.exp(-Z * s), 0.0)
        cdf = np.concatenate([[0.0], np.cumsum((rho[1:] + rho[:-1])
                                               * np.diff(s) / 2.0)])
        cdf /= cdf[-1]
        # strictly increasing for interpolation
        cdf = np.maximum.accumulate(cdf)
        out[i] = np.interp(us, cdf, s)
    return out


def build_harmonic2d_table() -> np.ndarray:
    """(N_U,) quantiles of the 2D harmonic radial density 4t*ln(1/t)."""
    us = np.linspace(0.0, 1.0, _N_U)
    s = np.linspace(1e-7, 1.0, _N_S)
    rho = np.maximum(-4.0 * s * np.log(s), 0.0)
    cdf = np.concatenate([[0.0], np.cumsum((rho[1:] + rho[:-1])
                                           * np.diff(s) / 2.0)])
    cdf /= cdf[-1]
    cdf = np.maximum.accumulate(cdf)
    return np.interp(us, cdf, s)


_LOG_Z_MIN = math.log(_Z_MIN)
_DLOG = (math.log(_Z_MAX) - _LOG_Z_MIN) / (_N_Z - 1)


def pack_quads(table: np.ndarray) -> np.ndarray:
    """(N_Z, N_U) -> (N_Z-1, N_U-1, 4) bilinear quads [t00, t01, t10, t11].

    Packing the four bilinear neighbors contiguously turns the per-draw
    lookup into ONE gather of a 4-float row instead of four scattered
    element gathers. Values are identical to the unpacked lookup."""
    return np.ascontiguousarray(np.stack(
        [table[:-1, :-1], table[:-1, 1:], table[1:, :-1], table[1:, 1:]],
        axis=-1))


def pack_pairs(table: np.ndarray) -> np.ndarray:
    """(N_U,) -> (N_U-1, 2) linear-interp pairs (same rationale)."""
    return np.ascontiguousarray(np.stack([table[:-1], table[1:]], axis=-1))


def sample_t_screened(table_quads, Z, key):
    """Sample t = r/R via bilinear inverse-CDF lookup. Z, out: same shape."""
    return sample_t_screened_u(table_quads, Z,
                               jax.random.uniform(key, Z.shape))


def sample_t_screened_u(table_quads, Z, u):
    """As sample_t_screened but from a caller-supplied uniform draw.
    `table_quads` is pack_quads(build_table(dim)); one gather per draw."""
    tq = jnp.asarray(table_quads)  # host tables convert per-trace
    zi = (jnp.log(jnp.clip(Z, _Z_MIN, _Z_MAX)) - _LOG_Z_MIN) / _DLOG
    i0 = jnp.clip(jnp.floor(zi).astype(jnp.int32), 0, _N_Z - 2)
    wi = jnp.clip(zi - i0, 0.0, 1.0)
    uj = u * (_N_U - 1)
    j0 = jnp.clip(jnp.floor(uj).astype(jnp.int32), 0, _N_U - 2)
    wj = uj - j0
    q = tq[i0, j0]                                  # (..., 4), one gather
    return ((1 - wi) * ((1 - wj) * q[..., 0] + wj * q[..., 1])
            + wi * ((1 - wj) * q[..., 2] + wj * q[..., 3]))


def sample_t_screened_u_mm(table, Z, u):
    """As sample_t_screened_u but table-GATHER-FREE: `table` is the RAW
    (N_Z, N_U) build_table(dim) output (f32).

    The same bilinear lookup expressed as a two-nonzero masked row
    times the table: a matmul in place of per-lane gathers. It was
    chosen on another accelerator and is not yet timed against the
    plain gather on the GPU.

    Contraction order is u-interp FIRST, then Z-interp — the reference
    combine order — and the masked rows have exactly two nonzeros, so
    the result matches the 4-gather bilinear lookup to ~1 ulp (matmul
    FMAs leave the product unrounded before the add). Irrelevant to an MC
    estimator; asserted in tests/test_greens.py.
    """
    tj = jnp.asarray(table)
    zi = (jnp.log(jnp.clip(Z, _Z_MIN, _Z_MAX)) - _LOG_Z_MIN) / _DLOG
    i0 = jnp.clip(jnp.floor(zi).astype(jnp.int32), 0, _N_Z - 2)
    wi = jnp.clip(zi - i0, 0.0, 1.0)
    uj = u * (_N_U - 1)
    j0 = jnp.clip(jnp.floor(uj).astype(jnp.int32), 0, _N_U - 2)
    wj = uj - j0
    lanes = jax.lax.broadcasted_iota(jnp.int32, u.shape + (_N_U,), u.ndim)
    w = (jnp.where(lanes == j0[..., None], (1.0 - wj)[..., None], 0.0)
         + jnp.where(lanes == j0[..., None] + 1, wj[..., None], 0.0))
    P = jnp.einsum("...l,il->...i", w, tj,
                   precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32)       # (..., N_Z)
    rows = jax.lax.broadcasted_iota(jnp.int32, Z.shape + (_N_Z,), Z.ndim)
    zsel = (jnp.where(rows == i0[..., None], (1.0 - wi)[..., None], 0.0)
            + jnp.where(rows == i0[..., None] + 1, wi[..., None], 0.0))
    return jnp.sum(P * zsel, axis=-1)


def sample_t_harmonic2d_u_mm(table, u):
    """Gather-free u-quantile interp of the RAW (N_U,) harmonic table:
    a two-nonzero mask dotted with the broadcast table (pure VPU work,
    no gather at all). Bit-identical to the pack_pairs lookup."""
    h = jnp.asarray(table)
    uj = u * (_N_U - 1)
    j0 = jnp.clip(jnp.floor(uj).astype(jnp.int32), 0, _N_U - 2)
    wj = uj - j0
    lanes = jax.lax.broadcasted_iota(jnp.int32, u.shape + (_N_U,), u.ndim)
    w = (jnp.where(lanes == j0[..., None], (1.0 - wj)[..., None], 0.0)
         + jnp.where(lanes == j0[..., None] + 1, wj[..., None], 0.0))
    return jnp.sum(w * h, axis=-1)


def sample_t_harmonic2d(table_pairs, shape, key):
    return sample_t_harmonic2d_u(table_pairs,
                                 jax.random.uniform(key, shape))


def sample_t_harmonic2d_u(table_pairs, u):
    """`table_pairs` is pack_pairs(build_harmonic2d_table())."""
    tp = jnp.asarray(table_pairs)
    uj = u * (_N_U - 1)
    j0 = jnp.clip(jnp.floor(uj).astype(jnp.int32), 0, _N_U - 2)
    wj = uj - j0
    p = tp[j0]                                      # (..., 2), one gather
    return (1 - wj) * p[..., 0] + wj * p[..., 1]
