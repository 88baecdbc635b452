"""Exterior screened-harmonic (Bessel-K modal) obstacle correction.

Makes the deterministic DCT projection (sim/spectral.py) exact on
circle-obstacle scenes (karman): the box solve p0 satisfies the PDE and
the wall Neumann conditions but leaves a normal-derivative residual
dp0/dr on the obstacle circle. The homogeneous screened equation
(Lap q = sigma q) separates in polar coordinates around the circle
center into exterior-decaying modes

    q(r, theta) = sum_m rho_m(r) (A_m cos m theta + B_m sin m theta),
    rho_m(r)    = K_m(sqrt(sigma) r) / K_m(sqrt(sigma) a),

so cancelling the residual is a per-mode DIAGONAL solve — no boundary
element machinery, no Monte Carlo. With sigma = 350 the correction
decays over 1/sqrt(sigma) ~= 0.053 length units, so its own wall
Neumann violation is O(e^{-sqrt(sigma) dist(circle, wall)}) ~ 5e-5 for
the karman geometry and a single pass suffices.

The reference has no counterpart — it handles obstacles only through
the MC walk (walk_on_stars.h:135-329); this is a deterministic fast
path: an FFT-sized fit on the circle plus (N points x M modes) dense
work.

Numerics: K_m overflows f32 past m ~ 30, so everything is expressed in
overflow-free ratios: rho_m (normalized at the circle, computed by the
upward recurrence — K_m is the dominant solution in m, so it is
stable), tau_m(z) = K_{m-1}(z)/K_m(z) by its continued-fraction
recurrence, and f64 scipy.special.kve on the host for the static-z0
constants (radius and sigma are static scene attributes)."""
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import scipy.special as _sps

from .bessel import k0e, k1e


def _host_consts(z0: float, n_modes: int):
    """Static per-mode f64 constants at the circle argument z0:
    d1[i] = K_{i-1}(z0)/K_{i+1}(z0) and d2[i] = K_i(z0)/K_{i+1}(z0)
    (recurrence couplings; i = 0 entries are unused dummies), and
    s[m] = K'_m(z0)/K_m(z0) (logarithmic derivative, < 0)."""
    m = np.arange(0, n_modes + 1)
    kv = _sps.kve(m, z0)                  # K_m(z0) e^{z0}
    d1 = np.ones(n_modes)
    d2 = np.ones(n_modes)
    d1[1:] = kv[0:n_modes - 1] / kv[2:n_modes + 1]
    d2[1:] = kv[1:n_modes] / kv[2:n_modes + 1]
    # K'_m = -(K_{m-1} + K_{m+1})/2, with K_{-1} = K_1
    km1 = np.concatenate([[kv[1]], kv[:n_modes - 1]])
    s = -(km1 + kv[1:n_modes + 1]) / (2.0 * kv[:n_modes])
    s[0] = -kv[1] / kv[0]
    return d1, d2, s


def _mode_tables(pts, center, radius, sigma, n_modes):
    """rho_m(r), lam_m(z) = K'_m(z)/K_m(z), and the angle harmonics for
    every point; returns (r, theta, rhos (N,M), lams (N,M))."""
    rs = math.sqrt(sigma)
    z0 = rs * radius
    d1, d2, _ = _host_consts(z0, n_modes)
    k0z0 = float(_sps.k0e(z0))
    k1z0 = float(_sps.k1e(z0))

    d = pts - jnp.asarray(center, pts.dtype)
    r = jnp.maximum(jnp.linalg.norm(d, axis=-1), radius)
    theta = jnp.arctan2(d[..., 1], d[..., 0])
    z = rs * r
    expd = jnp.exp(z0 - z)
    k0z, k1z = k0e(z), k1e(z)
    rho = [k0z / k0z0 * expd, k1z / k1z0 * expd]
    tau = [None, k0z / k1z]               # tau_m = K_{m-1}/K_m at z
    for i in range(1, n_modes):
        rho.append(float(d1[i]) * rho[i - 1]
                   + (2.0 * i / z) * float(d2[i]) * rho[i])
        tau.append(1.0 / (tau[i] + 2.0 * i / z))
    lams = [-1.0 / tau[1]] + [-(tau[m] + m / z) for m in range(1, n_modes)]
    rhos = jnp.stack(rho[:n_modes], axis=-1)
    return r, theta, rhos, jnp.stack(lams, axis=-1)


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def fit_circle_correction(g_grid, scene_size, center, radius, sigma,
                          n_modes=32, n_bdry=512):
    """Fit the modal coefficients cancelling the obstacle Neumann
    residual of a box solve. g_grid: (res_x, res_y, 2) gradient of the
    DCT solution p0 on the cell-centered grid. Returns (A, B) cosine /
    sine coefficients with unit radial basis at the circle."""
    from ..sim.sampling import bilinear_lookup
    z0 = math.sqrt(sigma) * radius
    _, _, s = _host_consts(z0, n_modes)
    theta = (2.0 * math.pi / n_bdry) * jnp.arange(n_bdry)
    ct, st = jnp.cos(theta), jnp.sin(theta)
    pts = jnp.stack([center[0] + radius * ct,
                     center[1] + radius * st], axis=-1)
    gx = bilinear_lookup(g_grid[..., 0], scene_size, pts)
    gy = bilinear_lookup(g_grid[..., 1], scene_size, pts)
    h = -(gx * ct + gy * st)          # want dr(p0 + q) = 0 at r = a
    m = jnp.arange(n_modes)
    cos_mt = jnp.cos(m[:, None] * theta[None, :])     # (M, B)
    sin_mt = jnp.sin(m[:, None] * theta[None, :])
    scale = jnp.where(m == 0, 1.0 / n_bdry, 2.0 / n_bdry)
    dot = partial(jnp.dot, precision=jax.lax.Precision.HIGHEST)
    h_cos = scale * dot(cos_mt, h)
    h_sin = scale * dot(sin_mt, h)
    # dr q(a, theta) = sum_m sqrt(sigma) s_m (A_m cos + B_m sin) = h
    denom = math.sqrt(sigma) * jnp.asarray(s, h_cos.dtype)
    return h_cos / denom, h_sin / denom


@partial(jax.jit, static_argnums=(2, 3, 4, 5))
def eval_circle_correction(coeffs, pts, center, radius, sigma,
                           n_modes=32):
    """Evaluate (q, grad q) at pts (N, 2). Points inside the circle
    evaluate at the clamped radius — they are zeroed downstream by the
    boundary masking (grid.h:207-237 semantics)."""
    A, B = coeffs
    r, theta, rhos, lams = _mode_tables(pts, center, radius, sigma,
                                        n_modes)
    rs = math.sqrt(sigma)
    mvals = jnp.arange(n_modes, dtype=pts.dtype)
    cos_mt = jnp.cos(theta[:, None] * mvals[None, :])   # (N, M)
    sin_mt = jnp.sin(theta[:, None] * mvals[None, :])
    ang = A[None, :] * cos_mt + B[None, :] * sin_mt
    dang = mvals[None, :] * (-A[None, :] * sin_mt + B[None, :] * cos_mt)
    q = jnp.sum(rhos * ang, axis=-1)
    dq_dr = rs * jnp.sum(rhos * lams * ang, axis=-1)
    dq_dt = jnp.sum(rhos * dang, axis=-1)
    ct, st = jnp.cos(theta), jnp.sin(theta)
    gx = dq_dr * ct - dq_dt * st / r
    gy = dq_dr * st + dq_dt * ct / r
    return q, jnp.stack([gx, gy], axis=-1)
