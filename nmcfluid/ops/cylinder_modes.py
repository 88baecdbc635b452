"""Exterior screened-harmonic cylinder correction (karman3d's obstacle).

Completes the deterministic-obstacle family: circle (2D karman,
ops/circle_modes.py), sphere (smoke_obs, ops/sphere_modes.py), and now
the infinite y-axis cylinder of karman3d (`sdf.cylinder_xz`,
src/3d/main.py:92-94). The box solve p0 leaves a radial Neumann residual
h(theta, y) on the cylinder rho = a (rho = in-plane distance in (x, z)).
The homogeneous screened equation separates in cylindrical coordinates
with a y-cosine basis chosen to respect the cube's y-wall Neumann
conditions (zero y-derivative at y = +-Ly/2):

    q = sum_{j,m} rho^{(j)}_m(rho) [A_jm cos m theta + B_jm sin m theta]
        * cos(k_j (y - y_lo)),    k_j = j pi / Ly,
    rho^{(j)}_m(rho) = K_m(s_j rho) / K_m(s_j a),  s_j = sqrt(sigma + k_j^2)

— per-(j, m) DIAGONAL solves through a theta-DFT x y-DCT of the
residual. All the overflow-free Bessel-K ratio machinery is reused from
circle_modes (each j is a circle problem at effective screening
sigma + k_j^2). Since the cylinder meets the y-walls at right angles and
spans the full cube, the separation is exact; the correction's own wall
violation decays like e^{-sqrt(sigma) d(cyl, wall)} as in 2D.

The reference has no counterpart (its 3D pressure solve runs on the bare
cube — examples/karman3d/wost.json boundary = cube.obj).
"""
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .circle_modes import _host_consts, _mode_tables


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6, 7, 8))
def fit_cylinder_correction(g_grid, scene_size, center_xz, radius, sigma,
                            n_modes=24, n_y=12, n_theta=64, n_ys=48):
    """Fit A/B coefficients cancelling the cylinder Neumann residual.

    g_grid: (res, res, res, 3) gradient of the DCT box solve on the
    cell-centered grid (axis order x, y, z as everywhere in sim/).
    Returns (A, B) with shape (n_y, n_modes)."""
    from ..sim.sampling import bilinear_lookup
    x0, x1, y0, y1, z0_, z1_ = scene_size
    Ly = y1 - y0
    cx, cz = center_xz
    theta = (2.0 * math.pi / n_theta) * jnp.arange(n_theta)
    # y samples at cell centers of a DCT-II grid: exact cosine quadrature
    ys = y0 + (jnp.arange(n_ys) + 0.5) * (Ly / n_ys)
    ct, st = jnp.cos(theta), jnp.sin(theta)
    # surface points (n_ys, n_theta, 3)
    px = cx + radius * ct[None, :]
    pz = cz + radius * st[None, :]
    pts = jnp.stack([jnp.broadcast_to(px, (n_ys, n_theta)),
                     jnp.broadcast_to(ys[:, None], (n_ys, n_theta)),
                     jnp.broadcast_to(pz, (n_ys, n_theta))], axis=-1)
    flat = pts.reshape(-1, 3)
    gx = bilinear_lookup(g_grid[..., 0], scene_size, flat)
    gz = bilinear_lookup(g_grid[..., 2], scene_size, flat)
    h = -(gx.reshape(n_ys, n_theta) * ct[None]
          + gz.reshape(n_ys, n_theta) * st[None])   # want d_rho(p0+q)=0

    # theta-DFT
    m = jnp.arange(n_modes)
    cos_mt = jnp.cos(m[:, None] * theta[None, :])       # (M, T)
    sin_mt = jnp.sin(m[:, None] * theta[None, :])
    scale_t = jnp.where(m == 0, 1.0 / n_theta, 2.0 / n_theta)
    dot = partial(jnp.dot, precision=jax.lax.Precision.HIGHEST)
    h_cos = dot(h, cos_mt.T) * scale_t[None, :]         # (Ys, M)
    h_sin = dot(h, sin_mt.T) * scale_t[None, :]
    # y-DCT (Neumann-compatible cosines)
    j = jnp.arange(n_y)
    cos_jy = jnp.cos(j[:, None] * math.pi / Ly
                     * (ys[None, :] - y0))              # (J, Ys)
    scale_y = jnp.where(j == 0, 1.0 / n_ys, 2.0 / n_ys)
    Hc = scale_y[:, None] * dot(cos_jy, h_cos)          # (J, M)
    Hs = scale_y[:, None] * dot(cos_jy, h_sin)

    # per-j diagonal solve: d_rho q|_a = s_j * s_m(z0_j) * coeff = H
    denoms = []
    for jj in range(n_y):
        s_j = math.sqrt(sigma + (jj * math.pi / Ly) ** 2)
        _, _, s = _host_consts(s_j * radius, n_modes)
        denoms.append(s_j * np.asarray(s))
    denom = jnp.asarray(np.stack(denoms), Hc.dtype)     # (J, M)
    return Hc / denom, Hs / denom


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6, 7))
def eval_cylinder_correction(coeffs, pts, scene_size, center_xz, radius,
                             sigma, n_modes=24, n_y=12):
    """(q, grad q) at pts (N, 3). In-cylinder points evaluate at the
    clamped radius (zeroed downstream by the boundary masking)."""
    A, B = coeffs
    y0, y1 = scene_size[2], scene_size[3]
    Ly = y1 - y0
    pts_xz = jnp.stack([pts[:, 0], pts[:, 2]], axis=-1)
    y = pts[:, 1]
    q = jnp.zeros(pts.shape[0], jnp.float32)
    gx = jnp.zeros_like(q)
    gy = jnp.zeros_like(q)
    gz = jnp.zeros_like(q)
    mvals = jnp.arange(n_modes, dtype=pts.dtype)
    for jj in range(n_y):
        k_j = jj * math.pi / Ly
        sig_eff = sigma + k_j ** 2
        r, theta, rhos, lams = _mode_tables(pts_xz, center_xz, radius,
                                            sig_eff, n_modes)
        rs = math.sqrt(sig_eff)
        cos_mt = jnp.cos(theta[:, None] * mvals[None, :])
        sin_mt = jnp.sin(theta[:, None] * mvals[None, :])
        ang = A[jj][None, :] * cos_mt + B[jj][None, :] * sin_mt
        dang = mvals[None, :] * (-A[jj][None, :] * sin_mt
                                 + B[jj][None, :] * cos_mt)
        cy = jnp.cos(k_j * (y - y0))
        sy = jnp.sin(k_j * (y - y0))
        q2 = jnp.sum(rhos * ang, axis=-1)
        dq_dr = rs * jnp.sum(rhos * lams * ang, axis=-1)
        dq_dt = jnp.sum(rhos * dang, axis=-1)
        ct, st = jnp.cos(theta), jnp.sin(theta)
        q = q + q2 * cy
        gx = gx + (dq_dr * ct - dq_dt * st / r) * cy
        gz = gz + (dq_dr * st + dq_dt * ct / r) * cy
        gy = gy - k_j * q2 * sy
    return q, jnp.stack([gx, gy, gz], axis=-1)
