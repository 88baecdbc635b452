"""Exterior screened-harmonic (modified-spherical-Bessel) sphere correction.

3D analog of ops/circle_modes.py: makes the deterministic DCT projection
obstacle-aware on sphere-obstacle scenes (smoke_obs, karman3d). The box
solve p0 satisfies the PDE and the cube's Neumann walls but leaves a
normal-derivative residual dp0/dr on the obstacle sphere; the
homogeneous screened equation (Lap q = sigma q) separates around the
sphere center into exterior-decaying modes

    q(r, Omega) = sum_{l,m} c_lm rho_l(r) Y_lm(Omega),
    rho_l(r)    = k_l(sqrt(sigma) r) / k_l(sqrt(sigma) a),

with k_l the modified spherical Bessel function of the second kind and
Y_lm REAL orthonormal spherical harmonics, so cancelling the residual is
a per-mode diagonal solve.

The reference cannot offer this: its 3D pressure solves run on the bare
cube (examples/{smoke_obs,karman3d}/wost.json boundary = cube.obj) — the
obstacle only enters through the velocity hard mask — so this correction
is a physics capability beyond the reference, not a parity item.

Numerics:
  * k_l has the CLOSED FORM k_l(z) = (pi/(2z)) e^{-z} P_l(1/z) with
    P_l(u) = sum_k (l+k)!/(k!(l-k)!2^k) u^k; the ratio
    rho_l(r) = (z0/z) e^{z0-z} P_l(1/z)/P_l(1/z0) is evaluated with
    host-f64 coefficients b_lk = a_lk/P_l(1/z0): every term of the f32
    device polynomial is then <= 1 on the exterior domain z >= z0.
  * Y_lm by the fully-normalized associated-Legendre recurrences
    (standard stable three-term forms), all (l, m) loops static.
  * gradients by forward-mode autodiff of the closed-form scalar field —
    no hand-derived angular derivative recurrences to get wrong.
  * s_l = k_l'(z0)/k_l(z0) on the host in f64 from scipy kve ratios at
    half-integer order (k_l(z) = sqrt(pi/(2z)) K_{l+1/2}(z)).

With sigma = 350 the correction decays over 1/sqrt(sigma) ~ 0.053; for
smoke_obs (sphere 0.1 from the floor) the single pass leaves an
O(e^{-1.9}) ~ 15% secondary wall residual of the (already small)
correction — still a strict improvement over the uncorrected solve the
reference uses.
"""
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import scipy.special as _sps


def _poly_consts(z0: float, n_l: int):
    """Host f64: b[l][k] = a_lk / P_l(1/z0) (see module docstring) and
    s[l] = k_l'(z0)/k_l(z0)."""
    bs = []
    for l in range(n_l):
        a = np.array([math.factorial(l + k)
                      / (math.factorial(k) * math.factorial(l - k)
                         * 2.0 ** k) for k in range(l + 1)])
        p_z0 = float(np.sum(a * z0 ** (-np.arange(l + 1))))
        bs.append((a / p_z0).astype(np.float64))
    nu = np.arange(n_l) + 0.5
    kv_m = _sps.kve(nu - 1.0, z0)
    kv_0 = _sps.kve(nu, z0)
    kv_p = _sps.kve(nu + 1.0, z0)
    # k_l'/k_l = K'_nu/K_nu - 1/(2 z0),  K'_nu = -(K_{nu-1}+K_{nu+1})/2
    s = -(kv_m + kv_p) / (2.0 * kv_0) - 1.0 / (2.0 * z0)
    return bs, s


def _rho(z, z0, bs):
    """rho_l(z) for all l: (N, L)."""
    zi = 1.0 / z
    pref = (z0 / z) * jnp.exp(z0 - z)
    cols = []
    for b in bs:
        acc = jnp.zeros_like(z) + float(b[-1])
        for c in b[-2::-1]:
            acc = acc * zi + float(c)
        cols.append(pref * acc)
    return jnp.stack(cols, axis=-1)


def _real_sph_harm(ct, st, phi, n_l):
    """Real orthonormal Y_lm for l < n_l: returns (N, n_l^2), index
    j = l^2 + (m + l) with m in [-l, l] (negative m = sine harmonics)."""
    # fully-normalized associated Legendre \bar P_l^m (incl. 1/sqrt(4pi))
    P = {}
    P[(0, 0)] = jnp.full_like(ct, 1.0 / math.sqrt(4.0 * math.pi))
    for m in range(1, n_l):
        P[(m, m)] = (-math.sqrt((2 * m + 1) / (2.0 * m))
                     * st * P[(m - 1, m - 1)])
    for m in range(0, n_l - 1):
        P[(m + 1, m)] = math.sqrt(2 * m + 3) * ct * P[(m, m)]
    for m in range(0, n_l):
        for l in range(m + 2, n_l):
            a = math.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = math.sqrt(((l - 1.0) ** 2 - m * m)
                          / (4.0 * (l - 1.0) ** 2 - 1.0))
            P[(l, m)] = a * (ct * P[(l - 1, m)] - b * P[(l - 2, m)])
    cos_m = [jnp.ones_like(phi)]
    sin_m = [jnp.zeros_like(phi)]
    for m in range(1, n_l):
        cos_m.append(jnp.cos(m * phi))
        sin_m.append(jnp.sin(m * phi))
    cols = []
    r2 = math.sqrt(2.0)
    for l in range(n_l):
        for m in range(-l, l + 1):
            am = abs(m)
            base = P[(l, am)]
            if m == 0:
                cols.append(base)
            elif m > 0:
                cols.append(r2 * base * cos_m[am])
            else:
                cols.append(r2 * base * sin_m[am])
    return jnp.stack(cols, axis=-1)


def _q_scalar(x, coeffs, center, radius, sigma, n_l, bs):
    """q at a single point x (3,) — autodiffed for the gradient."""
    rs = math.sqrt(sigma)
    z0 = rs * radius
    d = x - jnp.asarray(center, x.dtype)
    r = jnp.maximum(jnp.linalg.norm(d), radius)
    ct = jnp.clip(d[2] / r, -1.0, 1.0)
    st = jnp.sqrt(jnp.maximum(1.0 - ct * ct, 1e-12))
    phi = jnp.arctan2(d[1], d[0] + 1e-30)
    rho = _rho(rs * r[None], z0, bs)[0]                  # (L,)
    Y = _real_sph_harm(ct[None], st[None], phi[None], n_l)[0]
    lidx = np.concatenate([[l] * (2 * l + 1) for l in range(n_l)])
    return jnp.sum(coeffs * rho[lidx] * Y)


@partial(jax.jit, static_argnums=(2, 3, 4, 5))
def eval_sphere_correction(coeffs, pts, center, radius, sigma, n_l=12):
    """(q, grad q) at pts (N, 3). Points inside the sphere evaluate at
    the clamped radius and are zeroed downstream by boundary masking."""
    z0 = math.sqrt(sigma) * radius
    bs, _ = _poly_consts(z0, n_l)

    def one(x):
        f = lambda y: _q_scalar(y, coeffs, center, radius, sigma, n_l, bs)
        return f(x), jax.grad(f)(x)

    return jax.vmap(one)(pts)


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6, 7))
def fit_sphere_correction(g_grid, scene_size, center, radius, sigma,
                          n_l=12, n_theta=24, n_phi=48):
    """Fit c_lm cancelling the sphere Neumann residual of a box solve.

    g_grid: (res, res, res, 3) gradient of the DCT solution on the
    cell-centered grid. Gauss-Legendre x uniform-phi quadrature projects
    h = -dp0/dr onto Y_lm; the diagonal solve divides by
    sqrt(sigma) * k_l'(z0)/k_l(z0)."""
    from ..sim.sampling import bilinear_lookup
    z0 = math.sqrt(sigma) * radius
    _, s = _poly_consts(z0, n_l)
    xg, wg = np.polynomial.legendre.leggauss(n_theta)
    ct = jnp.asarray(np.repeat(xg, n_phi), jnp.float32)
    w = jnp.asarray(np.repeat(wg, n_phi), jnp.float32) \
        * (2.0 * math.pi / n_phi)
    phi = jnp.asarray(np.tile(np.arange(n_phi) * 2.0 * math.pi / n_phi,
                              n_theta), jnp.float32)
    st = jnp.sqrt(jnp.maximum(1.0 - ct * ct, 0.0))
    nrm = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)
    pts = jnp.asarray(center, jnp.float32) + radius * nrm
    g = jnp.stack([bilinear_lookup(g_grid[..., i], scene_size, pts)
                   for i in range(3)], axis=-1)
    h = -jnp.sum(g * nrm, axis=-1)
    Y = _real_sph_harm(ct, st, phi, n_l)                 # (B, L^2)
    h_lm = jnp.dot(w * h, Y, precision=jax.lax.Precision.HIGHEST)
    lidx = np.concatenate([[l] * (2 * l + 1) for l in range(n_l)])
    denom = math.sqrt(sigma) * jnp.asarray(s, h_lm.dtype)[lidx]
    return h_lm / denom
