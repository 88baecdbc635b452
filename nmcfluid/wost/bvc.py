"""Boundary value caching (BVC): splatted re-use of boundary estimates.

Rebuild of zombie's secondary estimator
(bindings/zombie/include/zombie/boundary_value_caching/{boundary_sampler,
splatter}.h, exposed as `bvc` in demo.cpp:265-363 but never called by the
fluid loop — SURVEY.md N11): estimate the solution u AND its normal
derivative du/dn once at a cache of boundary samples with WoSt, then
evaluate anywhere by splatting through the free-space Green's function G
and Poisson kernel P (boundary-integral identity for the screened Poisson
problem):

    u(x) = sum_b alpha [G(x,y_b) du/dn(y_b) - P(x,y_b) u(y_b)] / (B pdf_b)
         + sum_s alpha  G(x,y_s) f(y_s) / (S pdf_s)
    grad u(x) = same sums through grad_x G and grad_x P
                                                  (splatter.h:208-305)

where n is the outward sample normal and alpha is 2 for evaluation points
on the boundary, 1 in the interior (splatter.h:238-241; the boundary-point
gradient is skipped, :245 "FUTURE"). On the Neumann boundary du/dn is the
known boundary data h (== 0 for the fluid projection,
boundary_sampler.h:190-196); on the Dirichlet boundary it is WoSt-estimated
as the normal-directional derivative (boundary_sampler.h:154-167, 213-216).
Kernel regularization follows splatter.h:12-41 (2D Poisson kernel
x (1 - e^{-r^2}); 3D G x erf(r), P x [erf(r) - 2r e^{-r^2}/sqrt(pi)]).

Evaluation is one dense (eval x cache) kernel contraction — a single
fused broadcast-reduce instead of zombie's per-eval-point TBB loop over
the cache.
"""
import math
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops import bessel
from .solver import (WalkSettings, WostScene,  # noqa: F401 (re-export)
                     estimate_solution, estimate_solution_and_gradient)


# ------------------------------------------------- free-space Green kernels
# Yukawa forms use exponentially scaled Bessels (ops.bessel) so sigma=350
# stays finite in f32; closed forms match distributions.h:88-270.

def _free_G(dim, lam, r):
    if dim == 2:
        if lam > 0.0:
            z = math.sqrt(lam) * r
            return bessel.k0e(z) * jnp.exp(-z) / (2.0 * jnp.pi)
        return -jnp.log(r) / (2.0 * jnp.pi)
    if lam > 0.0:
        z = math.sqrt(lam) * r
        return jnp.exp(-z) / (4.0 * jnp.pi * r)
    return 1.0 / (4.0 * jnp.pi * r)


def _free_dGdr(dim, lam, r):
    if dim == 2:
        if lam > 0.0:
            s = math.sqrt(lam)
            z = s * r
            return -s * bessel.k1e(z) * jnp.exp(-z) / (2.0 * jnp.pi)
        return -1.0 / (2.0 * jnp.pi * r)
    if lam > 0.0:
        z = math.sqrt(lam) * r
        return -jnp.exp(-z) * (1.0 + z) / (4.0 * jnp.pi * r ** 2)
    return -1.0 / (4.0 * jnp.pi * r ** 2)


def _free_dP(dim, lam, d, r, n):
    """grad_x P(x, y; n) with d = x - y (pole gradient of the Poisson
    kernel, distributions.h:112-117, 147-153, 203-214, 257-268)."""
    r = jnp.maximum(r, 1e-12)[..., None]
    ndotd = jnp.sum(n * d, axis=-1, keepdims=True)
    if dim == 2:
        if lam > 0.0:
            s = math.sqrt(lam)
            z = s * r
            e = jnp.exp(-z)
            K0, K1 = bessel.k0e(z) * e, bessel.k1e(z) * e
            Qr1 = s * K1
            # (K0 + K2)/2 = K0 + K1/z  (K2 = K0 + 2 K1/z)
            Qr2 = lam * (K0 + K1 / jnp.maximum(z, 1e-12))
            return (n * Qr1 - (ndotd / r ** 2) * (Qr1 + r * Qr2) * d) \
                / (2.0 * jnp.pi * r)
        return (n - 2.0 * (ndotd / r ** 2) * d) / (2.0 * jnp.pi * r ** 2)
    if lam > 0.0:
        s = math.sqrt(lam)
        z = s * r
        e = jnp.exp(-z)
        # P = e^{-z}(1+z)(d.n)/(4 pi r^3); grad_x P = Qr1 n - f d with
        # 2 Qr1 + Qr2 = -r^4 f'(r)-style coefficient. d/dr of
        # e^{-z}(1+z)/r^3 gives the screening polynomial z^2 + 3z + 3,
        # so Qr2 = e^{-z}(z^2 + z + 1)/r (verified against float64
        # finite differences; reduces to the harmonic 3/r split at z=0).
        Qr1 = s * e * (1.0 + 1.0 / jnp.maximum(z, 1e-12))
        Qr2 = e * (z * z + z + 1.0) / r
        return (n * Qr1 - (ndotd / r ** 2) * (2.0 * Qr1 + Qr2) * d) \
            / (4.0 * jnp.pi * r ** 2)
    return (n - 3.0 * (ndotd / r ** 2) * d) / (4.0 * jnp.pi * r ** 3)


def _regularize_P(dim, r_hat):
    """splatter.h:30-41."""
    if dim == 2:
        return 1.0 - jnp.exp(-r_hat ** 2)
    return jax.scipy.special.erf(r_hat) \
        - 2.0 * r_hat * jnp.exp(-r_hat ** 2) / math.sqrt(math.pi)


def _regularize_G(dim, r_hat):
    """splatter.h:12-27."""
    if dim == 2:
        return jnp.ones_like(r_hat)
    return jax.scipy.special.erf(r_hat)


# -------------------------------------------------------- boundary sampling

class BoundaryCache(NamedTuple):
    pts: jax.Array        # (B, D) cache positions (on the boundary)
    normals: jax.Array    # (B, D) outward (out-of-fluid) normals
    pdf: jax.Array        # (B,) sampling density w.r.t. boundary measure
    solution: jax.Array   # (B,) WoSt estimates of u at the cache
    normal_derivative: jax.Array  # (B,) du/dn: Neumann data h on the
    # Neumann boundary (boundary_sampler.h:190-196), WoSt-estimated on the
    # Dirichlet boundary (:213-216)


def sample_boundary_uniform(soup, n, key):
    """Uniform-by-length boundary samples on a Seg2D soup -> (pts, normals,
    pdf). (boundary_sampler.h uniform area sampling.)"""
    a, b, nrm = soup.a, soup.b, soup.n
    ln = jnp.linalg.norm(b - a, axis=-1)
    ln = jnp.where(ln < 1.0, ln, 0.0)          # padded slots are FAR apart
    total = jnp.sum(ln)
    k1, k2 = jax.random.split(key)
    idx = jax.random.categorical(k1, jnp.log(jnp.maximum(ln, 1e-30)), shape=(n,))
    u = jax.random.uniform(k2, (n, 1))
    pts = a[idx] + u * (b[idx] - a[idx])
    pdf = jnp.full((n,), 1.0, jnp.float32) / total
    return pts, nrm[idx], pdf


def build_cache(scene: WostScene, settings: WalkSettings, soup, n_cache,
                key, n_walks=None, offset=None, dirichlet: bool = False,
                n_walks_grad: Optional[int] = None):
    """WoSt-estimate the boundary data at cache samples (offset one epsilon
    shell into the fluid — the reference estimates the boundary limit with
    alpha = 2; the inward offset is the bias-free equivalent for the
    lockstep solver).

    Neumann caches (dirichlet=False, the fluid's case) estimate the
    solution only and take du/dn from the known Neumann data
    (boundary_sampler.h:171-175, 190-196). Dirichlet caches estimate
    solution AND gradient, caching grad . n (:154-167, 213-216)."""
    k1, k2 = jax.random.split(key)
    pts, normals, pdf = sample_boundary_uniform(soup, n_cache, k1)
    off = offset if offset is not None else 2.0 * settings.epsilon_shell
    inner = pts - off * normals
    if dirichlet:
        sol, grad, _ = estimate_solution_and_gradient(
            scene, settings, inner, k2, n_walks_grad or n_walks,
            mask_invalid=False)
        dn = jnp.sum(grad * normals, axis=-1)
    else:
        sol, n_valid, _ = estimate_solution(scene, settings, inner, k2,
                                            n_walks)
        dn = (scene.neumann_fn(pts) if scene.neumann_fn is not None
              else jnp.zeros_like(sol))
    return BoundaryCache(pts=pts, normals=normals, pdf=pdf, solution=sol,
                         normal_derivative=dn)


# --------------------------------------------------------------- evaluation

@partial(jax.jit, static_argnums=(0, 5, 6, 7, 8))
def evaluate(scene: WostScene, cache: BoundaryCache, eval_pts, src_pts,
             src_pdf, n_src_total: int, radius_clamp: float = 0.0,
             kernel_regularization: float = 0.0,
             with_gradient: bool = False, on_boundary=None, source_args=()):
    """Splat the cache (+ a Monte Carlo source sum over src_pts with
    density src_pdf) to eval_pts. Returns u(eval_pts), or
    (u, grad_u (E, D)) when with_gradient.

    `on_boundary` (E,) bool marks evaluation points on the boundary:
    their solution splat uses alpha = 2 and their gradient splat is zeroed
    (splatter.h:238-245)."""
    dim = scene.dim
    lam = float(scene.absorption)
    B = cache.pts.shape[0]
    alpha = jnp.where(on_boundary, 2.0, 1.0) if on_boundary is not None \
        else 1.0

    d = eval_pts[:, None, :] - cache.pts[None, :, :]      # (E, B, D)
    r = jnp.linalg.norm(d, axis=-1)
    r = jnp.maximum(r, radius_clamp)
    r_safe = jnp.maximum(r, 1e-12)
    G = _free_G(dim, lam, r_safe)
    dGdr = _free_dGdr(dim, lam, r_safe)
    cosang = jnp.sum(d * cache.normals[None], axis=-1) / r_safe
    # P(x, y) = dG/dr * d(r)/dn_y = dG/dr * ((y - x) . n)/r = -dGdr*cos
    P = -dGdr * cosang
    if kernel_regularization > 0.0:
        P = P * _regularize_P(dim, r / kernel_regularization)
        G = G * _regularize_G(dim, r / kernel_regularization)
    w = 1.0 / (cache.pdf[None] * B)
    h = cache.normal_derivative[None]
    contrib = (G * h - P * cache.solution[None]) * w      # (E, B)
    u_b = jnp.sum(contrib, axis=1)
    if on_boundary is not None:
        u_b = alpha * u_b

    if with_gradient:
        # NOTE: like the reference, only the VALUE kernels are
        # regularized — splatBoundaryData applies the factors to G and P
        # but uses dG/dP raw (splatter.h:232-247); near-cache gradient
        # spikes are bounded by radius_clamp alone.
        dG = (dGdr / r_safe)[..., None] * d               # grad_x G
        dP = _free_dP(dim, lam, d, r, cache.normals[None])
        g_b = jnp.sum((dG * h[..., None] - dP * cache.solution[None, :, None])
                      * w[..., None], axis=1)
        if on_boundary is not None:
            g_b = jnp.where(on_boundary[:, None], 0.0, g_b)  # splatter.h:245

    if src_pts is not None:
        ds_vec = eval_pts[:, None, :] - src_pts[None]
        ds = jnp.linalg.norm(ds_vec, axis=-1)
        ds = jnp.maximum(jnp.maximum(ds, radius_clamp), 1e-12)
        Gs = _free_G(dim, lam, ds)
        if kernel_regularization > 0.0:
            Gs = Gs * _regularize_G(dim, ds / kernel_regularization)
        f = scene.source_fn(src_pts, *source_args)
        ws = 1.0 / (src_pdf[None] * n_src_total)
        u_s = jnp.sum(Gs * f[None] * ws, axis=1)
        if on_boundary is not None:
            u_s = alpha * u_s
        if with_gradient:
            dGs = (_free_dGdr(dim, lam, ds) / ds)[..., None] * ds_vec
            g_s = jnp.sum(dGs * (f[None] * ws)[..., None], axis=1)
            if on_boundary is not None:
                g_s = jnp.where(on_boundary[:, None], 0.0, g_s)
    else:
        u_s = 0.0
        g_s = 0.0

    if with_gradient:
        return u_b + u_s, g_b + g_s
    return u_b + u_s
