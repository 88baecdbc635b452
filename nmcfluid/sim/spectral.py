"""Deterministic screened-Poisson grid solver (DCT spectral method).

Replacement for the reference's unused-but-shipped discrete
pressure path (src/*/models/laplacian_solver.py: a prefactorized scipy
5-point Laplacian behind --use_disc_p): solve
    (Lap - sigma) p = -f
on the cell-centered uniform grid with homogeneous Neumann walls. The
cosine basis diagonalizes the Neumann Laplacian, so the solve is two DCTs
and a pointwise divide — O(N log N), fully on-device, and an independent
cross-check of the Monte Carlo projection (tests use it to validate the
WoSt pressure against a deterministic solver on identical inputs).
"""
import math
from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnums=(1, 2))
def solve_screened_poisson(f, scene_size, sigma: float):
    """f: (-f) is the PDE right-hand side — pass the same grid handed to
    the WoSt stage (-div u), getting the same p. Cell-centered grid over
    the scene box; Neumann (zero normal derivative) on all walls."""
    dim = f.ndim
    res = f.shape
    # DCT-II along every axis
    g = f
    for ax in range(dim):
        g = jax.scipy.fft.dct(g, type=2, axis=ax, norm="ortho")
    # eigenvalues of the Neumann Laplacian for cosine modes:
    # lap cos(pi k (i+1/2)/n) = -(2 n/L sin(pi k / (2n)))^2 * cos(...)
    lam = jnp.zeros((), jnp.float32)
    for ax in range(dim):
        n = res[ax]
        L = scene_size[2 * ax + 1] - scene_size[2 * ax]
        k = jnp.arange(n, dtype=jnp.float32)
        w = (2.0 * n / L * jnp.sin(math.pi * k / (2.0 * n))) ** 2
        shape = [1] * dim
        shape[ax] = n
        lam = lam + w.reshape(shape)
    denom = -(lam + sigma)
    # sigma = 0 leaves the k = 0 mode rank-deficient: pin it to zero mean
    if sigma == 0.0:
        denom = denom.at[(0,) * dim].set(-1.0)
        g = g.at[(0,) * dim].set(0.0)
    p_hat = -g / denom      # (lap - sigma) p = -f  =>  p_hat = f_hat/(lam+sig)
    p = p_hat
    for ax in range(dim):
        p = jax.scipy.fft.idct(p, type=2, axis=ax, norm="ortho")
    return p


@partial(jax.jit, static_argnums=(1,))
def grid_gradient(p, scene_size):
    """Central-difference gradient of a cell-centered grid, one-sided at
    the walls. Returns (..., dim)."""
    dim = p.ndim
    out = []
    for ax in range(dim):
        n = p.shape[ax]
        h = (scene_size[2 * ax + 1] - scene_size[2 * ax]) / n
        fwd = jnp.roll(p, -1, axis=ax)
        bwd = jnp.roll(p, 1, axis=ax)
        g = (fwd - bwd) / (2.0 * h)
        # one-sided at the first/last cells
        idx0 = [slice(None)] * dim
        idx1 = [slice(None)] * dim
        idx0[ax] = 0
        idx1[ax] = n - 1
        g0 = (jnp.take(p, 1, axis=ax) - jnp.take(p, 0, axis=ax)) / h
        g1 = (jnp.take(p, n - 1, axis=ax) - jnp.take(p, n - 2, axis=ax)) / h
        g = g.at[tuple(idx0)].set(g0)
        g = g.at[tuple(idx1)].set(g1)
        out.append(g)
    return jnp.stack(out, axis=-1)
