"""Differential operators on coordinate-network fields via forward-mode AD.

The reference computes divergence with a per-component reverse-mode autograd
loop (src/2d/utils/diff_ops.py:45-51) and curl from the Jacobian. With 2-3
input dimensions, forward mode is the right tool: `jacfwd` costs dim
forward passes, fuses into one XLA computation, and needs no graph retention.

All operators take `f: (dim,) -> (out,)` and map over batched points of
shape (..., dim).
"""
import jax
import jax.numpy as jnp


def jacobian(f, x):
    """Per-point Jacobian of f. x: (..., dim) -> (..., out, dim)."""
    flat = x.reshape(-1, x.shape[-1])
    j = jax.vmap(jax.jacfwd(f))(flat)
    return j.reshape(x.shape[:-1] + j.shape[1:])


def divergence(f, x):
    """div f at x; f maps (dim,) -> (dim,). Returns (...,)."""
    j = jacobian(f, x)
    return jnp.trace(j, axis1=-2, axis2=-1)


def curl2d(f, x):
    """Scalar vorticity dv/dx - du/dy; f maps (2,) -> (2,)."""
    j = jacobian(f, x)
    return j[..., 1, 0] - j[..., 0, 1]


def curl3d(f, x):
    """Vector vorticity of a 3D field; f maps (3,) -> (3,)."""
    j = jacobian(f, x)
    return jnp.stack([
        j[..., 2, 1] - j[..., 1, 2],
        j[..., 0, 2] - j[..., 2, 0],
        j[..., 1, 0] - j[..., 0, 1],
    ], axis=-1)


def gradient(f, x):
    """Gradient of a scalar field; f maps (dim,) -> () or (1,)."""
    def scalar(p):
        return jnp.reshape(f(p), ())
    flat = x.reshape(-1, x.shape[-1])
    g = jax.vmap(jax.grad(scalar))(flat)
    return g.reshape(x.shape)


def laplacian(f, x):
    """Laplacian of a scalar field via nested forward-mode."""
    def scalar(p):
        return jnp.reshape(f(p), ())
    hess = jax.vmap(jax.hessian(scalar))(x.reshape(-1, x.shape[-1]))
    return jnp.trace(hess, axis1=-2, axis2=-1).reshape(x.shape[:-1])
