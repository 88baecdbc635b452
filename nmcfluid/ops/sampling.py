"""Sphere/ball direction sampling and stratified sample generation.

Counterpart of zombie's core/sampling.h (reference:
bindings/zombie/include/zombie/core/sampling.h:22-174,435-457). All samplers
are counter-based on jax.random keys — unlike the reference, which seeds a
per-point pcg32 from the wall clock (walk_on_stars.h:638-641), runs here are
bit-reproducible.
"""
import jax
import jax.numpy as jnp


def unit_sphere_from_u(u, dim: int):
    """Map uniforms u[..., dim-1] to uniform directions on S^{dim-1}.

    Matches sampleUnitSphereUniform<2|3> (sampling.h:29-45): 2D uses angle
    2*pi*u0; 3D uses z = 1-2*u0, phi = 2*pi*u1.
    """
    if dim == 2:
        phi = 2.0 * jnp.pi * u[..., 0]
        return jnp.stack([jnp.cos(phi), jnp.sin(phi)], axis=-1)
    z = 1.0 - 2.0 * u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = 2.0 * jnp.pi * u[..., 1]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def unit_sphere_uniform(key, shape, dim: int):
    u = jax.random.uniform(key, tuple(shape) + (dim - 1,))
    return unit_sphere_from_u(u, dim)


def pdf_unit_sphere(dim: int):
    return 1.0 / (2.0 * jnp.pi) if dim == 2 else 1.0 / (4.0 * jnp.pi)


def stratified_u(key, n: int, dim_m1: int):
    """n stratified samples in [0,1)^{dim_m1}.

    1D: jittered strata in random order (matches the role of
    generateStratifiedSamples<1>, sampling.h:435-457). 2D (for 3D walks):
    Latin-hypercube — independent stratified permutations per axis.
    """
    kj, kp = jax.random.split(key)
    jitter = jax.random.uniform(kj, (n, dim_m1))
    cols = []
    for d in range(dim_m1):
        kp, kd = jax.random.split(kp)
        perm = jax.random.permutation(kd, n)
        cols.append((perm + jitter[:, d]) / n)
    return jnp.stack(cols, axis=-1)
