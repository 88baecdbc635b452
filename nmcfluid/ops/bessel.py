"""Float32-safe modified Bessel functions for the 2D Yukawa Green's function.

The reference solver evaluates K0/K1/I0/I1 (bindings/zombie/deps/bessel) in
double precision; here we work in float32, where I0(x) overflows for
x > ~88 and K0(x) underflows. All 2D Yukawa ball quantities are therefore
expressed in terms of the *scaled* functions

    i0e(x) = e^{-x} I0(x)     k0e(x) = e^{x} K0(x)
    i1e(x) = e^{-x} I1(x)     k1e(x) = e^{x} K1(x)

which stay in a tame range for all x >= 0. i0e/i1e come from
jax.scipy.special; k0e/k1e are implemented here with the classic
Abramowitz & Stegun 9.8.5-9.8.8 polynomial fits (abs error < 1e-7 in f64,
well below f32 resolution).
"""
import jax.numpy as jnp
from jax.scipy.special import i0e, i1e  # noqa: F401  (re-exported)

_K0_SMALL = (-0.57721566, 0.42278420, 0.23069756, 0.03488590,
             0.00262698, 0.00010750, 0.00000740)
_K0_LARGE = (1.25331414, -0.07832358, 0.02189568, -0.01062446,
             0.00587872, -0.00251540, 0.00053208)
_K1_SMALL = (1.0, 0.15443144, -0.67278579, -0.18156897,
             -0.01919402, -0.00110404, -0.00004686)
_K1_LARGE = (1.25331414, 0.23498619, -0.03655620, 0.01504268,
             -0.00780353, 0.00325614, -0.00068245)


def _poly(coeffs, t):
    acc = jnp.full_like(t, coeffs[-1])
    for c in coeffs[-2::-1]:
        acc = acc * t + c
    return acc


def k0e(x):
    """e^x * K0(x), elementwise, x > 0 (guarded below ~1e-20)."""
    x = jnp.asarray(x)
    xs = jnp.maximum(x, 1e-20)
    # small branch (x <= 2): K0 = -ln(x/2) I0(x) + poly((x/2)^2)
    xc = jnp.minimum(xs, 2.0)  # clamp so the masked-out branch stays finite
    t = (xc / 2.0) ** 2
    i0 = i0e(xc) * jnp.exp(xc)
    small = jnp.exp(xc) * (-jnp.log(xc / 2.0) * i0 + _poly(_K0_SMALL, t))
    # large branch (x >= 2): K0 = e^{-x}/sqrt(x) poly(2/x)
    xl = jnp.maximum(xs, 2.0)
    large = _poly(_K0_LARGE, 2.0 / xl) / jnp.sqrt(xl)
    return jnp.where(xs <= 2.0, small, large)


def k1e(x):
    """e^x * K1(x), elementwise, x > 0 (guarded below ~1e-20)."""
    x = jnp.asarray(x)
    xs = jnp.maximum(x, 1e-20)
    xc = jnp.minimum(xs, 2.0)
    t = (xc / 2.0) ** 2
    i1 = i1e(xc) * jnp.exp(xc)
    small = jnp.exp(xc) * (jnp.log(xc / 2.0) * i1 + _poly(_K1_SMALL, t) / xc)
    xl = jnp.maximum(xs, 2.0)
    large = _poly(_K1_LARGE, 2.0 / xl) / jnp.sqrt(xl)
    return jnp.where(xs <= 2.0, small, large)
