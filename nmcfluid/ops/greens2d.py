"""2D ball Green's functions (harmonic and Yukawa/screened) for walk-on-stars.

Re-derivation of zombie's `HarmonicGreensFnBall<2>` / `YukawaGreensFnBall<2>`
(reference: bindings/zombie/include/zombie/core/distributions.h:397-474,
573-696) in scaled-Bessel form so everything is float32-safe: with
z = sqrt(lam)*r and Z = sqrt(lam)*R, ratios like K0(Z)/I0(Z) are computed as
(k0e(Z)/i0e(Z)) * exp(-2Z) and cross terms carry exp(2z-2Z) <= 1 factors.

Every function is elementwise over a batch of walker lanes: `ball` is a
pytree of per-lane precomputed radius terms.
"""
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .bessel import i0e, i1e, k0e, k1e

TWO_PI = 2.0 * jnp.pi
R_CLAMP = 1e-4  # distributions.h rClamp default


class Ball(NamedTuple):
    """Per-lane ball parameters. Yukawa fields are zeros for harmonic balls."""
    R: jax.Array
    Z: jax.Array        # sqrt(lam) * R
    i0e_R: jax.Array
    i1e_R: jax.Array
    k0e_R: jax.Array
    k1e_R: jax.Array


# ----------------------------------------------------------------- harmonic

class Harmonic2D:
    """G(r) = log(R/r)/2pi on a ball of radius R (distributions.h:397-474)."""
    dim = 2
    screened = False

    @staticmethod
    def make_ball(R, sqrt_lam=None):
        z = jnp.zeros_like(R)
        return Ball(R=R, Z=z, i0e_R=z, i1e_R=z, k0e_R=z, k1e_R=z)

    @staticmethod
    def eval(ball, r):
        return jnp.log(ball.R / r) / TWO_PI

    @staticmethod
    def norm(ball):
        return ball.R * ball.R / 4.0

    @staticmethod
    def dspk(ball, r):
        # directionSampledPoissonKernel == 1: throughput is preserved
        return jnp.ones_like(r)

    @staticmethod
    def pk_over_uniform(ball):
        # poissonKernel()/pdfSampleSphereUniform(1) == 1
        return jnp.ones_like(ball.R)

    @staticmethod
    def pk_grad_coeff(ball):
        # poissonKernelGradient = coeff * (ySurf - c);  2d/(2pi R^2)
        return 2.0 / (TWO_PI * ball.R * ball.R)

    @staticmethod
    def grad_norm(ball, r):
        return (1.0 / (r * r) - 1.0 / (ball.R * ball.R)) / TWO_PI

    @staticmethod
    def pk_grad_over_thr(ball):
        """poissonKernelGradient coeff / directionSampledPoissonKernel —
        the ratio the gradient estimator actually needs. Computed jointly
        so the e^{-Z} factors cancel analytically: for sigma = 350 on
        scene-sized balls both factors underflow float32 individually and
        the naive quotient explodes (observed 1e19 pressure gradients)."""
        return 2.0 / (TWO_PI * ball.R * ball.R)

    @staticmethod
    def grad_norm_over_eval(ball, r):
        """gradient(r)/evaluate(r), e^{-z}-free (same rationale)."""
        r = jnp.clip(r, R_CLAMP, 0.999 * ball.R)
        num = 1.0 / (r * r) - 1.0 / (ball.R * ball.R)
        den = jnp.maximum(jnp.log(ball.R / r), 1e-12)
        return num / den

    @staticmethod
    def radial_pdf(ball, r):
        # pdf of the sampled radius = [eval/norm] * 2*pi*r  (marginal over angle)
        return 4.0 * r * jnp.log(ball.R / r) / (ball.R * ball.R)

    @staticmethod
    def rejection_bound(ball):
        return 1.5 / ball.R

    @staticmethod
    def sample_radius(ball, key, rounds: int = 0):
        """Inverse-CDF draw of the radius (see ops.radial_tables)."""
        return Harmonic2D.sample_radius_u(
            ball, jax.random.uniform(key, ball.R.shape + (2,)))

    @staticmethod
    def sample_radius_u(ball, u2):
        """As sample_radius from caller-supplied uniforms (..., 2)."""
        from . import radial_tables as rt
        global _H2D_TABLE
        if _H2D_TABLE is None:
            # numpy on purpose: a jnp constant created under one trace
            # would leak into later traces via this cache
            _H2D_TABLE = rt.build_harmonic2d_table().astype("float32")
        t = rt.sample_t_harmonic2d_u_mm(_H2D_TABLE, u2[..., 0])
        r = jnp.clip(t * ball.R, R_CLAMP, ball.R)
        return r, Harmonic2D.eval(ball, r)


_H2D_TABLE = None


# ------------------------------------------------------------------- yukawa

class Yukawa2D:
    """Screened G on a ball: (K0(z) - I0(z)K0(Z)/I0(Z))/2pi, z=sqrt(lam)r."""
    dim = 2
    screened = True

    def __init__(self, lam):
        self.lam = float(lam)
        self.sqrt_lam = math.sqrt(float(lam))
        from . import radial_tables as rt
        # numpy (trace-safe), raw: draws use the gather-free matmul form
        self._table = rt.build_table(2).astype("float32")

    def make_ball(self, R):
        Z = self.sqrt_lam * R
        return Ball(R=R, Z=Z, i0e_R=i0e(Z), i1e_R=i1e(Z),
                    k0e_R=k0e(Z), k1e_R=k1e(Z))

    def _cross(self, ball, z):
        # exp(2z - 2Z) factor carried by I(z)*K(Z)/I(Z) cross terms; z<=Z so <=1
        return jnp.exp(2.0 * (z - ball.Z))

    def eval(self, ball, r):
        z = self.sqrt_lam * r
        q = k0e(z) - i0e(z) * (ball.k0e_R / ball.i0e_R) * self._cross(ball, z)
        return jnp.exp(-z) * q / TWO_PI

    def norm(self, ball):
        # (1 - 2pi*poissonKernel)/lam, poissonKernel = 1/(2pi I0(Z))
        return (1.0 - jnp.exp(-ball.Z) / ball.i0e_R) / self.lam

    def dspk(self, ball, r):
        # z*(K1(z) + I1(z)K0(Z)/I0(Z)) — per-step throughput multiplier
        r = jnp.maximum(r, R_CLAMP)
        z = self.sqrt_lam * r
        q = k1e(z) + i1e(z) * (ball.k0e_R / ball.i0e_R) * self._cross(ball, z)
        return z * jnp.exp(-z) * q

    def pk_over_uniform(self, ball):
        # (1/(2pi I0(Z))) / (1/2pi) = 1/I0(Z)
        return jnp.exp(-ball.Z) / ball.i0e_R

    def pk_grad_coeff(self, ball):
        # poissonKernelGradient = d * sqrt(lam)/(2pi R I1(Z))
        return self.sqrt_lam * jnp.exp(-ball.Z) / (TWO_PI * ball.R * ball.i1e_R)

    def grad_norm(self, ball, r):
        z = self.sqrt_lam * r
        q = k1e(z) - i1e(z) * (ball.k1e_R / ball.i1e_R) * self._cross(ball, z)
        return self.sqrt_lam * jnp.exp(-z) * q / (TWO_PI * r)

    def pk_grad_over_thr(self, ball):
        """[sqrt(lam) e^{-Z}/(2pi R I1)] / [e^{-Z}/I0] with e^{-Z}
        cancelled: sqrt(lam) i0e(Z)/(2pi R i1e(Z)). Bounded for all Z —
        see Harmonic2D.pk_grad_over_thr for why the naive quotient is
        catastrophic at large Z."""
        return self.sqrt_lam * ball.i0e_R \
            / (TWO_PI * ball.R * ball.i1e_R)

    def grad_norm_over_eval(self, ball, r):
        """sqrt(lam) q1/(r q0) with the shared e^{-z} cancelled;
        q0, q1 -> 0 together as r -> R, so r is clipped just inside."""
        r = jnp.clip(r, R_CLAMP, 0.999 * ball.R)
        z = self.sqrt_lam * r
        c = self._cross(ball, z)
        q0 = k0e(z) - i0e(z) * (ball.k0e_R / ball.i0e_R) * c
        q1 = k1e(z) - i1e(z) * (ball.k1e_R / ball.i1e_R) * c
        return self.sqrt_lam * q1 / (r * jnp.maximum(q0, 1e-10))

    def radial_pdf(self, ball, r):
        return self.eval(ball, r) * TWO_PI * r / self.norm(ball)

    def rejection_bound(self, ball):
        # distributions.h:594-596 empirical envelope of the radial pdf
        R, lam, slam = ball.R, self.lam, self.sqrt_lam
        sR = jnp.sqrt(R)
        lo = jnp.where(R <= lam,
                       jnp.maximum(2.2 / R, 2.2 / lam),
                       jnp.minimum(2.2 / R, 2.2 / lam))
        hi = jnp.where(R <= lam,
                       jnp.maximum(0.6 * sR, 0.6 * slam),
                       jnp.minimum(0.6 * sR, 0.6 * slam))
        return jnp.maximum(lo, hi)

    def sample_radius(self, ball, key, rounds: int = 0):
        """Inverse-CDF draw (table over Z = sqrt(lam)*R): replaces the
        reference's loose-envelope rejection, whose acceptance collapses
        at the fluid's sigma=350 on scene-sized balls."""
        return self.sample_radius_u(
            ball, jax.random.uniform(key, ball.R.shape + (2,)))

    def sample_radius_u(self, ball, u2):
        from . import radial_tables as rt
        t = rt.sample_t_screened_u_mm(self._table, ball.Z, u2[..., 0])
        r = jnp.clip(t * ball.R, R_CLAMP, ball.R)
        return r, self.eval(ball, r)


def sample_radius_rejection(greens, ball, key, rounds: int = 16):
    """Sample the in-ball radius from the Green's-fn radial density.

    Mirrors GreensFnBall::rejectionSampleGreensFn (distributions.h:362-383):
    uniform proposal on (0, R), accept with prob radial_pdf/bound; the last
    draw is kept if no round accepts (the reference caps at 1000 iters and
    keeps the final sample as well). Returns (r, eval_at_r).
    """
    R = ball.R
    bound = greens.rejection_bound(ball)
    u = jax.random.uniform(key, (2, rounds) + R.shape)
    rs = jnp.maximum(u[1] * R[None], R_CLAMP)
    pdf_r = greens.radial_pdf(jax.tree.map(lambda a: a[None], ball), rs)
    acc = u[0] < pdf_r / bound[None]
    idx = jnp.where(jnp.any(acc, axis=0), jnp.argmax(acc, axis=0), rounds - 1)
    r = jnp.take_along_axis(rs, idx[None], axis=0)[0]
    r = jnp.where(r > R, R / 2.0, jnp.maximum(r, R_CLAMP))
    return r, greens.eval(ball, r)
