"""Shared pieces for the baseline methods.

The reference baselines all work on the canonical [-1, 1]^2 domain with the
Taylor-Green field mapped onto it (experiments/INSR-PDE/fluid/*,
experiments/pinnFluid/*): zero normal velocity on the walls enforced by a
1%-of-batch boundary penalty instead of hard BCs.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..models.siren import SirenConfig, apply_siren, init_siren  # noqa: F401


def tg_velocity(x):
    """TG field on [-1,1]^2 (INSR taylorgreen source: rescale to (0, 2pi))."""
    sx = (x[..., 0] + 1.0) * jnp.pi
    sy = (x[..., 1] + 1.0) * jnp.pi
    return jnp.stack([jnp.sin(sx) * jnp.cos(sy),
                      -jnp.cos(sx) * jnp.sin(sy)], axis=-1)


def sample_interior(key, n):
    return jax.random.uniform(key, (n, 2), minval=-1.0, maxval=1.0)


def sample_boundary(key, n):
    """n points on horizontal walls + n on vertical walls
    (sample_boundary2D_separate)."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    xh = jnp.stack([jax.random.uniform(k1, (n,), minval=-1, maxval=1),
                    jnp.sign(jax.random.uniform(k2, (n,)) - 0.5)], -1)
    xv = jnp.stack([jnp.sign(jax.random.uniform(k3, (n,)) - 0.5),
                    jax.random.uniform(k4, (n,), minval=-1, maxval=1)], -1)
    return xv, xh   # (vertical walls: x = +-1), (horizontal: y = +-1)


_SEG = 5000   # while-loop trips per device program: long fits chain
              # capped segments with a host sync between (a guard sized on
              # another accelerator; untuned on the GPU)


class SegmentedAdam:
    """Adam over a summed loss, like the main trainer, with the early
    stop of INSR config.py:111 — run as jitted while_loop segments of
    <= _SEG trips chained on the host (see _SEG). Construct ONCE per
    loss (e.g. in a model's __init__): the segment program is cached on
    this instance, so per-frame refits don't recompile. Loss data that
    changes between fits (previous nets etc.) arrives via `ctx`.

    With plateau=True the lr follows INSR's ReduceLROnPlateau recipe
    (base/baseModel.py:55-62,132-134: factor 0.1, patience 500,
    min_lr 1e-8, early stop once lr <= 1.1e-8; torch 'rel' improvement
    threshold 1e-4). Deviation: the plateau monitors the SUMMED loss,
    not the 'main' term alone — the auxiliary terms are small.

    With exp_gamma set, the lr instead decays multiplicatively every
    step — torch ExponentialLR, the schedule the pinnFluid and
    piDeepONet trainers actually ship (both model.py:68:
    gamma = 0.95 ** 0.0001, i.e. lr x0.774 over a 50k run; their
    ReduceLROnPlateau lines are commented out)."""

    def __init__(self, loss_fn, lr, tol=1.1e-10, plateau=False,
                 exp_gamma=None):
        self.loss_fn = loss_fn   # loss_fn(params, key_i, *ctx) -> scalar
        self.lr0 = float(lr)
        self.opt = optax.inject_hyperparams(optax.adam)(learning_rate=lr)
        self.tol = tol
        self.plateau = plateau
        self.exp_gamma = None if exp_gamma is None else float(exp_gamma)

    @partial(jax.jit, static_argnums=(0,))
    def _segment(self, params, opt_state, key, i0, hi, loss, lr, best,
                 stall, ctx):
        def cond(c):
            i, _, _, loss, lr, _, _ = c
            go = (i < hi) & (loss > self.tol)
            if self.plateau:
                go = go & (lr > 1.1e-8)
            return go

        def body(c):
            i, p, s, _, lr, best, stall = c
            s.hyperparams["learning_rate"] = lr
            l, g = jax.value_and_grad(self.loss_fn)(
                p, jax.random.fold_in(key, i), *ctx)
            up, s = self.opt.update(g, s)
            if self.plateau:
                improved = l < best * (1.0 - 1e-4)
                best = jnp.minimum(best, l)
                stall = jnp.where(improved, 0, stall + 1)
                drop = stall > 500
                lr = jnp.where(drop, jnp.maximum(lr * 0.1, 1e-8), lr)
                stall = jnp.where(drop, 0, stall)
            if self.exp_gamma is not None:
                # scheduler.step() runs after optimizer.step(): step i
                # uses lr0 * gamma^i, first step at lr0
                lr = lr * self.exp_gamma
            return (i + 1, optax.apply_updates(p, up), s, l, lr, best,
                    stall)

        # carry the previous segment's loss in (not inf): a stop landing
        # exactly on a segment boundary must report the real loss, and
        # the tol check must not defer one iteration per boundary
        return jax.lax.while_loop(
            cond, body, (i0, params, opt_state, loss, lr, best, stall))

    def fit(self, params, key, max_iters, ctx=()):
        opt_state = self.opt.init(params)
        i = jnp.int32(0)
        loss = jnp.float32(jnp.inf)
        lr = jnp.float32(self.lr0)
        best = jnp.float32(jnp.inf)
        stall = jnp.int32(0)
        for lo in range(0, max_iters, _SEG):
            hi = min(lo + _SEG, max_iters)
            i, params, opt_state, loss, lr, best, stall = self._segment(
                params, opt_state, key, i, jnp.int32(hi), loss, lr, best,
                stall, ctx)
            if int(i) < hi:   # early stop fired inside the segment
                break
        return params, i, loss


def adam_fit(params, key, loss_fn, lr, max_iters, tol=1.1e-10,
             exp_gamma=None):
    """One-shot convenience over SegmentedAdam (compiles per call —
    fine for single-fit users like the PINN/DeepONet trainers)."""
    return SegmentedAdam(loss_fn, lr, tol,
                         exp_gamma=exp_gamma).fit(params, key, max_iters)


def ref_pipeline_error(vel_np, method):
    """Score an (N, N, 2) velocity grid sampled at CELL CENTERS through
    the reference's published evaluation pipeline, which compares it
    against truth at VERTICES — a half-texel misalignment worth 3.94e-3
    at N=50 resp. 8.0e-4 at N=100 even for the EXACT field:
      * velocity saved at centers: save_vel.py:28 / base/sampling.py:7
        ((i+0.5)/N * 2 - 1)
      * truth at vertices: tlgn_error.py grid_coords/N * 2pi
    pinn/pideeponet (N=50, mean||e||^2): published 3.951e-3 / 3.945e-3
    vs exact-field floor 3.943e-3 — the published curves are ~100%
    evaluation artifact. INSR (N=100, (mean||e||)^2 — note the different
    metric, INSR-PDE/tlgn_error.py:94): floor 8.0e-4 of the published
    1.024e-3. Kept so the rebuilds can REPRODUCE the published numbers;
    the honest consistent-grid metric is error_of in run.py."""
    N = vel_np.shape[0]
    ang = np.arange(N) / N * 2.0 * np.pi
    ax, ay = np.meshgrid(ang, ang, indexing="ij")
    truth = np.stack([np.sin(ax) * np.cos(ay), -np.cos(ax) * np.sin(ay)],
                     -1)
    if method == "insr":
        return float(np.mean(np.linalg.norm(vel_np - truth, axis=2)) ** 2)
    return float(np.mean(np.sum((vel_np - truth) ** 2, axis=-1)))


def centers_grid(n):
    """The reference save_vel / sample_uniform cell-center grid on
    [-1, 1]^2 ((i + 0.5)/n * 2 - 1)."""
    ax = (np.arange(n) + 0.5) / n * 2.0 - 1.0
    gx, gy = np.meshgrid(ax, ax, indexing="ij")
    return jnp.asarray(np.stack([gx, gy], -1), jnp.float32)


def tg_error_curve_grid(n=1000):
    """Evaluation grid + truth for the baselines' tlgn_error convention."""
    ang = np.arange(n) / n * 2.0 * np.pi
    ax, ay = np.meshgrid(ang, ang, indexing="ij")
    truth = np.stack([np.sin(ax) * np.cos(ay), -np.cos(ax) * np.sin(ay)], -1)
    coords = np.stack(np.meshgrid(np.arange(n) / n * 2.0 - 1.0,
                                  np.arange(n) / n * 2.0 - 1.0,
                                  indexing="ij"), -1)
    return jnp.asarray(coords, jnp.float32), truth
