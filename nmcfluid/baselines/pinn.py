"""Space-time PINN baseline in JAX.

Rebuild of experiments/pinnFluid/model.py:163-205: one velocity network
u(x, y, t) and one pressure network p(x, y, t) trained jointly over the
whole time range with a composite loss
  init  : u(x, 0) = TG
  bound : zero normal wall velocity at random times
  main  : du/dt + (u . grad) u + grad p = 0   (inviscid NS residual)
  div   : div u = 0
then evaluated per-frame for the error curve.
"""

import jax
import jax.numpy as jnp

from .common import (SirenConfig, adam_fit, apply_siren, init_siren,
                     sample_boundary, sample_interior, tg_velocity)

class PINNFluid:
    def __init__(self, num_hidden_layers=3, hidden_features=256, lr=1e-4,
                 max_n_iters=50_000, sample_resolution=128, t_range=2.5):
        # defaults = pinnFluid/config.py:90-91,102,105,143 (3x256, 50k
        # iters, lr 1e-4, t_range 2.5 — trained over [0, 2.5] though the
        # error curve only evaluates t in [0, 0.05], save_vel.py:23-47)
        self.u_cfg = SirenConfig(3, 2, num_hidden_layers, hidden_features)
        self.p_cfg = SirenConfig(3, 1, num_hidden_layers, hidden_features)
        self.lr = lr
        self.max_n_iters = max_n_iters
        self.n = sample_resolution ** 2
        self.t_range = t_range

    def init(self, seed=0):
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        return dict(u=init_siren(k1, self.u_cfg),
                    p=init_siren(k2, self.p_cfg))

    def velocity(self, state, x, t):
        xt = jnp.concatenate([x, jnp.broadcast_to(
            jnp.asarray(t, jnp.float32), x.shape[:-1])[..., None]], -1)
        return apply_siren(state["u"], self.u_cfg, xt)

    def train(self, state, key):
        # NOT jitted: adam_fit chains <=5k-trip device segments on the
        # host (common._SEG)
        def loss_fn(st, ki):
            k0, k1, k2, k3 = jax.random.split(ki, 4)
            # init
            x0 = sample_interior(k0, self.n)
            xt0 = jnp.concatenate([x0, jnp.zeros((self.n, 1))], -1)
            li = jnp.mean((apply_siren(st["u"], self.u_cfg, xt0)
                           - tg_velocity(x0)) ** 2)
            # boundary
            xv, xh = sample_boundary(k1, self.n // 100)
            tb = jax.random.uniform(k2, (self.n // 100, 1)) * self.t_range
            lv = apply_siren(st["u"], self.u_cfg,
                             jnp.concatenate([xv, tb], -1))[..., 0]
            lh = apply_siren(st["u"], self.u_cfg,
                             jnp.concatenate([xh, tb], -1))[..., 1]
            lb = jnp.mean(lv ** 2) + jnp.mean(lh ** 2)
            # residuals
            x = sample_interior(k3, self.n)
            tt = jax.random.uniform(jax.random.fold_in(k3, 1),
                                    (self.n, 1)) * self.t_range
            xt = jnp.concatenate([x, tt], -1)

            def u_fn(q):
                return apply_siren(st["u"], self.u_cfg, q)

            def p_fn(q):
                return jnp.reshape(apply_siren(st["p"], self.p_cfg, q), ())

            jac = jax.vmap(jax.jacfwd(u_fn))(xt)       # (N, 2, 3)
            u = u_fn(xt)
            div = jac[..., 0, 0] + jac[..., 1, 1]
            dudt = jac[..., 2]
            adv = (u[..., :1] * jac[..., 0] + u[..., 1:] * jac[..., 1])
            gp = jax.vmap(jax.grad(p_fn))(xt)[..., :2]
            resid = dudt + adv + gp
            lm = jnp.mean(resid ** 2)
            ld = jnp.mean(div ** 2)
            return li + lb + lm + ld
        # ExponentialLR parity: both reference trainers decay lr x0.95^1e-4
        # per step (model.py:68); their plateau lines are commented out
        st, i, l = adam_fit(state, key, loss_fn, self.lr,
                            self.max_n_iters,
                            exp_gamma=0.95 ** 1e-4)
        return st, i, l
