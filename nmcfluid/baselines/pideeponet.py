"""Physics-informed DeepONet baseline in JAX.

Rebuild of experiments/piDeepONetSolver/{model.py,networks.py}: a
branch net encodes the initial velocity sampled at 100 fixed sensor points
(200-dim input) and a trunk net encodes (x, y, t); each produces
n_out-per-channel basis coefficients combined by an inner product into
(u, v, p). Trained with the same composite PINN loss (init / bound /
NS residual / div, model.py:171-215).
"""
import jax
import jax.numpy as jnp
import numpy as np

from .common import (SirenConfig, adam_fit, apply_siren, init_siren,
                     sample_boundary, sample_interior, tg_velocity)


class PIDeepONetFluid:
    def __init__(self, num_hidden_layers=3, hidden_features=256, lr=1e-4,
                 max_n_iters=50_000, sample_resolution=128, t_range=2.5,
                 n_sensors=100, n_out=60, n_fields=3):
        # defaults = piDeepONetSolver/config.py:93-94,105,108,146 +
        # model.py:36-44: n_out=60 coefficients TOTAL, split 20 per
        # field (networks.py:19-20), combined by an UNnormalized inner
        # product plus a learned per-field bias (networks.py:16,28)
        self.n_fields = n_fields
        self.n_basis = n_out // n_fields
        self.branch_cfg = SirenConfig(n_sensors * 2, n_out,
                                      num_hidden_layers, hidden_features)
        self.trunk_cfg = SirenConfig(3, n_out,
                                     num_hidden_layers, hidden_features)
        self.lr = lr
        self.max_n_iters = max_n_iters
        self.n = sample_resolution ** 2
        self.t_range = t_range
        # fixed sensor grid (model.py:47-48)
        side = int(np.sqrt(n_sensors))
        ax = (np.arange(side) + 0.5) / side * 2.0 - 1.0
        gx, gy = np.meshgrid(ax, ax, indexing="ij")
        self.sensors = jnp.asarray(np.stack([gx, gy], -1).reshape(-1, 2),
                                   jnp.float32)
        self.v0 = tg_velocity(self.sensors).reshape(-1)   # (200,)

    def init(self, seed=0):
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        return dict(branch=init_siren(k1, self.branch_cfg),
                    trunk=init_siren(k2, self.trunk_cfg),
                    b=jnp.zeros((self.n_fields,), jnp.float32))

    def field(self, state, xt):
        """(..., 3) -> (..., n_fields): sum_k B_k T_k + b
        (networks.py:23-29; no normalization)."""
        b = apply_siren(state["branch"], self.branch_cfg, self.v0)
        t = apply_siren(state["trunk"], self.trunk_cfg, xt)
        b = b.reshape(self.n_fields, self.n_basis)
        t = t.reshape(xt.shape[:-1] + (self.n_fields, self.n_basis))
        return jnp.sum(b * t, axis=-1) + state["b"]

    def velocity(self, state, x, t):
        xt = jnp.concatenate([x, jnp.broadcast_to(
            jnp.asarray(t, jnp.float32), x.shape[:-1])[..., None]], -1)
        return self.field(state, xt)[..., :2]

    def train(self, state, key):
        # NOT jitted: adam_fit chains <=5k-trip device segments on the
        # host (common._SEG)
        def loss_fn(st, ki):
            k0, k1, k2, k3 = jax.random.split(ki, 4)
            x0 = sample_interior(k0, self.n)
            xt0 = jnp.concatenate([x0, jnp.zeros((self.n, 1))], -1)
            li = jnp.mean((self.field(st, xt0)[..., :2]
                           - tg_velocity(x0)) ** 2)
            xv, xh = sample_boundary(k1, self.n // 100)
            tb = jax.random.uniform(k2, (self.n // 100, 1)) * self.t_range
            lv = self.field(st, jnp.concatenate([xv, tb], -1))[..., 0]
            lh = self.field(st, jnp.concatenate([xh, tb], -1))[..., 1]
            lb = jnp.mean(lv ** 2) + jnp.mean(lh ** 2)
            x = sample_interior(k3, self.n)
            tt = jax.random.uniform(jax.random.fold_in(k3, 1),
                                    (self.n, 1)) * self.t_range
            xt = jnp.concatenate([x, tt], -1)

            def f(q):
                return self.field(st, q)

            jac = jax.vmap(jax.jacfwd(f))(xt)       # (N, 3, 3)
            out = f(xt)
            u = out[..., :2]
            div = jac[..., 0, 0] + jac[..., 1, 1]
            dudt = jac[..., :2, 2]
            adv = (u[..., :1] * jac[..., :2, 0] + u[..., 1:] * jac[..., :2, 1])
            gp = jac[..., 2, :2]
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
