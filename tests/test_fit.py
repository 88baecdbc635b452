"""The XLA while_loop phase fit (sim/fluid.py:_adam_fit_single) against a
plain optax loop that draws a fresh minibatch every iteration from the
same keys — the reference's training loop (base.py:129-152)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from nmcfluid.models.siren import SirenConfig, apply_siren, init_siren
from nmcfluid.scenes import get_scene
from nmcfluid.sim import NeuralFluid
from nmcfluid.sim.fluid import _adam_fit_single


def _problem(scene_name, hidden_layers, n_iters, lr, batch=256):
    scene = dataclasses.replace(get_scene(scene_name), max_n_iters=n_iters,
                                lr=lr)
    fluid = NeuralFluid(scene, sample_resolution=8, wost_resolution=8,
                        div_resolution=16, ls_head=0)
    dim = scene.dim
    cfg = SirenConfig(dim, dim, num_hidden_layers=hidden_layers,
                      hidden_features=64)

    class Batches:
        @staticmethod
        def batch(kb):
            kx, kw = jax.random.split(kb)
            x = jax.random.uniform(kx, (batch, dim), minval=-1.0,
                                   maxval=1.0)
            target = jnp.sin(3.0 * x[..., ::-1]) * 0.3
            # zero weights (invalid points) occur in the real fits
            w = (jax.random.uniform(kw, (batch,)) > 0.2).astype(jnp.float32)
            return x, target, w

        @staticmethod
        def velocity(params, x):
            return apply_siren(params, cfg, x)

    params = init_siren(jax.random.PRNGKey(0), cfg)
    return fluid, cfg, params, Batches


def _optax_loop(params, key, batches, n_iters, lr, dim):
    opt = optax.adam(lr)
    state = opt.init(params)

    def loss_fn(p, x, target, w):
        se = jnp.sum((batches.velocity(p, x) - target) ** 2, axis=-1)
        return jnp.sum(w * se) / (jnp.maximum(jnp.sum(w), 1.0) * dim)

    @jax.jit
    def step(p, s, kb):
        x, target, w = batches.batch(kb)
        loss, g = jax.value_and_grad(loss_fn)(p, x, target, w)
        u, s = opt.update(g, s)
        return optax.apply_updates(p, u), s, loss

    for i in range(n_iters):
        params, state, loss = step(params, state,
                                   jax.random.fold_in(key, i))
    return params, loss


@pytest.mark.parametrize("scene_name,hidden_layers", [
    ("karman", 2),          # karman/jpipe family depth
    ("smoke", 3),           # 3D family
    ("taylorgreen", 6),     # taylorgreen family depth
])
def test_xla_fit_matches_optax_fresh_batch_loop(scene_name, hidden_layers):
    n_iters, lr = 24, 1e-3
    fluid, cfg, params, batches = _problem(scene_name, hidden_layers,
                                           n_iters, lr)
    key = jax.random.PRNGKey(9)
    got, stats = jax.jit(lambda p, k: _adam_fit_single(
        fluid, p, k, batches))(params, key)
    want, want_loss = _optax_loop(params, key, batches, n_iters, lr,
                                  cfg.in_features)
    assert int(stats.iters) == n_iters
    # the same ops in another fusion order agree bitwise on the CPU; the
    # tolerance is float32 noise, 100x below lr (one Adam step) and
    # ~1000x below the gap a different batch stream opens (~2e-2)
    for (wg, bg), (ww, bw) in zip(got, want):
        np.testing.assert_allclose(np.asarray(wg), np.asarray(ww),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(bg), np.asarray(bw),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(stats.loss), float(want_loss),
                               rtol=1e-4)
    # and it trained: parameters moved by far more than the tolerance
    moved = max(float(jnp.max(jnp.abs(a - b)))
                for (a, _), (b, _) in zip(got, params))
    assert moved > 5 * lr
