"""The neural Monte Carlo fluid stepper: three jitted phase trainers around
the walk-on-stars projection.

Rebuild of src/2d/models/{base,model_split}.py (and the 3D twins) as pure
JAX. The reference's per-iteration Python loop (tqdm + Adam + early-stop,
base.py:129-152) becomes one `lax.while_loop` compiled per phase: 10k
Adam steps run on-device with zero host round-trips. The reference's
velocity/prev/tilde network triple (base.py:48-50) becomes three parameter
pytrees sharing one apply function.

Per-timestep flow (model_split.py:44-82):
    prev <- params; tilde <- params
    advect: fit u(x) to u_prev(clamp(x - u_prev(x) dt))   (:87-120)
    tilde <- params; prev <- params
    project: WoSt-solve (Lap - sigma) p = div(u_prev) at a random pressure
             cloud, then fit u(x) to u_prev(x) - grad p(x)  (:245-284)
    prev <- params
with the adv_ref=1 (MacCormack/reflection) variant doubling both phases
(:63-81). The WoSt stage runs entirely on the device (nmcfluid.wost)
instead of crossing into C++/TBB; its per-step divergence grid is threaded
through the solver as a dynamic argument so each scene compiles exactly
once.
"""
import time
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..geometry import queries2d, queries3d
from ..models.boundary import apply_boundary
from ..models.siren import (SirenConfig, apply_siren, apply_siren_features,
                            init_siren)
from ..wost.solver import (WalkSettings, WostScene,
                           estimate_solution_and_gradient)
from . import sampling


class SimState(NamedTuple):
    """Everything that persists between timesteps. As in the reference, the
    only real simulation state is network weights (SURVEY.md section 0)."""
    params: list            # velocity_field
    params_prev: list       # velocity_field_prev
    params_tilde: list      # velocity_field_tilde
    P: jax.Array            # mean pressure (kinetic-energy offset, base.py:305)
    eps: jax.Array          # boundary ramp width (karman halves it, main.py:161)
    timestep: jax.Array     # int32
    key: jax.Array


class FitStats(NamedTuple):
    iters: jax.Array
    loss: jax.Array
    # minibatch-loss snapshots every `loss_trace` iterations (the
    # reference's --vis_frequency training-introspection cadence,
    # config.py:102 — defined there but consumed nowhere; here it is a
    # real surface). None unless NeuralFluid(loss_trace=N) is set.
    trace: jax.Array = None


class NeuralFluid:
    """Host-side orchestrator; all heavy lifting happens in jitted fns.

    Instances hash by identity and hold only static configuration, so they
    serve as stable `static_argnums` keys — each phase compiles once per
    (scene, overrides)."""

    def __init__(self, scene, *, max_n_iters: Optional[int] = None,
                 sample_resolution: Optional[int] = None,
                 wost_resolution: Optional[int] = None,
                 div_resolution: Optional[int] = None,
                 n_walks: Optional[int] = None,
                 walk_settings: Optional[WalkSettings] = None,
                 adv_ref: bool = False,
                 projection: str = "wost",
                 lr_schedule: str = "constant",
                 param_ema: float = 0.0,
                 grad_clip: float = -1.0,
                 fit_unroll: int = 4,
                 fit_plateau: int = 0,
                 ls_head: int = 8,
                 fit_ensemble: int = 1,
                 loss_trace: int = 0,
                 wost_source: str = "grid",
                 mesh=None):
        """projection: 'wost' (the reference's Monte Carlo pressure solve)
        or 'spectral' (deterministic DCT grid solve on the divergence grid
        — exact for box scenes, a fast mode with zero MC variance).

        lr_schedule: 'constant' (the reference's fixed 1e-5 Adam),
        'cosine' (decay to lr/100 across the phase), or 'tail' (constant
        for 80% of the budget, cosine decay over the last 20% — damps the
        end-of-phase Adam batch-wander without slowing the tracking
        phase). With constant lr and a
        warm start, Adam's normalized updates keep wandering at a ~lr-sized
        function-space noise floor — phase fits *end worse than they
        start*; the decay lets each phase converge.

        param_ema: exponential parameter averaging (Polyak) over the phase
        — 0.0 disables; e.g. 0.999 returns a ~1000-iter average, washing
        out the Adam end-point wander without touching the trajectory.

        grad_clip: global-l2 gradient clipping for every phase fit, <= 0
        disables (update_network, src/2d/models/base.py:83-96;
        --grad_clip default -1).

        fit_unroll: Adam iterations per while_loop trip in the phase
        fits. Results are identical for any value (sub-iterations are
        early-stop-guarded); >1 amortizes the loop's per-trip overhead.
        The default 4 was tuned on another accelerator and is untuned on
        the GPU.

        fit_plateau: stop a phase fit at the end of any
        `fit_plateau`-iteration window that improved the smoothed
        minibatch loss by <0.5% relative
        (0 = off, the reference behavior: its early_stop_loss 1.1e-10
        never fires, base.py:129-152, so every phase burns the full
        max_n_iters even after the loss floors). With the deterministic
        projections the two fits ARE the frame, so ending them at the
        plateau shortens the frame directly. Gated on the TG error
        curve (round 3, PARITY.md "fit_plateau gate"): plateau 250/500/
        1000 land at 1.06e-3/7.8e-4/6.3e-4 mean error vs 3.62e-4 with
        the full budget — the fit residual compounds through the
        semi-Lagrangian targets — so the default stays OFF; the knob
        remains for speed-over-accuracy runs.

        ls_head: number of fresh minibatches over which to solve the
        final linear layer in CLOSED FORM (weighted ridge least squares)
        at the end of every phase fit; 0 disables. Every scene's hard-BC
        wrapper is affine in the raw network output (models/boundary.py
        — masks, ramps and the jpipe corner projection are all linear in
        vel at fixed x), so with the trunk frozen the phase loss is an
        exact linear least-squares problem in the head: the solve lands
        the head at the minibatch-loss optimum that Adam's constant-lr
        wander never reaches (part of the TG error floor, PARITY.md
        round-2 gap decomposition). Default ON at 8 batches on the
        round-3 TG gate: frames-1-50 error 3.578e-4 -> 3.458e-4 under
        bem, 3.69e-4 -> 3.538e-4 under the parity MC walk (the solve is
        one (h1*dim)^2 eigensolve per phase);
        a fresh-batch do-no-harm guard keeps the Adam endpoint whenever
        the solve does not generalize (see PARITY.md 'ls_head gate')."""
        self.scene = scene
        self.adv_ref = adv_ref
        self.projection = projection
        if (projection == "spectral" and scene.dim == 2
                and scene.has_obstacle and scene.obstacle_center is None):
            # the deterministic path needs the fluid domain to be the box
            # minus (at most) a circle; jpipe's domain is the pipe interior
            raise ValueError(
                f"--projection spectral is unsupported on '{scene.name}': "
                "its obstacle is not a circle (use the bem or wost "
                "projection)")
        if projection in ("bem", "bvc") and scene.dim != 2:
            raise ValueError(
                f"--projection {projection} is 2D-only (the 3D scenes' "
                "WoSt domain is the plain cube, where spectral is already "
                "exact)")
        self._bem = None        # lazy BemProjector (host precompute)
        self._bvc = None        # lazy BvcProjector (MC-cached splat)
        self.lr_schedule = lr_schedule
        self.param_ema = param_ema
        self.grad_clip = grad_clip
        self.fit_unroll = fit_unroll
        self.fit_plateau = fit_plateau
        self.ls_head = ls_head
        # fit_ensemble > 1: run N independent phase fits (same start
        # params, disjoint minibatch streams) and average the resulting
        # parameters. MEASURED NEGATIVE (round 5, PARITY.md "fit
        # averaging"): at the shipped 10k-iter fits the trajectories
        # decohere (||p1-p2||/||p|| ~ 5.5%) and the SIREN loss at the
        # parameter midpoint is ~1.9x either endpoint (3-point probe);
        # e2e the TG bem frame-1 error jumps 1.9e-5 -> 1.85e-3 and the
        # 50-frame mean 3.4e-4 -> 2.05e-3 (error_bem_ens2_r5.txt). The
        # knob ships default-off; the per-fit noise floor stands
        # (oracle floor 3.6e-7, oracle_floor_r4.txt). Reference anchor:
        # the single fit of base.py:129-152.
        self.fit_ensemble = max(1, int(fit_ensemble))
        # loss_trace > 0: record the minibatch loss every loss_trace
        # iterations of every phase fit (runs the XLA fit path)
        self.loss_trace = loss_trace
        self.mesh = mesh
        self.max_n_iters = max_n_iters or scene.max_n_iters
        self.sample_resolution = sample_resolution or scene.sample_resolution
        self.wost_resolution = wost_resolution or scene.wost_resolution
        # 2D divergence grid is hardcoded 1000^2 in the reference
        # (model_split.py:255); 3D uses vis_resolution (3d/model_split.py:268)
        self.div_resolution = div_resolution or (
            1000 if scene.dim == 2 else scene.vis_resolution)
        self.n_batch = self.sample_resolution ** 2        # both 2D and 3D
        self.n_pressure = self.wost_resolution ** 2       # SURVEY.md 3.1/3.3
        # the walk program is solved in chunks of <= 64k points: one
        # compiled program reused across chunks. The split was sized on
        # another accelerator and is untuned on the GPU.
        self.wost_chunk = min(self.n_pressure, 65536)
        self.walk_settings = walk_settings or scene.walk_settings(
            n_walks=n_walks or scene.n_walks)
        self.siren_cfg = SirenConfig(
            scene.dim, scene.dim,
            num_hidden_layers=scene.num_hidden_layers,
            hidden_features=scene.hidden_features,
            nonlinearity=scene.nonlinearity,
            normal_init_std=0.1 if scene.dim == 2 else 1.0)
        self.q = queries2d if scene.dim == 2 else queries3d
        # WoSt scene built once: source_fn reads the per-step divergence
        # grid from a dynamic arg (nearest-cell, like the C++ texel lookup)
        ss = scene.scene_size

        def source_lookup(y, grid):
            return sampling.nearest_lookup(grid, ss, y)

        self._wost_scene = WostScene(
            dim=scene.dim, neumann=scene.boundary, source_fn=source_lookup,
            absorption=scene.absorption)
        # wost_source="net": the walk's source term evaluates -div u at
        # the sampled point DIRECTLY from the network (batched forward-
        # mode Jacobian — dense matmuls) instead of gathering a
        # precomputed nearest-texel grid; it removes the per-step gather
        # AND the nearest-cell discretization error. The reference's
        # texel cache is
        # demo/image.h:53-58 — an artifact of its CPU architecture, not
        # of the estimator math.
        self.wost_source = wost_source

        def source_net(y, prev, eps, t):
            def f(p):
                return self.velocity(params=prev, x=p, eps=eps, t=t)
            flat = y.reshape(-1, scene.dim)
            jac = jax.vmap(jax.jacfwd(f))(flat)
            div = jnp.trace(jac, axis1=-2, axis2=-1)
            return -div.reshape(y.shape[:-1])

        self._wost_scene_net = WostScene(
            dim=scene.dim, neumann=scene.boundary, source_fn=source_net,
            absorption=scene.absorption)
        self._bbox_lo = jnp.asarray([ss[2 * i] for i in range(scene.dim)],
                                    jnp.float32)
        self._bbox_hi = jnp.asarray([ss[2 * i + 1] for i in range(scene.dim)],
                                    jnp.float32)
        # opt-in per-stage wall-clock breakdown (the reference prints
        # per-phase timings, model_split.py:52-81; here a dict so bench.py
        # can persist it). Synchronizes between stages when enabled.
        self.profile = False
        self.stage_times: dict = {}

    def _timed(self, name, fn, *args):
        """Run a stage; when self.profile, synchronize and accumulate its
        wall-clock under stage_times[name]."""
        if not self.profile:
            return fn(*args)
        t0 = time.time()
        out = fn(*args)
        jax.block_until_ready(out)
        self.stage_times[name] = (self.stage_times.get(name, 0.0)
                                  + time.time() - t0)
        return out

    def shard_pts(self, arr):
        """Lay a point batch out along the mesh's point axis (no-op without
        a mesh). Applied to every hot point cloud — pressure points, phase
        minibatches, divergence-grid evaluation — so all three hot loops of
        SURVEY.md section 3 run point-parallel; params stay replicated and
        loss reductions become psums XLA inserts."""
        if self.mesh is None:
            return arr
        from jax.sharding import NamedSharding, PartitionSpec
        spec = PartitionSpec("points", *([None] * (arr.ndim - 1)))
        return jax.lax.with_sharding_constraint(
            arr, NamedSharding(self.mesh, spec))

    # ------------------------------------------------------------- velocity

    def velocity(self, params, x, *, eps, t=0, key=None, bc=True):
        """query_velocity (base.py:158-224): raw net + scene hard BCs."""
        raw = apply_siren(params, self.siren_cfg, x)
        if not bc:
            return raw
        if key is None:
            key = jax.random.PRNGKey(7)
        return apply_boundary(self.scene, raw, x, eps=eps, t=t, key=key)

    def velocity_affine(self, x, *, eps, t):
        """The affine decomposition of the scene's hard-BC wrapper at x:
        apply_boundary(raw) == A(x) @ raw + c(x) for every scene
        (models/boundary.py — at fixed x the wrapper is built from
        where-masks, component ramps, and the jpipe corner projection,
        all linear in the raw output). Returns (A, c) with
        A (..., D_out, D_in) and c (..., D). Uses the same key the fit
        loops use (fluid.velocity with key=None), so the smoke jet's
        time-seeded jitter matches."""
        dim = self.scene.dim
        key = jax.random.PRNGKey(7)

        def g(raw):
            return apply_boundary(self.scene, raw, x, eps=eps, t=t, key=key)

        zero = jnp.zeros(x.shape[:-1] + (dim,), jnp.float32)
        c = g(zero)
        cols = [g(zero.at[..., d].set(1.0)) - c for d in range(dim)]
        return jnp.stack(cols, axis=-1), c

    # ----------------------------------------------------------------- init

    def init_state(self, seed: int = 0) -> SimState:
        key = jax.random.PRNGKey(seed)
        kp, key = jax.random.split(key)
        params = init_siren(kp, self.siren_cfg)
        return SimState(params=params,
                        params_prev=jax.tree.map(jnp.copy, params),
                        params_tilde=jax.tree.map(jnp.copy, params),
                        P=jnp.float32(0.0),
                        eps=jnp.float32(self.scene.bdry_eps),
                        timestep=jnp.int32(0),
                        key=key)

    def _phase_init(self, state: SimState, key):
        """Fresh weights when --reset_wts (create_optimizer(reset=True),
        base.py:61-71), else warm-start from the current params."""
        if self.scene.reset_wts:
            return init_siren(key, self.siren_cfg)
        return state.params

    # ------------------------------------------------------------ public API

    def add_source(self, state: SimState) -> SimState:
        """Fit the initial condition (base.py:313-335). prev <- params."""
        key, k1, k2 = jax.random.split(state.key, 3)
        params, stats = _fit_source(self, state.params, k1, state.eps,
                                    state.timestep)
        self._last_stats = stats
        return state._replace(params=params,
                              params_prev=jax.tree.map(jnp.copy, params),
                              params_tilde=jax.tree.map(jnp.copy, params),
                              key=key)

    def step(self, state: SimState) -> SimState:
        """One operator-split timestep (model_split.py:44-82)."""
        scene = self.scene
        state = state._replace(timestep=state.timestep + 1)
        key = state.key
        prev = state.params
        tilde = state.params

        def advect(params_init, prev, tilde, dt, flag, k, name="advect_fit"):
            return self._timed(
                name, _fit_advect, self, flag, params_init, prev,
                tilde, jnp.float32(dt), k, state.eps, state.timestep)

        if not self.adv_ref:
            key, k1, k2, k3, k4 = jax.random.split(key, 5)
            p1, st_a = advect(self._phase_init(state, k1), prev, tilde,
                              scene.dt, False, k2)
            p2, P, st_p = self._project(state, p1, p1, k3, k4)
            self._last_stats = (st_a, st_p)
            out = p2
        else:
            # reflection variant (model_split.py:63-81): advect(dt/2) ->
            # project -> advect(dt/2, MacCormack) -> project. Each fit
            # instance gets its own stage_times key so per-fit wall-clock
            # (and bench MFU) stays per-instance, not accumulated.
            key, k1, k2, k3, k4, k5, k6, k7, k8 = jax.random.split(key, 9)
            p1, st1 = advect(self._phase_init(state, k1), prev, tilde,
                             scene.dt / 2, False, k2)
            tilde = p1
            p2, P, st2 = self._project(state, p1, p1, k3, k4)
            p3, st3 = advect(self._phase_init(state, k5), p2, tilde,
                             scene.dt / 2, True, k6, name="advect_fit2")
            p4, P, st4 = self._project(state, p3, p3, k7, k8,
                                       fit_name="project_fit2")
            self._last_stats = (st1, st2, st3, st4)
            out = p4

        return state._replace(params=out,
                              params_prev=jax.tree.map(jnp.copy, out),
                              params_tilde=jax.tree.map(jnp.copy, out),
                              P=P, key=key)

    def _project(self, state, params_init, prev, k_wost, k_fit,
                 fit_name="project_fit"):
        """Pressure solve + projection fit (model_split.py:245-284)."""
        div_grid = self._timed("div_grid", _divergence_grid, self, prev,
                               state.eps, state.timestep)
        if self.projection == "spectral":
            pts, valid, p, grad_p = self._timed(
                "spectral_solve", _pressure_solve_spectral,
                self, div_grid, k_wost, state.eps, state.timestep)
        elif self.projection == "bem":
            if self._bem is None:
                from .bem import BemProjector
                self._bem = BemProjector(self.scene, self.div_resolution)
            pts, valid, p, grad_p = self._timed(
                "bem_solve", _pressure_solve_bem, self, self._bem,
                div_grid, k_wost)
        elif self.projection == "bvc":
            if self._bvc is None:
                from .bem import BvcProjector
                self._bvc = BvcProjector(
                    self.scene, self.div_resolution, self._wost_scene,
                    self.walk_settings)
            pts, valid, p, grad_p = self._timed(
                "bvc_solve", _pressure_solve_bvc, self, self._bvc,
                div_grid, k_wost)
        else:
            if self.wost_source == "net":
                wsc, sargs = self._wost_scene_net, (prev, state.eps,
                                                    state.timestep)
            else:
                wsc, sargs = self._wost_scene, (div_grid,)
            chunks = [self._timed(
                "wost_solve", _pressure_solve, self, wsc, sargs,
                jax.random.fold_in(k_wost, c))
                for c in range(self.n_pressure // self.wost_chunk)]
            pts, valid, p, grad_p = (jnp.concatenate(xs)
                                     for xs in zip(*chunks))
        # per-projection debug artifacts for the driver (the reference
        # saves div/p/grad-p figures every projection, model_split.py:249-270)
        self._last_projection = (pts, p, grad_p, div_grid)
        P = jnp.mean(p)     # model_split.py:219
        params_init = self._phase_init(state, jax.random.fold_in(k_fit, 1)) \
            if self.scene.reset_wts else params_init
        params, stats = self._timed(
            fit_name, _fit_project, self, params_init, prev, pts,
            grad_p, k_fit, state.eps, state.timestep)
        return params, P, stats

    # ------------------------------------------------------------- measures

    def sample_velocity_grid(self, state, resolution, with_boundary=True):
        """Velocity of the prev field on a uniform grid (base.py:253-265)."""
        return _velocity_grid(self, state.params_prev, state.eps,
                              state.timestep, resolution, with_boundary)

    def kinetic_energy(self, state, resolution=None):
        """0.5 mean |u|^2 + P (base.py:303-306)."""
        res = resolution or self.scene.vel_vis_resolution
        u = _velocity_grid(self, state.params_prev, state.eps,
                           state.timestep, res, False)
        return 0.5 * jnp.mean(u ** 2) + state.P


# ----------------------------------------------------------- jitted kernels


def _adam_fit(fluid, params0, key, batch_fn):
    """The reference's _training_loop (base.py:129-152): Adam until the loss
    dips under early_stop_loss or max_n_iters, entirely on-device.

    With fluid.fit_ensemble = N > 1, N independent fits (disjoint
    minibatch key streams, same warm start) are averaged parameter-wise
    (see the fit_ensemble doc in __init__)."""
    n_ens = fluid.fit_ensemble
    if n_ens > 1:
        outs = [_adam_fit_single(fluid, params0,
                                 jax.random.fold_in(key, 0x5EED + j),
                                 batch_fn) for j in range(n_ens)]
        params = jax.tree.map(
            lambda *xs: sum(xs) / float(n_ens), *[p for p, _ in outs])
        stats = FitStats(
            iters=outs[0][1].iters,
            loss=sum(s.loss for _, s in outs) / float(n_ens),
            trace=outs[0][1].trace)
        return params, stats
    return _adam_fit_single(fluid, params0, key, batch_fn)


def _adam_fit_single(fluid, params0, key, batch_fn):
    scene = fluid.scene
    if fluid.lr_schedule == "cosine":
        lr = optax.cosine_decay_schedule(scene.lr, fluid.max_n_iters,
                                         alpha=0.01)
    elif fluid.lr_schedule == "tail":
        # constant lr for 80% of the budget (full-speed tracking of the
        # target, as the reference's fixed-lr Adam), then cosine-decay the
        # last 20% to damp the stochastic-batch wander that sets the error
        # floor once the projection itself is deterministic (bem/spectral)
        hold = int(fluid.max_n_iters * 0.8)
        lr = optax.join_schedules(
            [optax.constant_schedule(scene.lr),
             optax.cosine_decay_schedule(scene.lr,
                                         max(1, fluid.max_n_iters - hold),
                                         alpha=0.02)],
            boundaries=[hold])
    else:
        lr = scene.lr
    opt = optax.adam(lr)
    if fluid.grad_clip > 0.0:
        opt = optax.chain(optax.clip_by_global_norm(fluid.grad_clip), opt)
    opt_state = opt.init(params0)
    tol = scene.early_stop_loss
    dim = scene.dim

    def loss_fn(params, x, target, w):
        u = batch_fn.velocity(params, x)
        se = jnp.sum((u - target) ** 2, axis=-1)
        return jnp.sum(w * se) / (jnp.maximum(jnp.sum(w), 1.0) * dim)

    gamma = fluid.param_ema
    plateau = fluid.fit_plateau
    # plateau detector: EMA-smooth the minibatch loss over ~half a window,
    # then once per window compare against the previous window's level —
    # stop when a whole window improved the smoothed loss by <0.5%
    # relative. Windowed comparison (not per-iter best-tracking) so batch
    # noise cannot keep resetting the counter.
    p_decay = 1.0 - 2.0 / max(2, plateau)
    p_rel = 5e-3

    # trace and plateau compose (round 5; ADVICE r4 flagged the silent
    # disable): the carry is [5 base] + [trace if on] + [3 plateau if on],
    # with the plateau fields indexed from the back
    trace_every = fluid.loss_trace
    n_snap = (-(-fluid.max_n_iters // trace_every)) if trace_every else 0

    def cond(carry):
        i, _, _, _, loss = carry[:5]
        alive = (i < fluid.max_n_iters) & (loss > tol)
        if plateau > 0:
            alive = alive & (carry[-1] == 0)
        return alive

    def one_iter(carry):
        """One guarded Adam step: a no-op once the early-stop or the iter
        cap has fired, so unrolled trips reproduce the U=1 sequence
        exactly (the tail trip just burns a few predicated iterations)."""
        i, params, ema, opt_state, loss = carry[:5]
        live = (i < fluid.max_n_iters) & (loss > tol)
        if plateau > 0:
            ema_loss, ref_ema, stop = carry[-3:]
            live = live & (stop == 0)
        kb = jax.random.fold_in(key, i)
        x, target, w = batch_fn.batch(kb)
        new_loss, grads = jax.value_and_grad(loss_fn)(params, x, target, w)
        updates, new_opt = opt.update(grads, opt_state)
        new_params = optax.apply_updates(params, updates)
        if gamma > 0.0:
            # track exactly until the last ~20% of the phase, then average:
            # averaging the early transient would lag the new target
            start = jnp.int32(int(fluid.max_n_iters * 0.8))
            new_ema = jax.tree.map(
                lambda e, p: jnp.where(i >= start,
                                       gamma * e + (1.0 - gamma) * p, p),
                ema, new_params)
        else:
            new_ema = ema
        sel = lambda n, o: jax.tree.map(
            lambda a, b: jnp.where(live, a, b), n, o)
        out = (i + live.astype(jnp.int32), sel(new_params, params),
               sel(new_ema, ema), sel(new_opt, opt_state),
               jnp.where(live, new_loss, loss))
        if trace_every:
            tr = carry[5]
            snap = live & (i % trace_every == 0)
            tr = jnp.where(snap, tr.at[i // trace_every].set(new_loss), tr)
            out = out + (tr,)
        if plateau > 0:
            new_ema_loss = jnp.where(i == 0, new_loss,
                                     p_decay * ema_loss
                                     + (1.0 - p_decay) * new_loss)
            at_window = (i + 1) % plateau == 0
            flat = new_ema_loss >= ref_ema * (1.0 - p_rel)
            new_stop = jnp.where(at_window & flat, 1, stop)
            new_ref = jnp.where(at_window, new_ema_loss, ref_ema)
            out = out + (jnp.where(live, new_ema_loss, ema_loss),
                         jnp.where(live, new_ref, ref_ema),
                         jnp.where(live, new_stop, stop))
        return out

    def body(carry):
        # unrolled sub-iterations amortize the per-trip loop overhead of
        # these small-matmul fits
        for _ in range(max(1, fluid.fit_unroll)):
            carry = one_iter(carry)
        return carry

    init = (jnp.int32(0), params0, params0, opt_state, jnp.float32(jnp.inf))
    if trace_every:
        init = init + (jnp.zeros((n_snap,), jnp.float32),)
    if plateau > 0:
        init = init + (jnp.float32(jnp.inf), jnp.float32(jnp.inf),
                       jnp.int32(0))
    carry = jax.lax.while_loop(cond, body, init)
    i, params, ema, _, loss = carry[:5]
    out = ema if gamma > 0.0 else params
    if fluid.ls_head > 0:
        out = _ls_head_solve(fluid, out, key, batch_fn)
    trace = carry[5] if trace_every else None
    return out, FitStats(iters=i, loss=loss, trace=trace)


def _ls_head_solve(fluid, params, key, batch_fn):
    """Closed-form finish of the phase fit: solve the final linear layer
    by weighted ridge least squares over `fluid.ls_head` fresh
    minibatches, holding the trunk fixed.

    With features phi(x) (the penultimate activations) and the affine
    hard-BC wrapper u = A(x) (W^T phi + b) + c(x), the phase loss
    sum_i w_i |u_i - target_i|^2 is exactly quadratic in (W, b); the
    normal-equation solve lands the head at the optimum in one step.
    Solved in DELTA form (unknown = head increment against the Adam
    endpoint) so the f32 normal equations only carry the small
    correction, not the full head. The reference has no analog — its
    fits are pure minibatch Adam (base.py:129-152) whose constant-lr
    endpoint wanders at an ~lr-sized function-space noise floor."""
    W, b = params[-1]
    dim = fluid.scene.dim
    h1 = W.shape[0] + 1                       # features + bias column
    dot = partial(jnp.dot, precision=jax.lax.Precision.HIGHEST)
    M = jnp.zeros((h1, dim, h1, dim), jnp.float32)
    rhs = jnp.zeros((h1, dim), jnp.float32)
    for j in range(fluid.ls_head):
        # keys disjoint from the training iterations' fold_in(key, i<max)
        kb = jax.random.fold_in(key, fluid.max_n_iters + 1 + j)
        x, target, w = batch_fn.batch(kb)
        phi = batch_fn.features(params, x)
        phi1 = jnp.concatenate([phi, jnp.ones_like(phi[..., :1])], -1)
        A, _ = batch_fn.affine(x)
        y = target - batch_fn.velocity(params, x)   # residual at endpoint
        G = jnp.einsum('nde,ndf->nef', A, A,
                       precision=jax.lax.Precision.HIGHEST)
        Ay = jnp.einsum('nde,nd->ne', A, y,
                        precision=jax.lax.Precision.HIGHEST)
        for e in range(dim):
            rhs = rhs.at[:, e].add(dot(phi1.T, w * Ay[:, e]))
            for f in range(dim):
                blk = dot((phi1 * (w * G[:, e, f])[:, None]).T, phi1)
                M = M.at[:, e, :, f].add(blk)
    n = h1 * dim
    Mf = M.reshape(n, n)
    rf = rhs.reshape(n)
    # Normal equations square the design's condition number, and trunk
    # features are strongly correlated, so f32 LU noise can exceed the
    # tiny near-convergence residual. Solve by eigendecomposition with a
    # relative cutoff instead: directions whose curvature is below
    # 1e-5 * lambda_max carry no trustworthy f32 information — leave
    # the Adam endpoint untouched there (delta = 0).
    evals, evecs = jnp.linalg.eigh(Mf)
    lmax = jnp.maximum(evals[-1], 1e-30)
    inv = jnp.where(evals > 1e-5 * lmax,
                    1.0 / jnp.maximum(evals, 1e-5 * lmax), 0.0)
    delta = dot(evecs, inv * dot(evecs.T, rf)).reshape(h1, dim)
    cand = params[:-1] + [(W + delta[:-1], b + delta[-1])]

    # do-no-harm guard: the solve optimizes the sampled batches; at tiny
    # batch sizes (or a fully converged fit) the delta can be sampling
    # noise. Compare endpoint vs solved head on a FRESH batch and keep
    # the better one.
    kb = jax.random.fold_in(key, fluid.max_n_iters + 1 + fluid.ls_head)
    x, target, w = batch_fn.batch(kb)

    def batch_loss(p):
        u = batch_fn.velocity(p, x)
        se = jnp.sum((u - target) ** 2, axis=-1)
        return jnp.sum(w * se) / (jnp.maximum(jnp.sum(w), 1.0) * dim)

    better = batch_loss(cand) <= batch_loss(params)
    return jax.tree.map(lambda a, b: jnp.where(better, a, b), cand, params)


@partial(jax.jit, static_argnums=(0,))
def _fit_source(fluid, params0, key, eps, t):
    """_add_source (base.py:313-335): fit u to the scene's initial field."""
    scene = fluid.scene

    class B:
        @staticmethod
        def batch(kb):
            k1, k2 = jax.random.split(kb)
            pts, valid = sampling.training_points(
                k1, fluid.n_batch, scene, scene.sample_pattern,
                fluid.sample_resolution)
            pts = fluid.shard_pts(pts)
            target = scene.source_velocity(pts, key=k2)
            return pts, target, valid.astype(jnp.float32)

        @staticmethod
        def velocity(params, x):
            return fluid.velocity(params, x, eps=eps, t=t)

        @staticmethod
        def features(params, x):
            return apply_siren_features(params, fluid.siren_cfg, x)

        @staticmethod
        def affine(x):
            return fluid.velocity_affine(x, eps=eps, t=t)

    return _adam_fit(fluid, params0, key, B)


@partial(jax.jit, static_argnums=(0, 1))
def _fit_advect(fluid, flag, params0, prev, tilde, dt, key, eps, t):
    """_advect_velocity (model_split.py:87-120): semi-Lagrangian fit.
    flag=True is the MacCormack-style correction 2 u_prev - u_tilde
    (model_split.py:106)."""
    scene = fluid.scene

    class B:
        @staticmethod
        def batch(kb):
            pts, valid = sampling.training_points(
                kb, fluid.n_batch, scene, scene.sample_pattern,
                fluid.sample_resolution)
            pts = fluid.shard_pts(pts)
            u_prev = fluid.velocity(prev, pts, eps=eps, t=t)
            back = jnp.clip(pts - u_prev * dt, fluid._bbox_lo,
                            fluid._bbox_hi)           # model_split.py:99-100
            adv = fluid.velocity(prev, back, eps=eps, t=t)
            if flag:
                adv = 2.0 * adv - fluid.velocity(tilde, back, eps=eps, t=t)
            return pts, adv, valid.astype(jnp.float32)

        @staticmethod
        def velocity(params, x):
            return fluid.velocity(params, x, eps=eps, t=t)

        @staticmethod
        def features(params, x):
            return apply_siren_features(params, fluid.siren_cfg, x)

        @staticmethod
        def affine(x):
            return fluid.velocity_affine(x, eps=eps, t=t)

    return _adam_fit(fluid, params0, key, B)


@partial(jax.jit, static_argnums=(0,))
def _fit_project(fluid, params0, prev, pressure_pts, grad_p, key, eps, t):
    """Projection fit (model_split.py:274-284): minibatch the fixed pressure
    cloud, target u_prev - grad p."""
    fluid_ = fluid
    n_cloud = pressure_pts.shape[0]

    class B:
        @staticmethod
        def batch(kb):
            idx = jax.random.randint(kb, (fluid_.n_batch,), 0, n_cloud)
            pts = fluid_.shard_pts(pressure_pts[idx])
            u_prev = fluid_.velocity(prev, pts, eps=eps, t=t)
            target = u_prev - grad_p[idx]
            return pts, target, jnp.ones((fluid_.n_batch,), jnp.float32)

        @staticmethod
        def velocity(params, x):
            return fluid_.velocity(params, x, eps=eps, t=t)

        @staticmethod
        def features(params, x):
            return apply_siren_features(params, fluid_.siren_cfg, x)

        @staticmethod
        def affine(x):
            return fluid_.velocity_affine(x, eps=eps, t=t)

    return _adam_fit(fluid, params0, key, B)


@partial(jax.jit, static_argnums=(0, 4, 5))
def _velocity_grid(fluid, params, eps, t, resolution, with_boundary):
    pts = sampling.uniform_grid(fluid.scene.scene_size, resolution,
                                with_boundary)
    return fluid.velocity(params, pts, eps=eps, t=t)


@partial(jax.jit, static_argnums=(0,))
def _divergence_grid(fluid, prev, eps, t):
    """-div u_prev on the cell-centered uniform grid; the negation matches
    'Wost solves lap u = -f' (model_split.py:233) so the PDE solved is
    (Lap - sigma) p = div u."""
    pts = sampling.uniform_grid(fluid.scene.scene_size,
                                fluid.div_resolution, False)

    def f(p):
        return fluid.velocity(params=prev, x=p, eps=eps, t=t)

    flat = fluid.shard_pts(pts.reshape(-1, fluid.scene.dim))
    jac = jax.vmap(jax.jacfwd(f))(flat)
    div = jnp.trace(jac, axis1=-2, axis2=-1)
    return -div.reshape(pts.shape[:-1])


def _pressure_solve(fluid, wsc, source_args, key):
    """Pressure cloud + WoSt solution/gradient with the reference's
    boundary masking (grid.h:155-237): p and grad p are zeroed within
    boundaryDistanceMask of the Neumann boundary; grad p additionally
    outside the domain. NOT jitted as a whole: the estimator host-loops
    over pair launches (see WalkSettings.pairs_per_launch). `wsc` is
    the grid-source or net-source WostScene (see wost_source)."""
    k1, k2 = jax.random.split(key)
    pts, valid = _sample_pressure_cloud(fluid, k1)
    p, grad_p, n_valid = estimate_solution_and_gradient(
        wsc, fluid.walk_settings, pts, k2, source_args=source_args)
    return (pts, valid) + _mask_pressure(fluid, pts, valid, p, grad_p)


@partial(jax.jit, static_argnums=(0,))
def _sample_pressure_cloud(fluid, key):
    pts, valid = sampling.fluid_points(key, fluid.wost_chunk, fluid.scene)
    return fluid.shard_pts(pts), valid


@partial(jax.jit, static_argnums=(0,))
def _mask_pressure(fluid, pts, valid, p, grad_p):
    scene = fluid.scene
    dist = fluid.q.distance(scene.boundary, pts)
    signed = fluid.q.signed_distance(scene.boundary, pts)
    mask_near = jnp.abs(dist) < scene.boundary_distance_mask
    p = jnp.where(mask_near, 0.0, p)
    bad = mask_near | (signed >= 0.0) | ~valid
    grad_p = jnp.where(bad[:, None], 0.0, grad_p)
    return p, grad_p


@partial(jax.jit, static_argnums=(0, 1))
def _pressure_solve_bem(fluid, bp, div_grid, key):
    """Deterministic boundary-element projection (sim/bem.py): FFT volume
    potential + Nystrom-solved boundary density + kernel splats — the
    zero-variance fast path that works on ANY 2D scene, including
    jpipe's polygonal duct (unlike the spectral mode). Same pressure
    cloud and boundary masking as the other modes."""
    pts, valid = sampling.fluid_points(key, fluid.n_pressure, fluid.scene)
    pts = fluid.shard_pts(pts)
    p, grad_p = bp.solve(div_grid, pts)
    return (pts, valid) + _mask_pressure(fluid, pts, valid, p, grad_p)


def _pressure_solve_bvc(fluid, bp, div_grid, key):
    """Monte Carlo boundary-value-caching projection (sim/bem.py
    BvcProjector — zombie's N11 estimator productionized): walk only at
    the small boundary cache, splat deterministically to the pressure
    cloud. Same cloud and masking as the other modes. NOT jitted as a
    whole: the walk estimator host-loops over launches."""
    k1, k2 = jax.random.split(key)
    pts, valid = sampling.fluid_points(k1, fluid.n_pressure, fluid.scene)
    pts = fluid.shard_pts(pts)
    p, grad_p = bp.solve(div_grid, pts, k2)
    return (pts, valid) + _mask_pressure(fluid, pts, valid, p, grad_p)


@partial(jax.jit, static_argnums=(0,))
def _pressure_solve_spectral(fluid, div_grid, key, eps, t):
    """Deterministic projection: DCT screened-Poisson solve of the same
    divergence grid (sim.spectral), sampled at the same kind of random
    pressure cloud with the same boundary masking — a zero-variance
    drop-in for the MC stage (exact Neumann solve on box scenes). On
    circle-obstacle scenes (karman) a Bessel-K modal correction
    (ops/circle_modes.py) cancels the obstacle Neumann residual, making
    this the deterministic fast path for the scene family the reference
    can only handle through the MC walk."""
    from .spectral import grid_gradient, solve_screened_poisson
    scene = fluid.scene
    pts, valid = sampling.fluid_points(key, fluid.n_pressure, scene)
    pts = fluid.shard_pts(pts)
    p_grid = solve_screened_poisson(div_grid, scene.scene_size,
                                    scene.absorption)
    g_grid = grid_gradient(p_grid, scene.scene_size)
    ss = scene.scene_size
    p = sampling.bilinear_lookup(p_grid, ss, pts)
    grad_p = jnp.stack([sampling.bilinear_lookup(g_grid[..., i], ss, pts)
                        for i in range(scene.dim)], axis=-1)
    if (scene.obstacle_center is not None
            and scene.obstacle_radius is not None
            and scene.absorption > 0.0):
        # the reference's own pressure solves run on the bare box for
        # every obstacle scene family these corrections cover (karman's
        # circle is in its walk domain; the 3D scenes' wost.json
        # boundary = cube.obj), so the 3D corrections are capability
        # beyond parity
        if scene.dim == 2:
            from ..ops.circle_modes import (eval_circle_correction,
                                            fit_circle_correction)
            coeffs = fit_circle_correction(
                g_grid, ss, scene.obstacle_center, scene.obstacle_radius,
                scene.absorption)
            q, grad_q = eval_circle_correction(
                coeffs, pts, scene.obstacle_center, scene.obstacle_radius,
                scene.absorption)
        elif scene.obstacle_axis == "y":       # karman3d's cylinder
            from ..ops.cylinder_modes import (eval_cylinder_correction,
                                              fit_cylinder_correction)
            coeffs = fit_cylinder_correction(
                g_grid, ss, scene.obstacle_center, scene.obstacle_radius,
                scene.absorption)
            q, grad_q = eval_cylinder_correction(
                coeffs, pts, ss, scene.obstacle_center,
                scene.obstacle_radius, scene.absorption)
        else:                                  # smoke_obs's sphere
            from ..ops.sphere_modes import (eval_sphere_correction,
                                            fit_sphere_correction)
            coeffs = fit_sphere_correction(
                g_grid, ss, scene.obstacle_center, scene.obstacle_radius,
                scene.absorption)
            q, grad_q = eval_sphere_correction(
                coeffs, pts, scene.obstacle_center, scene.obstacle_radius,
                scene.absorption)
        p = p + q
        grad_p = grad_p + grad_q
    dist = fluid.q.distance(scene.boundary, pts)
    signed = fluid.q.signed_distance(scene.boundary, pts)
    mask_near = jnp.abs(dist) < scene.boundary_distance_mask
    p = jnp.where(mask_near, 0.0, p)
    bad = mask_near | (signed >= 0.0) | ~valid
    grad_p = jnp.where(bad[:, None], 0.0, grad_p)
    return pts, valid, p, grad_p
