import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nmcfluid.scenes import get_scene
from nmcfluid.sim import NeuralFluid
from nmcfluid.sim import sampling
from nmcfluid.wost.solver import WalkSettings


def tiny_fluid(name="taylorgreen", **over):
    scene = get_scene(name)
    scene = dataclasses.replace(
        scene, max_n_iters=over.pop("max_n_iters", 400),
        _boundary_builder=scene._boundary_builder,
        _source_builder=scene._source_builder,
        _obstacle_sdf_builder=scene._obstacle_sdf_builder)
    over.setdefault("walk_settings", WalkSettings(n_walks=32,
                                                  walk_step_cap=24))
    return NeuralFluid(
        scene,
        sample_resolution=over.pop("sample_resolution", 16),
        wost_resolution=over.pop("wost_resolution", 16),
        div_resolution=over.pop("div_resolution", 48),
        **over)


def test_uniform_grid_matches_reference_convention():
    g = sampling.uniform_grid((0.0, 2.0, 0.0, 1.0), 4, with_boundary=False)
    # longest edge (x) gets 4 cells, y scales down to 2 (model_utils 2d:4-7)
    assert g.shape == (4, 2, 2)
    np.testing.assert_allclose(np.asarray(g[0, 0]), [0.25, 0.25])
    np.testing.assert_allclose(np.asarray(g[-1, -1]), [1.75, 0.75])
    gb = sampling.uniform_grid((0.0, 2.0, 0.0, 1.0), 4, with_boundary=True)
    assert gb.shape == (6, 4, 2)
    np.testing.assert_allclose(np.asarray(gb[0, 0]), [0.0, 0.0])


def test_nearest_lookup_roundtrip():
    g = sampling.uniform_grid((0.0, 1.0, 0.0, 1.0), 8)
    vals = jnp.arange(64, dtype=jnp.float32).reshape(8, 8)
    got = sampling.nearest_lookup(vals, (0.0, 1.0, 0.0, 1.0),
                                  g.reshape(-1, 2))
    np.testing.assert_allclose(np.asarray(got), np.arange(64))


def test_fluid_points_respect_obstacle():
    scene = get_scene("karman")
    pts, valid = sampling.fluid_points(jax.random.PRNGKey(0), 512, scene)
    sd = np.asarray(scene.obstacle_sdf(pts))
    assert np.all(sd[np.asarray(valid)] > 0.0)
    assert np.asarray(valid).mean() > 0.99     # obstacle is tiny


def test_add_source_fits_taylor_green():
    fl = tiny_fluid(max_n_iters=1500)
    st = fl.init_state(0)
    st = fl.add_source(st)
    pts = sampling.uniform_grid(fl.scene.scene_size, 24)
    u = np.asarray(fl.velocity(st.params, pts, eps=st.eps))
    want = np.asarray(fl.scene.source_velocity(pts))
    err = np.mean(np.sum((u - want) ** 2, -1))
    assert err < 5e-2, err


def test_fit_plateau_stops_floored_fit_keeps_converging_fit():
    """fit_plateau ends a phase only once a whole window stops improving
    the smoothed loss: an lr too high to converge floors immediately and
    stops at a window boundary; the default-lr fit, still descending at
    the same budget, runs to the cap (the reference's early_stop_loss
    1.1e-10 never fires, base.py:129-152)."""
    floored = tiny_fluid(max_n_iters=1500, fit_plateau=300)
    floored.scene = dataclasses.replace(
        floored.scene, lr=1e-3,
        _boundary_builder=floored.scene._boundary_builder,
        _source_builder=floored.scene._source_builder,
        _obstacle_sdf_builder=floored.scene._obstacle_sdf_builder)
    floored.add_source(floored.init_state(0))
    it = int(floored._last_stats.iters)
    assert it < 1500 and it % 300 == 0, it

    converging = tiny_fluid(max_n_iters=1500, fit_plateau=300)
    converging.add_source(converging.init_state(0))
    assert int(converging._last_stats.iters) == 1500, \
        int(converging._last_stats.iters)


def test_wost_source_net_matches_grid():
    """wost_source='net' (exact network divergence at the sampled point,
    dense matmuls) must agree with the reference's nearest-texel grid
    lookup up to the grid's own discretization error: same key => same
    walk trajectories, only the source values differ."""
    from nmcfluid.sim.fluid import _divergence_grid, _pressure_solve
    fl = tiny_fluid(div_resolution=256,
                    walk_settings=WalkSettings(n_walks=64,
                                               walk_step_cap=16))
    st = fl.init_state(0)
    st = fl.add_source(st)
    key = jax.random.PRNGKey(4)
    div = _divergence_grid(fl, st.params, st.eps, st.timestep)
    pts_g, _, p_g, g_g = _pressure_solve(fl, fl._wost_scene, (div,), key)
    pts_n, _, p_n, g_n = _pressure_solve(
        fl, fl._wost_scene_net, (st.params, st.eps, st.timestep), key)
    np.testing.assert_allclose(np.asarray(pts_g), np.asarray(pts_n),
                               atol=0)
    # robust comparison: the per-point difference is a Green's-weighted
    # single-sample of (exact - nearest-texel) source values, heavy-
    # tailed at 64 walks — quantiles, not max
    dp = np.abs(np.asarray(p_g - p_n))
    scale = max(1e-6, float(np.abs(np.asarray(p_g)).max()))
    assert float(np.percentile(dp, 95)) < 0.12 * scale, dp.max()
    assert float(dp.mean()) < 0.1 * scale
    dg = np.abs(np.asarray(g_g - g_n))
    gscale = max(1e-6, float(np.abs(np.asarray(g_g)).max()))
    # p95 only: a handful of Green's-weighted single-sample outliers
    # dominate the gradient-diff MEAN (heavy tail at 64 walks — the
    # same values reproduce bit-exactly run to run)
    assert float(np.percentile(dg, 95)) < 0.15 * gscale
    assert float(np.median(dg)) < 0.05 * gscale


def test_fit_ensemble_averages_independent_fits():
    """fit_ensemble=2: still fits the target, is NOT a no-op relative to
    the single fit (different params), and the averaging contract holds
    (ensemble == mean of the two folded-key single fits)."""
    from nmcfluid.sim.fluid import _adam_fit, _adam_fit_single
    fl1 = tiny_fluid(max_n_iters=800)
    fl2 = tiny_fluid(max_n_iters=800, fit_ensemble=2)
    st1 = fl1.add_source(fl1.init_state(0))
    st2 = fl2.add_source(fl2.init_state(0))

    pts = sampling.uniform_grid(fl2.scene.scene_size, 24)
    want = np.asarray(fl2.scene.source_velocity(pts))
    for st, fl in ((st1, fl1), (st2, fl2)):
        u = np.asarray(fl.velocity(st.params, pts, eps=st.eps))
        err = np.mean(np.sum((u - want) ** 2, -1))
        assert err < 8e-2, err
    l1 = jax.tree.leaves(st1.params)[0]
    l2 = jax.tree.leaves(st2.params)[0]
    assert float(jnp.max(jnp.abs(l1 - l2))) > 0.0

    # direct contract: ensemble fit == mean of the two single fits
    # (ls_head off: the trivial batch_fn below has no feature hook)
    fl2 = tiny_fluid(max_n_iters=200, fit_ensemble=2, ls_head=0)
    key = jax.random.PRNGKey(7)
    params0 = st1.params

    class B:   # trivial batch_fn: fit velocity toward zero on a cloud
        def batch(self, k):
            x = jax.random.uniform(k, (64, 2), minval=1.0, maxval=5.0)
            return x, jnp.zeros((64, 2)), jnp.ones((64,))

        def velocity(self, params, x):
            return fl2.velocity(params, x, eps=st2.eps)

    pe, _ = _adam_fit(fl2, params0, key, B())
    pa, _ = _adam_fit_single(fl2, params0,
                             jax.random.fold_in(key, 0x5EED + 0), B())
    pb, _ = _adam_fit_single(fl2, params0,
                             jax.random.fold_in(key, 0x5EED + 1), B())
    want_p = jax.tree.map(lambda a, b: 0.5 * (a + b), pa, pb)
    for u, v in zip(jax.tree.leaves(pe), jax.tree.leaves(want_p)):
        np.testing.assert_allclose(np.asarray(u), np.asarray(v),
                                   atol=1e-6)


def test_add_source_fits_with_tail_schedule():
    """lr_schedule='tail' (constant then 20% cosine tail) must fit at
    least as well as constant lr on the same budget."""
    fl = tiny_fluid(max_n_iters=1500, lr_schedule="tail")
    st = fl.init_state(0)
    st = fl.add_source(st)
    pts = sampling.uniform_grid(fl.scene.scene_size, 24)
    u = np.asarray(fl.velocity(st.params, pts, eps=st.eps))
    want = np.asarray(fl.scene.source_velocity(pts))
    err = np.mean(np.sum((u - want) ** 2, -1))
    assert err < 5e-2, err


def test_step_runs_and_keeps_field_near_tg():
    fl = tiny_fluid(max_n_iters=800)
    st = fl.init_state(0)
    st = fl.add_source(st)
    st1 = fl.step(st)
    assert int(st1.timestep) == 1
    u = np.asarray(fl.sample_velocity_grid(st1, 24, with_boundary=False))
    assert np.all(np.isfinite(u))
    # dt=1e-3: one step must stay close to the (steady) TG field
    pts = sampling.uniform_grid(fl.scene.scene_size, 24)
    want = np.asarray(fl.scene.source_velocity(pts))
    err = np.mean(np.sum((u - want) ** 2, -1))
    assert err < 0.1, err
    assert np.isfinite(float(st1.P))


def test_divergence_grid_matches_pointwise_autodiff():
    from nmcfluid.sim.fluid import _divergence_grid
    from nmcfluid.ops.diff_ops import divergence
    fl = tiny_fluid(max_n_iters=1)
    st = fl.init_state(3)
    g = np.asarray(_divergence_grid(fl, st.params, st.eps, st.timestep))
    pts = sampling.uniform_grid(fl.scene.scene_size, fl.div_resolution)
    f = lambda p: fl.velocity(st.params, p, eps=st.eps)
    want = -np.asarray(divergence(f, pts.reshape(-1, 2))).reshape(g.shape)
    np.testing.assert_allclose(g, want, atol=1e-3)


def test_pressure_solve_analytic_source_through_grid_lookup():
    """Feed the WoSt stage an analytic screened-Poisson source via the same
    nearest-cell grid lookup the fluid uses, and check p / grad p against
    the manufactured solution p* = cos(k x) cos(k y) (dp*/dn = 0 on the TG
    box walls)."""
    from nmcfluid.wost.solver import estimate_solution_and_gradient
    fl = tiny_fluid(walk_settings=WalkSettings(n_walks=192, walk_step_cap=48),
                    div_resolution=256)
    scene = fl.scene
    ss = scene.scene_size
    L = ss[1] - ss[0]
    k = 2.0 * np.pi / L          # full TG period: Neumann on all walls
    sigma = scene.absorption

    def p_star(x):
        return (jnp.cos(k * (x[..., 0] - ss[0]))
                * jnp.cos(k * (x[..., 1] - ss[2])))

    grid_pts = sampling.uniform_grid(ss, fl.div_resolution)
    div_grid = (sigma + 2.0 * k ** 2) * p_star(grid_pts)

    pts = jnp.asarray([[3.14, 3.14], [1.5, 2.0], [4.8, 1.2]], jnp.float32)
    p, grad, n_valid = estimate_solution_and_gradient(
        fl._wost_scene, fl.walk_settings, pts, jax.random.PRNGKey(0),
        source_args=(div_grid,))
    want = np.asarray(p_star(pts))
    gx = -k * np.sin(k * (np.asarray(pts)[:, 0] - ss[0])) \
        * np.cos(k * (np.asarray(pts)[:, 1] - ss[2]))
    gy = -k * np.cos(k * (np.asarray(pts)[:, 0] - ss[0])) \
        * np.sin(k * (np.asarray(pts)[:, 1] - ss[2]))
    np.testing.assert_allclose(np.asarray(p), want, atol=0.08)
    np.testing.assert_allclose(np.asarray(grad),
                               np.stack([gx, gy], -1), atol=0.25)


def test_adv_ref_variant_runs():
    fl = tiny_fluid(max_n_iters=100, adv_ref=True)
    st = fl.init_state(0)
    st = fl.add_source(st)
    st1 = fl.step(st)
    u = np.asarray(fl.sample_velocity_grid(st1, 8))
    assert np.all(np.isfinite(u))


def test_src_duration_resourcing_keyed_on_absolute_timestep(tmp_path,
                                                            monkeypatch):
    """--src_duration re-fits the source at absolute frames 0 < t < dur
    (main.py:164-171) — resuming from a checkpoint past the window must
    NOT re-apply the source (regression: the window was keyed on the
    loop index)."""
    from nmcfluid import run as run_mod
    from nmcfluid.sim.fluid import NeuralFluid

    calls = []
    orig = NeuralFluid.add_source

    def counting(self, state):
        calls.append(int(state.timestep))
        return orig(self, state)

    monkeypatch.setattr(NeuralFluid, "add_source", counting)
    args = ["taylorgreen", "--n_timesteps", "3", "--max_n_iters", "5",
            "--sample_resolution", "8", "--wost_resolution", "8",
            "--div_resolution", "16", "--n_walks", "8",
            "--walk_step_cap", "8", "--src_duration", "3",
            "--out", str(tmp_path)]
    run_mod.main(args)
    # initial fit at t=0 plus re-fits before producing frames 2 and 3
    # (reference increments fluid.timestep first, so the fit sees t+1)
    assert calls == [0, 2, 3]

    calls.clear()
    run_mod.main(args + ["--ckpt", "3"])   # resume past the window
    assert calls == []                      # no re-sourcing on resume


def test_density_only_replays_without_simulating(tmp_path):
    """--density_only runs the export pass over existing checkpoints and
    must not simulate (the reference ships this as the separate
    move_density.py command in every run.sh)."""
    from nmcfluid import run as run_mod
    base = ["taylorgreen", "--n_timesteps", "2", "--max_n_iters", "5",
            "--sample_resolution", "8", "--wost_resolution", "8",
            "--div_resolution", "16", "--n_walks", "8",
            "--walk_step_cap", "8", "--out", str(tmp_path)]
    run_mod.main(base)
    model_dir = tmp_path / "taylorgreen" / "model"
    ckpts = sorted(os.listdir(model_dir))
    assert len(ckpts) == 3                      # t0, t1, t2

    run_mod.main(base + ["--density_only", "--density_resolution", "16"])
    exp = tmp_path / "taylorgreen"
    errs = np.loadtxt(exp / "error_ours.txt", ndmin=1)
    assert errs.shape[0] == 3 and np.all(np.isfinite(errs))
    assert sorted(os.listdir(model_dir)) == ckpts   # no new simulation


def test_fit_unroll_is_exact():
    """fit_unroll > 1 must reproduce the U=1 fit bit-exactly: both the
    iteration-cap edge (cap not a multiple of U) and the early-stop edge
    are guarded per sub-iteration, so only wall-clock changes."""
    from nmcfluid.sim.fluid import _fit_source

    def run(unroll, max_n_iters=37, early_stop=1.1e-10):
        scene = get_scene("taylorgreen")
        scene = dataclasses.replace(
            scene, max_n_iters=max_n_iters, early_stop_loss=early_stop,
            _boundary_builder=scene._boundary_builder,
            _source_builder=scene._source_builder,
            _obstacle_sdf_builder=scene._obstacle_sdf_builder)
        fl = NeuralFluid(scene, sample_resolution=8, wost_resolution=8,
                         div_resolution=16, fit_unroll=unroll,
                         walk_settings=WalkSettings(n_walks=8,
                                                    walk_step_cap=8))
        st = fl.init_state(0)
        params, stats = _fit_source(fl, st.params, jax.random.PRNGKey(3),
                                    st.eps, st.timestep)
        return params, int(stats.iters), float(stats.loss)

    # cap edge: 37 iters with U=3 (trips overshoot the cap by 2 sub-iters)
    p1, i1, l1 = run(1)
    p3, i3, l3 = run(3)
    assert i1 == i3 == 37 and l1 == l3
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p3)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # early-stop edge: a loose tolerance stops mid-run at the same iter
    # (the tiny fit reaches ~0.25 by iter 37, so 0.3 fires in between)
    p1, i1, l1 = run(1, early_stop=0.3)
    p4, i4, l4 = run(4, early_stop=0.3)
    assert i1 == i4 and 0 < i1 < 37 and l1 == l4
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p4)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_load_energy_keeps_pre_resume_rows(tmp_path):
    """--ckpt resume must preload energy.txt so the per-step overwrite
    doesn't drop the pre-resume rows (regression: a vortex_collide resume
    from t69 restarted the curve at t70)."""
    from nmcfluid import run as run_mod
    path = tmp_path / "energy.txt"
    np.savetxt(path, [1.0, 2.0, 3.0, 4.0])
    # fresh run: nothing to preload
    assert run_mod.load_energy(str(tmp_path), 0) == []
    # resume from t3: keep rows for steps 1..3 only
    assert run_mod.load_energy(str(tmp_path), 3) == [1.0, 2.0, 3.0]
    # resume past the file length: keep what exists
    assert run_mod.load_energy(str(tmp_path), 10) == [1.0, 2.0, 3.0, 4.0]
    # no file yet
    assert run_mod.load_energy(str(tmp_path / "nope"), 3) == []


def test_absorption_cli_override():
    """--absorption (wost.json absorptionCoeff) must flow into the scene
    spec so the screening-weight ablation exercises the real knob."""
    from nmcfluid.run import build_parser, scene_with_overrides
    args = build_parser().parse_args(["taylorgreen", "--absorption", "50"])
    assert scene_with_overrides(args).absorption == 50.0
    args = build_parser().parse_args(["taylorgreen"])
    assert scene_with_overrides(args).absorption == 350.0


def test_until_bounds_resume_at_absolute_step(tmp_path):
    """--until N stops the loop at absolute step N: a --ckpt resume with
    the scene's default --n_timesteps otherwise runs N more steps and
    overshoots the shipped frame count."""
    from nmcfluid import run as run_mod

    args = ["taylorgreen", "--max_n_iters", "5",
            "--sample_resolution", "8", "--wost_resolution", "8",
            "--div_resolution", "16", "--n_walks", "8",
            "--walk_step_cap", "8", "--out", str(tmp_path)]
    run_mod.main(args + ["--n_timesteps", "2"])
    model_dir = os.path.join(str(tmp_path), "taylorgreen", "model")
    assert sorted(os.listdir(model_dir))[-1] == "ckpt_step_t002.npz"
    # resume to absolute step 3 (one more step, not n_timesteps more)
    run_mod.main(args + ["--n_timesteps", "2", "--ckpt", "2",
                         "--until", "3"])
    assert sorted(os.listdir(model_dir))[-1] == "ckpt_step_t003.npz"
    # already there: no-op
    run_mod.main(args + ["--ckpt", "3", "--until", "3"])
    assert sorted(os.listdir(model_dir))[-1] == "ckpt_step_t003.npz"


def test_loss_trace_records_fit_snapshots():
    """--vis_frequency / NeuralFluid(loss_trace=N): FitStats.trace holds
    the minibatch loss every N iterations (the reference's config.py:102
    knob, consumed nowhere there — a real surface here)."""
    import dataclasses
    from nmcfluid.scenes import get_scene
    from nmcfluid.sim import NeuralFluid
    from nmcfluid.sim.fluid import _fit_source
    from nmcfluid.wost.solver import WalkSettings

    scene = dataclasses.replace(get_scene("taylorgreen"), max_n_iters=40)
    fluid = NeuralFluid(scene, sample_resolution=8, wost_resolution=8,
                        div_resolution=16, ls_head=0, loss_trace=10,
                        walk_settings=WalkSettings(n_walks=4,
                                                   walk_step_cap=4))
    st = fluid.init_state(0)
    params, stats = _fit_source(fluid, st.params, jax.random.PRNGKey(0),
                                st.eps, st.timestep)
    tr = np.asarray(stats.trace)
    assert tr.shape == (4,)
    assert np.all(np.isfinite(tr)) and np.all(tr > 0)
    # snapshots are distinct recordings, not a broadcast of one value
    # (per-batch noise at a 40-iter budget precludes monotonicity)
    assert len(np.unique(tr)) == 4
