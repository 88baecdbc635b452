#!/usr/bin/env python3
"""Smoke run of the neural Monte Carlo fluid on the GPU.

    python chip_smoke.py            # one card: phases 1-5 below
    python chip_smoke.py --mesh 4   # four cards: the sharded walk and frame

One process drives the cards; its only child is nvidia-smi. Phases:

  1. device: exits non-zero unless JAX's default backend is a GPU, and
     prints the devices and the card's name and power limit;
  2. compile: each stage of the shipped Taylor-Green (TG) frame compiled at
     full width, with its compile time, memory_analysis() and the device's
     peak_bytes_in_use;
  3. main path: `nmcfluid.run` on taylorgreen, 2 frames at the shipped
     config; the TG velocity error of each frame (transport_rollout, the
     metric behind error_ours.txt) must meet the published curve;
  4. other modes: one TG frame under --projection bem and one smoke frame
     (3D triangle-soup walk) at shipped widths; fields, the mean pressure
     P and the kinetic energy must be finite;
  5. numerics on the card against plain references: the SIREN forward and
     gradient against float64 NumPy, the WoSt estimator against a
     closed-form screened-Poisson solution, a 200-iteration Adam fit
     against the same fit on the CPU.

Per-phase wall times go to earlier lines. The last line is one JSON object
{"ok": true, "device": {...}}; any failure raises, so the process exits
non-zero without printing it. Outputs go to chiprun_out/chip_smoke/.
"""
import argparse
import dataclasses
import json
import os
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")

# the published TG velocity-error curve (BASELINE.md): frame 1 and the
# 50-frame mean
TG_FRAME1 = 1.836e-4
TG_MEAN50 = 4.142e-4


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")
    log(f"  ok: {msg}")


class phase:
    """Prints a phase's wall time when it ends without an exception."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        log(f"== {self.name}")
        self.t0 = time.perf_counter()

    def __exit__(self, exc_type, *_):
        if exc_type is None:
            log(f"== {self.name}: {time.perf_counter() - self.t0:.3f} s")


def peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def device_check():
    import jax
    from nmcfluid.utils.device import card_name_power, device_info, \
        require_gpu
    require_gpu()
    log(f"devices: {jax.devices()}")
    info = device_info()
    log(f"platform {info['platform']}, device_kind {info['kind']}, "
        f"count {info['count']}")
    log(f"card (nvidia-smi name, power.limit): {card_name_power()}")
    return info


# ------------------------------------------------------------- phase 2


def _fmt_memory(ma):
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes")
    if ma is None:
        return "n/a"
    return ", ".join(f"{f.replace('_size_in_bytes', '')}="
                     f"{getattr(ma, f, None)}" for f in fields)


def compile_stages(argv=("taylorgreen",)):
    """Lower and compile each stage of one frame at the widths `argv`
    gives the CLI. wost_solve is host-looped over launches of one program,
    _gen_launch, which is what is compiled here."""
    import jax
    import jax.numpy as jnp
    from nmcfluid import run
    from nmcfluid.sim import fluid as F
    from nmcfluid.wost import gen

    fl = run.make_fluid(run.build_parser().parse_args(list(argv)))
    st = fl.init_state(0)
    key = jax.random.PRNGKey(0)
    ps, eps, t = st.params, st.eps, st.timestep
    dim = fl.scene.dim

    def f32(*shape):
        return jax.ShapeDtypeStruct(shape, jnp.float32)

    def walk_launch():
        ws, scene = fl.walk_settings, fl._wost_scene
        N = fl.wost_chunk
        pd = jax.eval_shape(
            lambda p: gen._precompute(scene, ws, p, key), f32(N, dim))
        grid = jax.eval_shape(F._divergence_grid, fl, ps, eps, t)
        n_pairs = max(1, ws.n_walks // 2)
        return gen._gen_launch.lower(
            scene, ws, n_pairs, 2, N, max(1, ws.gen_group_pairs), pd, key,
            jnp.int32(0), jnp.int32(ws.gen_groups_per_launch),
            f32(N, 2), f32(N, 3 + dim), (grid,))

    n = fl.n_pressure
    stages = {
        "advect_fit": lambda: F._fit_advect.lower(
            fl, False, ps, ps, ps, jnp.float32(fl.scene.dt), key, eps, t),
        "div_grid": lambda: F._divergence_grid.lower(fl, ps, eps, t),
        "wost_solve": walk_launch,
        "project_fit": lambda: F._fit_project.lower(
            fl, ps, ps, f32(n, dim), f32(n, dim), key, eps, t),
    }
    for name, lower in stages.items():
        t0 = time.perf_counter()
        compiled = lower().compile()
        dt = time.perf_counter() - t0
        log(f"compile {name}: {dt:.3f} s; memory_analysis: "
            f"{_fmt_memory(compiled.memory_analysis())}; "
            f"peak_bytes_in_use {peak_bytes()}")


# ---------------------------------------------------------- phases 3-4


def tg_errors(fluid, model_dir, n_frames, n=1000):
    """Per-frame TG velocity error (frame 0 = the initial-condition fit)
    from the run's checkpoints, as `nmcfluid.run --density` computes it."""
    from nmcfluid.transport import transport_rollout
    from nmcfluid.utils import load_ckpt
    like = fluid.init_state(0).params

    def params_iter():
        for t in range(n_frames + 1):
            yield load_ckpt(model_dir, like, t)[0]

    return [err for _, _, _, err in transport_rollout(
        fluid, params_iter(), n=n)]


def check_tg_errors(errs):
    log("  TG velocity error per frame: "
        + ", ".join(f"t{t}={e:.4e}" for t, e in enumerate(errs)))
    check(errs[1] <= TG_FRAME1,
          f"frame-1 TG error {errs[1]:.4e} <= published {TG_FRAME1}")
    check(max(errs) < TG_MEAN50,
          f"every frame's TG error < published 50-frame mean {TG_MEAN50}")


def main_path(extra=(), n_frames=2, error_n=1000, tag="tg_wost"):
    """`nmcfluid.run taylorgreen` for n_frames at the shipped config (or
    as `extra` flags override it), then the TG error of every frame."""
    from nmcfluid import run
    out = os.path.join(OUT, tag)
    fluid, state = run.simulate(
        ["taylorgreen", "--n_timesteps", str(n_frames), "--out", out,
         "--stage_times", *extra])
    log(f"  peak_bytes_in_use {peak_bytes()}")
    errs = tg_errors(fluid, os.path.join(out, "taylorgreen", "model"),
                     n_frames, n=error_n)
    check_tg_errors(errs)


def other_modes(extra=()):
    """One TG bem frame and one smoke (3D wost) frame through the CLI."""
    import jax.numpy as jnp
    from nmcfluid import run
    for scene, proj in (("taylorgreen", "bem"), ("smoke", "wost")):
        name = f"{scene}_{proj}"
        t0 = time.perf_counter()
        fluid, state = run.simulate(
            [scene, "--n_timesteps", "1", "--projection", proj,
             "--out", OUT, "--exp_name", name, "--stage_times", *extra])
        log(f"  {name}: {time.perf_counter() - t0:.3f} s incl. compile; "
            f"peak_bytes_in_use {peak_bytes()}")
        u = fluid.sample_velocity_grid(state, fluid.scene.vel_vis_resolution)
        pts, p, grad_p, div = fluid._last_projection
        for what, a in (("velocity", u), ("p", p), ("grad p", grad_p),
                        ("div grid", div), ("P", state.P)):
            check(bool(jnp.all(jnp.isfinite(a))), f"{name}: finite {what}")
        if fluid.scene.dim == 3:
            ke = float(fluid.kinetic_energy(state))
            check(np.isfinite(ke), f"{name}: finite kinetic energy {ke:.6e}")


# ------------------------------------------------------------- phase 5


def _siren_f64(params, x, omega=30.0):
    """Plain float64 SIREN forward; returns the output and the per-layer
    (input, pre-activation) pairs for the backward pass."""
    h = np.asarray(x, np.float64)
    cache = []
    for W, b in params[:-1]:
        z = h @ np.asarray(W, np.float64) + np.asarray(b, np.float64)
        cache.append((h, z))
        h = np.sin(omega * z)
    W, b = params[-1]
    cache.append((h, None))
    return h @ np.asarray(W, np.float64) + np.asarray(b, np.float64), cache


def _siren_grad_f64(params, x, target, omega=30.0):
    """float64 gradient of mean_i |u(x_i) - target_i|^2 by hand-written
    backpropagation."""
    u, cache = _siren_f64(params, x, omega)
    g = 2.0 * (u - target) / u.shape[0]
    grads = []
    for (W, _), (h, z) in zip(reversed(params), reversed(cache)):
        if z is not None:
            g = g * omega * np.cos(omega * z)
        grads.append((h.T @ g, g.sum(0)))
        g = g @ np.asarray(W, np.float64).T
    return grads[::-1]


def _rel(a, ref):
    """Norm-wise relative error ||a - ref||_2 / ||ref||_2."""
    a = np.asarray(a, np.float64)
    return float(np.linalg.norm(a - ref) / max(np.linalg.norm(ref), 1e-300))


def siren_numerics(families=("taylorgreen", "karman", "smoke"), tol=1e-5):
    """SIREN forward and jax.grad at each network family's width and fit
    batch against the float64 reference. Under the default 'highest'
    (float32) the relative error must be <= tol: float32 rounding through
    <= 7 layers, amplified by omega_0 = 30 in every sine. The same error
    under 'high' (TF32 on the GPU) is printed, not asserted."""
    import jax
    import jax.numpy as jnp
    from nmcfluid.models.siren import (SirenConfig, apply_siren,
                                       init_siren, resolve_precision)
    from nmcfluid.scenes import get_scene

    for name in families:
        sc = get_scene(name)
        cfg = SirenConfig(sc.dim, sc.dim, num_hidden_layers=sc.num_hidden_layers,
                          hidden_features=sc.hidden_features)
        n = sc.sample_resolution ** 2
        kp, kx, kt = jax.random.split(jax.random.PRNGKey(3), 3)
        params = init_siren(kp, cfg)
        lo = jnp.asarray(sc.scene_size[0::2], jnp.float32)
        hi = jnp.asarray(sc.scene_size[1::2], jnp.float32)
        x = jax.random.uniform(kx, (n, sc.dim), jnp.float32, lo, hi)
        tgt = jax.random.normal(kt, (n, sc.dim), jnp.float32)
        p64 = [(np.asarray(W), np.asarray(b)) for W, b in params]
        u_ref, _ = _siren_f64(p64, np.asarray(x))
        g_ref = _siren_grad_f64(p64, np.asarray(x), np.asarray(tgt))
        for prec in ("highest", "high"):
            P = resolve_precision(prec)
            fwd = jax.jit(lambda p, x: apply_siren(p, cfg, x, P))
            grad = jax.jit(jax.grad(lambda p, x, t: jnp.mean(jnp.sum(
                (apply_siren(p, cfg, x, P) - t) ** 2, -1))))
            e_fwd = _rel(fwd(params, x), u_ref)
            gs = grad(params, x, tgt)
            e_grad = max(_rel(g, r) for gl, rl in zip(gs, g_ref)
                         for g, r in zip(gl, rl))
            msg = (f"SIREN {name} ({sc.num_hidden_layers}x"
                   f"{sc.hidden_features}, batch {n}) {prec}: rel error "
                   f"forward {e_fwd:.3e}, grad {e_grad:.3e}")
            if prec == "highest":
                check(e_fwd <= tol and e_grad <= tol, f"{msg} <= {tol}")
            else:
                log(f"  info: {msg}")


def wost_numerics(n_points=65536, n_walks=500, replicas=4,
                  sigmas=(30.0, 350.0), z_max=4.0):
    """WoSt solution and gradient on the manufactured pure-Neumann box
    problem of tests/test_wost.py: p* = cos(pi x / L) cos(pi y / L) on
    [0, L]^2 solves (Lap - sigma) p = -(sigma + 2 pi^2 / L^2) p*, with
    dp/dn = 0 on the walls. Runs `replicas` independent estimates of
    n_walks walks at n_points random points, at that file's sigma and at
    the shipped sigma = 350. The estimator is random, so the bounds are
    statistical, in Monte Carlo standard errors (SE) taken from the
    spread between replicas:
      * bias: the mean error over points lies within z_max SE of 0;
      * scatter: the mean squared error equals the estimated MC variance
        of the replica mean within z_max SE — the error is noise only."""
    import jax
    import jax.numpy as jnp
    from nmcfluid.geometry import build_segments
    from nmcfluid.geometry.soup2d import box_loop
    from nmcfluid.wost import (WalkSettings, WostScene,
                               estimate_solution_and_gradient)
    L = 2.0
    k = np.pi / L
    soup = build_segments([box_loop(0.0, L, 0.0, L, n_per_side=4)])
    pts = jax.random.uniform(jax.random.PRNGKey(11), (n_points, 2),
                             jnp.float32, 0.0, L)
    x = np.asarray(pts, np.float64)
    want = np.stack([
        np.cos(k * x[:, 0]) * np.cos(k * x[:, 1]),
        -k * np.sin(k * x[:, 0]) * np.cos(k * x[:, 1]),
        -k * np.cos(k * x[:, 0]) * np.sin(k * x[:, 1])], -1)
    for sigma in sigmas:
        def source(y, sigma=sigma):
            return (sigma + 2.0 * k ** 2) * (jnp.cos(k * y[..., 0])
                                             * jnp.cos(k * y[..., 1]))

        scene = WostScene(dim=2, neumann=soup, source_fn=source,
                          absorption=sigma)
        ws = WalkSettings(n_walks=n_walks)
        est = []
        for r in range(replicas):
            p, g, _ = estimate_solution_and_gradient(
                scene, ws, pts, jax.random.PRNGKey(100 + r))
            est.append(np.concatenate(
                [np.asarray(p, np.float64)[:, None],
                 np.asarray(g, np.float64)], -1))
        est = np.stack(est)                       # (R, N, 3)
        mean = est.mean(0)
        var_mean = est.var(0, ddof=1) / replicas  # MC variance of the mean
        err = mean - want
        for c, what in enumerate(("p", "dp/dx", "dp/dy")):
            e, v = err[:, c], var_mean[:, c]
            z_bias = e.mean() / np.sqrt(v.mean() / n_points)
            d = e ** 2 - v
            z_scatter = d.mean() / (d.std(ddof=1) / np.sqrt(n_points))
            check(abs(z_bias) <= z_max and abs(z_scatter) <= z_max,
                  f"WoSt sigma={sigma:g} {what}: bias z {z_bias:+.2f}, "
                  f"scatter z {z_scatter:+.2f} (|z| <= {z_max}; rms error "
                  f"{np.sqrt((e ** 2).mean()):.3e}, rms SE "
                  f"{np.sqrt(v.mean()):.3e})")


def adam_numerics(n_iters=200, factor=1.25):
    """The TG initial-condition fit (XLA while_loop Adam, 6x64 SIREN,
    64^2 batch) for n_iters iterations on the card and on the CPU from the
    same start with the same batch keys. Adam's update is sign-like, so
    last-bit differences in near-zero gradient coordinates move those
    parameters by ~lr per step and the two runs drift apart; what must
    agree is the loss they reach. Both final losses on one fixed batch
    must lie within `factor` of each other — a band far narrower than the
    fit's own loss drop, which both must show."""
    import jax
    import jax.numpy as jnp
    from nmcfluid.scenes import get_scene
    from nmcfluid.sim import NeuralFluid, sampling
    from nmcfluid.sim.fluid import _fit_source

    scene = dataclasses.replace(get_scene("taylorgreen"),
                                max_n_iters=n_iters)
    fl = NeuralFluid(scene, ls_head=0)
    st = fl.init_state(0)
    args = (st.params, jax.random.PRNGKey(5), st.eps, st.timestep)
    fit = jax.jit(lambda *a: _fit_source(fl, *a)[0])
    p_dev = fit(*args)
    cpu = jax.devices("cpu")[0]
    # XLA:CPU executables are AOT code for the compiling host's CPU, and a
    # persistent compile cache may be shared with other hosts: write no
    # CPU entry (entries are written only for compiles at least this slow)
    min_secs = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    try:
        with jax.default_device(cpu):
            p_cpu = fit(*jax.device_put(args, cpu))
            pts, valid = sampling.training_points(
                jax.random.PRNGKey(77), fl.n_batch, scene,
                scene.sample_pattern, fl.sample_resolution)
            target = scene.source_velocity(pts, key=jax.random.PRNGKey(78))
            w = valid.astype(jnp.float32)

            def loss(p):
                p = jax.device_put(p, cpu)
                u = fl.velocity(p, pts, eps=st.eps, t=0)
                return float(jnp.sum(w * jnp.sum((u - target) ** 2, -1))
                             / jnp.sum(w))

            l0, l_dev, l_cpu = loss(st.params), loss(p_dev), loss(p_cpu)
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          min_secs)
    log(f"  Adam {n_iters} iters: loss start {l0:.6e}, device {l_dev:.6e}, "
        f"cpu {l_cpu:.6e}")
    check(max(l_dev, l_cpu) < l0 / factor,
          f"both fits lower the loss by more than x{factor}")
    check(max(l_dev, l_cpu) <= factor * min(l_dev, l_cpu),
          f"device and CPU final losses within x{factor}")


# ----------------------------------------------------------------- mesh


def mesh_paths(n_dev, n_frames=1, extra=(), error_n=1000):
    """(a) The WoSt projection alone on one fixed divergence grid, the
    shipped TG cloud sharded over n_dev devices against the same solve on
    device 0 alone. The walk RNG is counter-based per (pair, point), so
    the two may differ only by reduction order: max |difference| must be
    <= 1e-5 of the field's max |value|. (b) A TG frame under
    `--mesh n_dev`; its frame-1 TG error must meet the published value."""
    import jax
    from nmcfluid import run
    from nmcfluid.sim.fluid import _divergence_grid, _pressure_solve

    check(len(jax.devices()) >= n_dev, f"{n_dev} devices present")
    base = ["taylorgreen", *extra]
    fl1 = run.make_fluid(run.build_parser().parse_args(base))
    fln = run.make_fluid(run.build_parser().parse_args(
        base + ["--mesh", str(n_dev)]))
    st = fl1.init_state(0)
    div = _divergence_grid(fl1, st.params, st.eps, st.timestep)
    key = jax.random.PRNGKey(21)
    n_chunks = fl1.n_pressure // fl1.wost_chunk

    def solve(fl):
        chunks = [_pressure_solve(fl, fl._wost_scene, (div,),
                                  jax.random.fold_in(key, c))
                  for c in range(n_chunks)]
        return [np.concatenate([np.asarray(c[i]) for c in chunks])
                for i in (0, 2, 3)]

    t0 = time.perf_counter()
    pts1, p1, g1 = solve(fl1)
    t1 = time.perf_counter()
    with fln.mesh:
        ptsn, pn, gn = solve(fln)
    t2 = time.perf_counter()
    log(f"  WoSt {fl1.n_pressure} points: 1 device {t1 - t0:.3f} s, "
        f"{n_dev} devices {t2 - t1:.3f} s (compile included)")
    check(np.array_equal(pts1, ptsn), "same pressure cloud")
    for what, a, b in (("p", p1, pn), ("grad p", g1, gn)):
        rel = float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))
        check(rel <= 1e-5,
              f"sharded {what} matches 1 device: max diff / max {rel:.2e}")
    main_path(("--mesh", str(n_dev), *extra), n_frames=n_frames,
              error_n=error_n, tag=f"tg_mesh{n_dev}")


# ----------------------------------------------------------------- main


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", type=int, default=0,
                    help="run only the N-card sharded walk and frame")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    with phase("1 device"):
        info = device_check()
    from nmcfluid.run import _enable_compile_cache
    _enable_compile_cache()
    if args.mesh:
        with phase(f"mesh {args.mesh}: sharded walk and frame"):
            mesh_paths(args.mesh)
    else:
        with phase("2 compile each TG stage at full width"):
            compile_stages()
        with phase("3 main path: TG wost, 2 frames"):
            main_path()
        with phase("4 TG bem and smoke wost frames"):
            other_modes()
        with phase("5a SIREN against float64"):
            siren_numerics()
        with phase("5b WoSt against the closed form"):
            wost_numerics()
        with phase("5c Adam fit, device against CPU"):
            adam_numerics()
    log(f"total {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"ok": True, "device": info}), flush=True)


if __name__ == "__main__":
    main()
