"""Simulation driver CLI: `python -m nmcfluid.run <scene> [options]`.

Replaces src/{2d,3d}/main.py + config.py + examples/*/run.sh: all per-scene
hyperparameters live in the scene catalog (nmcfluid.scenes); flags override.
Per timestep it saves a checkpoint and (optionally) velocity/vorticity
frames, then optionally replays the density/export pass
(src/{2d,3d}/move_density.py) — `--density`.
"""
import argparse
import json
import os
import time

import numpy as np

import jax


_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir(backend, environ=os.environ):
    """The persistent compilation cache directory this program sets for
    `backend`, or None when it sets none.

    With JAX_COMPILATION_CACHE_DIR set, JAX reads the variable itself and
    the program sets nothing. Otherwise accelerator executables go to
    <checkout>/.jax_cache/<backend>: a fixed path, because the path is part
    of the cache key. XLA:CPU executables are AOT code specialized to the
    compiling host's CPU features, and loading one built on another host
    can crash the process (SIGILL), so the CPU cache is opt-in
    (NMCFLUID_CPU_CACHE=1) and keyed by a host-feature fingerprint."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    base = os.path.join(_CHECKOUT, ".jax_cache")
    if backend == "cpu":
        if environ.get("NMCFLUID_CPU_CACHE") != "1":
            return None
        return os.path.join(base, f"cpu-{_host_fingerprint()}")
    return os.path.join(base, backend)


def _enable_compile_cache():
    """Point JAX's persistent compilation cache at compile_cache_dir."""
    path = compile_cache_dir(jax.default_backend())
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)


def _host_fingerprint():
    """Short stable hash of this host's CPU feature flags."""
    import hashlib
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
                    return hashlib.sha1(feats.encode()).hexdigest()[:10]
    except OSError:
        pass
    import platform
    return hashlib.sha1(
        (platform.machine() + platform.processor()).encode()
    ).hexdigest()[:10]

from .scenes import get_scene, SCENES
from .sim import NeuralFluid
from .sim import sampling
from .utils import save_ckpt, load_ckpt, latest_step


def build_parser():
    p = argparse.ArgumentParser(
        description="Neural Monte Carlo fluid simulation")
    p.add_argument("scene", choices=sorted(SCENES))
    p.add_argument("--exp_name", default=None)
    p.add_argument("--out", default="results")
    p.add_argument("--n_timesteps", type=int, default=None)
    p.add_argument("--max_n_iters", type=int, default=None)
    p.add_argument("--sample_resolution", type=int, default=None)
    p.add_argument("--wost_resolution", type=int, default=None)
    p.add_argument("--div_resolution", type=int, default=None)
    p.add_argument("--n_walks", type=int, default=None)
    p.add_argument("--walk_step_cap", type=int, default=64,
                   help="lockstep while-loop cap (pool mode caps at "
                        "--pool_step_cap instead)")
    p.add_argument("--walk_algo", default="gen",
                   choices=["pool", "gen", "lockstep"],
                   help="WoSt gradient executor: compacted walker pool "
                        "(cost ~ sum of walk lengths), point-aligned "
                        "generations (zero gathers/scatters — fastest "
                        "on short-walk scenes like the sigma=350 box "
                        "configs), or the round-1 lockstep pair loop")
    p.add_argument("--pool_step_cap", type=int, default=1024)
    p.add_argument("--adaptive_walks", type=float, default=0.0,
                   help="adaptive MC walk allocation (pool mode): kappa "
                        "scaling of the equal-RMS-error optimal budget "
                        "n_i ~ sigma_i; 0 = the reference's fixed "
                        "n_walks per point (WalkSettings.adaptive_walks)")
    p.add_argument("--grad_clip", type=float, default=-1.0,
                   help="global-l2 gradient clip for the phase fits, "
                        "<=0 off (config.py --grad_clip)")
    p.add_argument("--vis_frequency", type=int, default=0,
                   help="record the minibatch loss every N fit "
                        "iterations and write per-phase loss_*.txt "
                        "traces under txt/ (the reference's "
                        "--vis_frequency intra-training introspection, "
                        "config.py:102; 0 = off)")
    p.add_argument("--adv_ref", type=int, default=0)
    p.add_argument("--lr_schedule", default="constant",
                   choices=["constant", "cosine", "tail"])
    p.add_argument("--fit_plateau", type=int, default=0,
                   help="stop a phase fit at the end of any N-iter "
                        "window that improved the smoothed loss by "
                        "<0.5%% relative (0 = reference behavior: run "
                        "all max_n_iters; TG-gated OFF by default — "
                        "see PARITY.md 'fit_plateau gate')")
    p.add_argument("--param_ema", type=float, default=0.0,
                   help="Polyak parameter averaging per phase (0 = off)")
    p.add_argument("--ls_head", type=int, default=8,
                   help="finish every phase fit with a closed-form "
                        "weighted-ridge solve of the final linear layer "
                        "over N fresh minibatches (the hard-BC wrapper "
                        "is affine in the raw output, so the head "
                        "optimum is exact; 0 = off; default 8 passed "
                        "the round-3 TG gate, see PARITY.md 'ls_head "
                        "gate')")
    p.add_argument("--wost_source", default="grid",
                   choices=["grid", "net"],
                   help="walk source term: 'net' evaluates -div u from "
                        "the network at the sampled point (matmuls; no "
                        "texel gather, no nearest-cell error); 'grid' "
                        "is the reference's cached 1000^2 nearest-texel "
                        "lookup")
    p.add_argument("--fit_ensemble", type=int, default=1,
                   help="average N independent phase fits — MEASURED "
                        "NEGATIVE at shipped fit lengths (trajectories "
                        "decohere; see PARITY.md 'fit averaging'); "
                        "kept for short-fit configurations")
    p.add_argument("--fit_unroll", type=int, default=4,
                   help="Adam iterations per while-loop trip in the phase "
                        "fits (results identical for any value; >1 "
                        "amortizes the per-trip loop overhead)")
    p.add_argument("--projection", default="wost",
                   choices=["wost", "spectral", "bem", "bvc"],
                   help="MC walk-on-stars (reference), 'spectral' "
                        "(deterministic DCT grid solve + Bessel-K modal "
                        "obstacle correction; exact on box and "
                        "circle-obstacle scenes, unsupported on jpipe), "
                        "'bem' (deterministic FFT volume potential + "
                        "Nystrom boundary solve; any 2D scene incl. "
                        "jpipe), or 'bvc' (zombie's boundary value "
                        "caching productionized: WoSt walks only at the "
                        "small boundary cache + the bem splat — the MC "
                        "estimator family at a fraction of the walk)")
    # scene-hyperparameter overrides (config.py:87-156 argparse surface)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--dt", type=float, default=None)
    p.add_argument("--bdry_eps", type=float, default=None)
    p.add_argument("--karman_vel", type=float, default=None)
    p.add_argument("--num_hidden_layers", type=int, default=None)
    p.add_argument("--hidden_features", type=int, default=None)
    p.add_argument("--nonlinearity", default=None,
                   choices=["sine", "relu", "elu", "tanh"])
    p.add_argument("--sample", default=None, dest="sample_pattern",
                   choices=["random", "uniform", "random+uniform"])
    p.add_argument("--reset_wts", type=int, default=None)
    p.add_argument("--src_duration", type=int, default=None)
    p.add_argument("--vis_resolution", type=int, default=None)
    p.add_argument("--vel_vis_resolution", type=int, default=None)
    p.add_argument("--early_stop_loss", type=float, default=None)
    p.add_argument("--absorption", type=float, default=None,
                   help="screening coefficient sigma (wost.json "
                        "absorptionCoeff; 350 in every shipped config) — "
                        "exposed for the screening-weight ablation")
    p.add_argument("--ckpt", type=int, default=-1,
                   help="resume from step N (config.py --ckpt). Like the "
                        "reference's loop, --n_timesteps counts steps run "
                        "THIS invocation, not the absolute final step")
    p.add_argument("--until", type=int, default=None,
                   help="stop once the absolute step counter reaches N "
                        "(a --ckpt resume otherwise runs --n_timesteps "
                        "MORE steps and overshoots the shipped frame "
                        "count)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--draw", action="store_true",
                   help="save velocity/vorticity pngs per frame")
    p.add_argument("--density", action="store_true",
                   help="run the density/export replay after simulating")
    p.add_argument("--density_only", action="store_true",
                   help="skip simulation: run only the density/export "
                        "replay over the checkpoints already in the "
                        "experiment dir (the reference ships this as the "
                        "separate move_density.py invocation in run.sh)")
    p.add_argument("--density_resolution", type=int, default=None,
                   help="density transport grid (default: the "
                        "reference's 1000^2 / 200^3, move_density.py)")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard the MC solve over N devices (0 = off)")
    p.add_argument("--profile_dir", default=None,
                   help="capture a jax.profiler device trace of timestep "
                        "1 into DIR (open with TensorBoard/XProf); "
                        "per-stage wall-clock prints are always on via "
                        "--stage_times")
    p.add_argument("--stage_times", action="store_true",
                   help="print the per-stage wall-clock breakdown "
                        "(advect fit / div grid / WoSt / projection fit) "
                        "each timestep")
    return p


def scene_with_overrides(args):
    import dataclasses
    scene = get_scene(args.scene)
    over = {}
    for f in ("lr", "dt", "bdry_eps", "karman_vel", "num_hidden_layers",
              "hidden_features", "nonlinearity", "sample_pattern",
              "src_duration", "vis_resolution", "vel_vis_resolution",
              "early_stop_loss", "absorption"):
        v = getattr(args, f)
        if v is not None:
            over[f] = v
    if args.reset_wts is not None:
        over["reset_wts"] = bool(args.reset_wts)
    return dataclasses.replace(scene, **over) if over else scene


def make_fluid(args):
    scene = scene_with_overrides(args)
    mesh = None
    if args.mesh:
        from .parallel import points_mesh
        mesh = points_mesh(args.mesh)
    ws = None
    if (args.n_walks or args.walk_step_cap != 64 or args.walk_algo != "gen"
            or args.pool_step_cap != 1024 or args.adaptive_walks > 0.0):
        ws = scene.walk_settings(n_walks=args.n_walks or scene.n_walks,
                                 walk_step_cap=args.walk_step_cap,
                                 algo=args.walk_algo,
                                 pool_step_cap=args.pool_step_cap,
                                 adaptive_walks=args.adaptive_walks)
    return NeuralFluid(scene,
                       max_n_iters=args.max_n_iters,
                       sample_resolution=args.sample_resolution,
                       wost_resolution=args.wost_resolution,
                       div_resolution=args.div_resolution,
                       walk_settings=ws,
                       adv_ref=bool(args.adv_ref),
                       projection=args.projection,
                       lr_schedule=args.lr_schedule,
                       param_ema=args.param_ema,
                       grad_clip=args.grad_clip,
                       fit_unroll=args.fit_unroll,
                       fit_plateau=args.fit_plateau,
                       ls_head=args.ls_head,
                       fit_ensemble=args.fit_ensemble,
                       wost_source=args.wost_source,
                       loss_trace=args.vis_frequency,
                       mesh=mesh)


def draw_frame(fluid, state, dirs, t):
    from .ops.diff_ops import curl2d
    from .utils import vis
    scene = fluid.scene
    res = scene.vel_vis_resolution
    u = np.asarray(fluid.sample_velocity_grid(state, res))
    pts = np.asarray(sampling.uniform_grid(scene.scene_size, res, True))
    vis.save_txt_grid(os.path.join(dirs["txt"],
                                   f"velocity_values_t{t:03d}.txt"), u)
    vis.save_txt_grid(os.path.join(dirs["txt"],
                                   f"velocity_samples_t{t:03d}.txt"), pts)
    if scene.dim == 2:
        vis.draw_vector_field2d(u[..., 0], u[..., 1], pts[..., 0],
                                pts[..., 1],
                                os.path.join(dirs["velocity"],
                                             f"velocity_t{t:03d}.png"))
        grid = sampling.uniform_grid(scene.scene_size, scene.vis_resolution)
        w = np.asarray(curl2d(
            lambda p: fluid.velocity(state.params_prev, p, eps=state.eps,
                                     t=state.timestep),
            grid))
        vis.draw_scalar_field2d(w, os.path.join(dirs["vorticity"],
                                                f"vorticity_t{t:03d}.png"),
                                vmin=-5, vmax=5)
        np.savetxt(os.path.join(dirs["txt"], f"vorticity_values_t{t:03d}.txt"),
                   w.reshape(-1, 1))


def dump_pressure_debug(fluid, dirs, t):
    """Per-projection debug artifacts (model_split.py:249-270): scatter
    plots of p and grad p over the pressure cloud + the divergence grid."""
    from .utils import vis
    proj = getattr(fluid, "_last_projection", None)
    if proj is None or fluid.scene.dim != 2:
        return
    pts, p, grad_p, div = (np.asarray(a) for a in proj)
    pdir = dirs["pressure"]
    vis.draw_scatter(pts, p, os.path.join(pdir, f"p_t{t:03d}.png"))
    vis.draw_scatter(pts, grad_p[:, 0],
                     os.path.join(pdir, f"gradp_x_t{t:03d}.png"))
    vis.draw_scatter(pts, grad_p[:, 1],
                     os.path.join(pdir, f"gradp_y_t{t:03d}.png"))
    vis.draw_scalar_field2d(div, os.path.join(pdir, f"div_t{t:03d}.png"))


def load_energy(exp_dir, ckpt):
    """Preload the kinetic-energy curve on --ckpt resume so the per-step
    overwrite of energy.txt (3d/main.py:168-179 semantics) keeps the
    pre-resume rows. Row k holds the energy after step k+1, so a resume
    from checkpoint N keeps at most the first N rows."""
    path = os.path.join(exp_dir, "energy.txt")
    if ckpt <= 0 or not os.path.exists(path):
        return []
    rows = np.loadtxt(path, ndmin=1)
    return [float(e) for e in rows[:ckpt]]


def assemble_gifs(exp_dir, dirs):
    """Per-run gif assembly (2d/vis_utils.py:103-106)."""
    from .utils import vis
    for sub, pattern in (("velocity", "velocity_t"),
                         ("vorticity", "vorticity_t"),
                         ("density", "density_t")):
        d = dirs.get(sub, os.path.join(exp_dir, sub))
        if os.path.isdir(d):
            try:
                vis.frames_to_gif(d, pattern,
                                  os.path.join(exp_dir, f"{sub}.gif"))
            except (ValueError, OSError):
                pass  # no frames written for this artifact


def run_density(fluid, args, exp_dir, model_dir):
    from .transport import transport_rollout, init_density
    scene = fluid.scene
    dens_dir = os.path.join(exp_dir, "density")
    os.makedirs(dens_dir, exist_ok=True)
    last = latest_step(model_dir)
    params0 = fluid.init_state(args.seed).params

    def params_iter():
        for t in range(last + 1):
            try:
                params, _ = load_ckpt(model_dir, params0, t)
            except FileNotFoundError:
                return
            yield params

    errors = []
    vdb = None
    try:
        import pyopenvdb as vdb  # optional (README Setup)
    except ImportError:
        pass
    # vortex_collide ships a red/blue ring color grid in every frame's VDB
    # (3d/move_density.py:112-116,230-243)
    n_dens = args.density_resolution or (1000 if scene.dim == 2 else 200)
    col = None
    if scene.name == "vortex_collide":
        col = np.asarray(init_density(scene, n_dens)[1])
    for t, d_grid, vel, err in transport_rollout(
            fluid, params_iter(), n=n_dens):
        if scene.dim == 2:
            from .utils import vis
            vis.draw_scalar_field2d(np.asarray(d_grid),
                                    os.path.join(dens_dir,
                                                 f"density_t{t:03d}.png"),
                                    cmap="Blues")
        elif vdb is not None:
            den = vdb.FloatGrid()
            den.copyFromArray(np.asarray(d_grid))
            den.transform = vdb.createLinearTransform(voxelSize=0.01)
            den.name = "density"
            velg = vdb.Vec3SGrid()
            velg.copyFromArray(np.asarray(vel))
            velg.transform = vdb.createLinearTransform(voxelSize=0.01)
            velg.name = "vel"
            grids = [den, velg]
            if col is not None:
                cg = vdb.Vec3SGrid()
                cg.copyFromArray(col)
                cg.transform = vdb.createLinearTransform(voxelSize=0.01)
                cg.name = "Cd"
                grids.append(cg)
            vdb.write(os.path.join(dens_dir, f"density_t{t:03d}.vdb"),
                      grids=grids)
        else:
            extra = {"Cd": col} if col is not None else {}
            np.savez_compressed(os.path.join(dens_dir,
                                             f"density_t{t:03d}.npz"),
                                density=np.asarray(d_grid),
                                vel=np.asarray(vel), **extra)
        if err is not None:
            errors.append(err)
            print(f"density t={t} tg_err={err:.6e}")
    if errors:
        np.savetxt(os.path.join(exp_dir, "error_ours.txt"), errors)
        print("Mean Error:", float(np.mean(errors)))


def _code_revision():
    """Git commit of the running code (+ dirty marker), or None outside a
    checkout — stamped into config.json so every experiment records the
    exact revision that produced it."""
    import subprocess
    if not os.path.isdir(os.path.join(_CHECKOUT, ".git")):
        return None
    root = _CHECKOUT
    try:
        rev = subprocess.run(
            ["git", "-C", root, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10)
        if rev.returncode != 0:
            return None
        dirty = subprocess.run(
            ["git", "-C", root, "status", "--porcelain",
             "--untracked-files=no"],
            capture_output=True, text=True, timeout=10)
        mark = "-dirty" if dirty.stdout.strip() else ""
        return rev.stdout.strip() + mark
    except (OSError, subprocess.TimeoutExpired):
        return None


def main(argv=None):
    simulate(argv)


def simulate(argv=None):
    """The CLI's whole run; returns (fluid, final state), where the state
    is None under --density_only."""
    _enable_compile_cache()
    args = build_parser().parse_args(argv)
    scene = scene_with_overrides(args)
    exp = args.exp_name or args.scene
    exp_dir = os.path.join(args.out, exp)
    model_dir = os.path.join(exp_dir, "model")
    dirs = {k: os.path.join(exp_dir, k)
            for k in ("velocity", "vorticity", "txt", "pressure")}
    for d in [exp_dir, model_dir] + list(dirs.values()):
        os.makedirs(d, exist_ok=True)
    # the reference snapshots the full source tree per experiment for
    # reproducibility (config.py:49-56); the equivalent here is pinning
    # the exact code revision alongside the flags
    cfg = dict(vars(args))
    cfg["code_revision"] = _code_revision()
    with open(os.path.join(exp_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)

    fluid = make_fluid(args)
    if args.density_only:
        run_density(fluid, args, exp_dir, model_dir)
        dirs["density"] = os.path.join(exp_dir, "density")
        assemble_gifs(exp_dir, dirs)
        return fluid, None
    n_steps = args.n_timesteps or scene.n_timesteps

    state = fluid.init_state(args.seed)
    if args.ckpt > 0:
        params, t = load_ckpt(model_dir, state.params, args.ckpt)
        state = state._replace(params=params,
                               params_prev=jax.tree.map(np.copy, params),
                               params_tilde=jax.tree.map(np.copy, params),
                               timestep=t)
        print(f"resumed from step {t}")
    else:
        t0 = time.time()
        state = fluid.add_source(state)
        stats = fluid._last_stats
        print(f"add_source: {int(stats.iters)} iters, "
              f"loss {float(stats.loss):.3e}, {time.time() - t0:.1f}s")
        save_ckpt(model_dir, state.params, 0)
        if args.draw:
            draw_frame(fluid, state, dirs, 0)

    # karman halves the ramp width after fitting the IC (main.py:161-163)
    if scene.name in ("karman", "karman2cyl", "karman3cyl"):
        state = state._replace(eps=state.eps / 2)

    fluid.profile = bool(args.stage_times)
    energy = load_energy(exp_dir, args.ckpt)
    if args.until is not None:
        n_steps = max(0, args.until - int(state.timestep))
    for it in range(n_steps):
        t0 = time.time()
        # re-fit the source while the ABSOLUTE frame counter t is in
        # (0, src_duration) (main.py:164-171: t = fluid.timestep - 1) —
        # keyed on state.timestep, not the loop index, so --ckpt resumes
        # don't re-apply the source at the wrong frames. The reference
        # increments fluid.timestep before re-sourcing, so the fit sees
        # the upcoming step's time (time-seeded jets).
        ts = int(state.timestep)
        if 0 < ts < scene.src_duration:
            state = fluid.add_source(
                state._replace(timestep=state.timestep + 1))
            state = state._replace(timestep=state.timestep - 1)
        tracing = args.profile_dir and it == 0
        if tracing:
            jax.profiler.start_trace(args.profile_dir)
        fluid.stage_times = {}
        state = fluid.step(state)
        jax.block_until_ready(state.params)   # async dispatch: sync first
        if tracing:
            jax.profiler.stop_trace()
            print(f"profiler trace -> {args.profile_dir}")
        t = int(state.timestep)
        iters = ""
        if args.fit_plateau > 0 and isinstance(fluid._last_stats, tuple):
            iters = " iters=" + "/".join(
                str(int(s.iters)) for s in fluid._last_stats)
        print(f"timestep {t}: {time.time() - t0:.1f}s "
              f"P={float(state.P):.3e}{iters}")
        if args.stage_times and fluid.stage_times:
            print("  stages: " + "  ".join(
                f"{k}={v:.1f}s" for k, v in fluid.stage_times.items()))
        save_ckpt(model_dir, state.params, t)
        if args.vis_frequency and isinstance(fluid._last_stats, tuple):
            for name, st in zip(("advect", "project", "advect2",
                                 "project2"), fluid._last_stats):
                if st.trace is not None:
                    np.savetxt(os.path.join(
                        dirs["txt"], f"loss_{name}_t{t:03d}.txt"),
                        np.asarray(st.trace))
        if args.draw:
            draw_frame(fluid, state, dirs, t)
            dump_pressure_debug(fluid, dirs, t)
        if scene.dim == 3:
            # kinetic-energy curve (3d/main.py:168-179)
            energy.append(float(fluid.kinetic_energy(state)))
            np.savetxt(os.path.join(exp_dir, "energy.txt"), energy)

    if args.density:
        run_density(fluid, args, exp_dir, model_dir)
    if args.draw or args.density:
        dirs["density"] = os.path.join(exp_dir, "density")
        assemble_gifs(exp_dir, dirs)
    return fluid, state


if __name__ == "__main__":
    main()
