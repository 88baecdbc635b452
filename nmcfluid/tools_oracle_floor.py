"""Oracle the TG error floor: fits target the ANALYTIC field directly.

Round-3 decomposition attributed the 3.46-3.56e-4 TG plateau to SIREN fit
noise (walk-count sweep + deterministic-bem control), but never measured
the floor itself. This tool runs the 50-frame cadence with every fit
targeting the analytic steady Taylor-Green field — no Monte Carlo, no
semi-Lagrangian backtrace, no pressure solve, no target compounding. Two
fits per frame (matching the advect+project cadence and its noise
injections), chained from the previous frame's params exactly like the
real stepper, under the production fit recipe (XLA while_loop fit,
ls_head). The resulting curve is the irreducible
refit-compounding floor: the part of the error budget a better
projection could never remove.

Reference for the error metric: src/2d/move_density.py:143-152 (mean
squared L2 velocity error on the 1000^2 grid) — same code path as
run.py's error_ours.txt (transport.density.tg_velocity_error).

Usage: python -m nmcfluid.tools_oracle_floor [--frames 50]
       [--fits_per_frame 2] [--out oracle_floor.txt]
"""
import argparse
import json
import os
import time

import jax

if os.environ.get("JAX_PLATFORMS") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np

from nmcfluid.scenes import get_scene
from nmcfluid.sim.fluid import NeuralFluid, _fit_source
from nmcfluid.transport.density import raw_velocity_grid, tg_velocity_error


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--fits_per_frame", type=int, default=2)
    ap.add_argument("--out", default="oracle_floor.txt")
    ap.add_argument("--max_n_iters", type=int, default=None)
    ap.add_argument("--grid", type=int, default=1000)
    args = ap.parse_args()

    scene = get_scene("taylorgreen")
    fluid = NeuralFluid(scene, max_n_iters=args.max_n_iters)
    state = fluid.init_state(0)
    state = fluid.add_source(state)

    params, key = state.params, state.key
    errors = []
    t0 = time.time()
    for frame in range(1, args.frames + 1):
        for _ in range(args.fits_per_frame):
            key, kf = jax.random.split(key)
            params, _ = _fit_source(fluid, params, kf, state.eps,
                                    state.timestep)
        vel = raw_velocity_grid(fluid, params, args.grid)
        err = tg_velocity_error(vel)
        errors.append(err)
        print(f"frame {frame}: oracle_err={err:.6e}", flush=True)
    np.savetxt(args.out, errors)
    print(json.dumps({
        "mean_err_frames_1_to_n": float(np.mean(errors)),
        "first": errors[0], "last": errors[-1],
        "frames": args.frames, "fits_per_frame": args.fits_per_frame,
        "sec_total": round(time.time() - t0, 1),
        "device": str(jax.devices()[0]), "out": args.out}))


if __name__ == "__main__":
    main()
