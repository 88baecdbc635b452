"""Quantitative vortex-street metrics for a 3D karman run.

`python -m nmcfluid.tools_street3d EXP [--scene karman3d] [--out png]`

The reference validates karman3d qualitatively only (volume renders of
the advected density, final_material/karman_3d); this measures the
shedding physics instead, like `tools_compare_street` does in 2D: the
transverse velocity u_x at a probe 6 radii downstream of the cylinder
(on the wake centerline, mid-span y=0), for every checkpoint, then
onset frame + dominant frequency as a Strouhal number St = f D / U.
The 2D street uses probe *vorticity*; in 3D the transverse velocity
component is the standard shedding signal (one scalar, no curl stencil).

Cheap on CPU (one 5-layer SIREN eval per checkpoint): run with
JAX_PLATFORMS=cpu so it never touches the accelerator.
"""
import argparse
import json
import os

import numpy as np

from .scenes import get_scene
from .sim import NeuralFluid
from .tools_compare_street import street_metrics
from .utils import load_ckpt, latest_step


def probe_series_vel(exp_dir, scene, probes, comp=0, t_max=None):
    """Velocity component `comp` at probe points per checkpoint -> (T, P)."""
    import jax.numpy as jnp
    fluid = NeuralFluid(scene, max_n_iters=1)
    model_dir = os.path.join(exp_dir, "model")
    last = latest_step(model_dir)
    if last < 0:
        raise SystemExit(f"no checkpoints under {model_dir}")
    if t_max is not None:
        last = min(last, t_max)
    st = fluid.init_state(0)
    pts = jnp.asarray(probes, jnp.float32)
    out = []
    for t in range(1, last + 1):
        params, _ = load_ckpt(model_dir, st.params, t)
        u = fluid.velocity(params, pts, eps=st.eps, t=t)
        out.append(np.asarray(u[:, comp]))
    return np.stack(out)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("exp")
    p.add_argument("--scene", default="karman3d")
    p.add_argument("--t_max", type=int, default=None)
    p.add_argument("--out", default=None, help="optional png path")
    args = p.parse_args(argv)

    scene = get_scene(args.scene)
    assert scene.dim == 3, "use tools_compare_street for 2D scenes"
    # karman3d: cylinder axis || y at (x, z) = (0, -0.8), r = 0.1
    # (src/3d/main.py:92-94); inflow +z at karman_vel. Probe 6 radii
    # downstream on the centerline at mid-span; shedding = u_x.
    cx, cz = 0.0, -0.8
    r = 0.1
    probes = [(cx, 0.0, cz + 6.0 * r)]
    d, u = 2.0 * r, scene.karman_vel

    s = probe_series_vel(args.exp, scene, probes, comp=0,
                         t_max=args.t_max)[:, 0]
    m = street_metrics(s, scene.dt, d, u)
    m["exp"] = args.exp
    print(json.dumps(m))

    if args.out:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(8, 3))
        ax.plot(np.arange(1, len(s) + 1) * scene.dt, s)
        if m["onset_frame"] is not None:
            ax.axvline((m["onset_frame"] + 1) * scene.dt, ls="--", c="gray")
        ax.set_xlabel("t")
        ax.set_ylabel("u_x at probe")
        st_txt = (f"St = {m['strouhal']:.4f}" if m["strouhal"]
                  else "no developed street")
        ax.set_title(f"{args.scene} probe u_x — {st_txt}")
        fig.tight_layout()
        fig.savefig(args.out, dpi=150)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
