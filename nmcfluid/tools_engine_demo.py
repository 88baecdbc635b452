"""Reproduce the zombie demo's engine scene on the JAX estimator.

The reference ships a worked image-driven mixed-BC example
(`bindings/zombie/demo/scenes/engine/`: boundary OBJ + is_neumann mask +
dirichlet boundary values, config `wost.json` = pure Laplace, nWalks 96,
maxWalkLength 1024, RR off, ignoreNeumann/ignoreSource true) together
with its COMMITTED solution grid (`solutions/wost.pfm`) — a direct
statistical parity target for the estimator on a scene the fluid never
exercises (nonconvex artist geometry, 38% Dirichlet boundary, walks that
only terminate by reaching the Dirichlet shell).

Grid conventions follow demo/grid.h:35-51 (pt = (i/R, j/R) * extent +
bmin, solution image row = j, col = i) and the saveSolutionGrid masking
(outside-domain or closer than boundaryDistanceMask=1e-2 to either
boundary -> 0).

Usage:
  python -m nmcfluid.tools_engine_demo [--grid 256] [--n_walks 96]
      [--engine_dir .../scenes/engine] [--out docs/engine]
"""
import argparse
import json
import os
import time

import jax

if os.environ.get("JAX_PLATFORMS") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from nmcfluid.scenes.custom import polygon_sdf
from nmcfluid.scenes.images import scene_from_images
from nmcfluid.utils.pfm import read_pfm, write_pfm
from nmcfluid.wost import WalkSettings, estimate_solution

DEFAULT_ENGINE = "/root/reference/bindings/zombie/demo/scenes/engine"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine_dir", default=DEFAULT_ENGINE)
    ap.add_argument("--grid", type=int, default=256)
    ap.add_argument("--n_walks", type=int, default=96)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--walk_cap", type=int, default=1024)
    ap.add_argument("--out", default="docs/engine")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    data = os.path.join(args.engine_dir, "data")

    # scenes/engine/wost.json: ignoreNeumann + ignoreSource -> only the
    # dirichlet values and the geometry/mask matter
    scene, meta = scene_from_images(
        os.path.join(data, "geometry.obj"),
        dirichlet_value=os.path.join(data, "dirichlet_boundary_value.pfm"),
        is_neumann=os.path.join(data, "is_neumann.png"),
        absorption=0.0)
    n_dir = int((~meta["is_neumann_seg"]).sum())
    print(f"engine: {len(meta['segs'])} segments, {n_dir} dirichlet "
          f"({n_dir / len(meta['segs']):.1%})")

    settings = WalkSettings(
        epsilon_shell=1e-3, min_star_radius=1e-3,
        russian_roulette_threshold=0.0, max_walk_length=args.walk_cap,
        walk_step_cap=args.walk_cap, ignore_dirichlet=False,
        ignore_source=True, n_walks=args.n_walks)

    R = args.grid
    bmin, bmax = meta["bmin"], meta["bmax"]
    ext = bmax - bmin
    ii, jj = np.meshgrid(np.arange(R), np.arange(R), indexing="ij")
    pts = np.stack([(ii / R) * ext[0] + bmin[0],
                    (jj / R) * ext[1] + bmin[1]], axis=-1).reshape(-1, 2)

    sdf = polygon_sdf(meta["verts"], meta["segs"])
    inside = np.asarray(sdf(jnp.asarray(pts, jnp.float32)) < 0.0)
    from nmcfluid.geometry import queries2d
    nd = np.asarray(queries2d.distance(scene.neumann,
                                       jnp.asarray(pts, jnp.float32)))
    dd = np.asarray(queries2d.distance(scene.dirichlet,
                                       jnp.asarray(pts, jnp.float32)))
    # saveSolutionGrid mask: outside OR within boundaryDistanceMask (1e-2
    # of the NORMALIZED scene; engine coords are ~1000x that scale)
    bdm = 1e-2 * meta["scale"]
    valid = inside & (np.minimum(nd, dd) >= bdm)
    todo = np.nonzero(valid.reshape(-1))[0]
    print(f"grid {R}x{R}: {valid.mean():.1%} valid, solving "
          f"{len(todo)} points in {-(-len(todo) // args.chunk)} chunks")

    sol = np.zeros(R * R, np.float32)
    key = jax.random.PRNGKey(args.seed)
    t0 = time.time()
    for c, lo in enumerate(range(0, len(todo), args.chunk)):
        idx = todo[lo:lo + args.chunk]
        chunk_pts = jnp.asarray(pts[idx], jnp.float32)
        if len(idx) < args.chunk:     # pad: one compile for every chunk
            pad = args.chunk - len(idx)
            chunk_pts = jnp.concatenate(
                [chunk_pts, jnp.broadcast_to(chunk_pts[-1:], (pad, 2))])
        p, n_valid, _ = estimate_solution(
            scene, settings, chunk_pts, jax.random.fold_in(key, c))
        sol[idx] = np.asarray(p)[:len(idx)]
        print(f"  chunk {c}: {time.time() - t0:.1f}s elapsed, "
              f"mean walks kept {float(jnp.mean(n_valid)):.1f}", flush=True)
    wall = time.time() - t0

    # solution image: row = j, col = i (grid.h saveSolutionGrid get(j, i))
    img = sol.reshape(R, R).T.copy()
    img *= valid.reshape(R, R).T

    os.makedirs(args.out, exist_ok=True)
    write_pfm(os.path.join(args.out, "wost_ours.pfm"), img)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 2, figsize=(11, 5.2))
        ref_path = os.path.join(args.engine_dir, "solutions", "wost.pfm")
        ref = read_pfm(ref_path)[0]
        if ref.ndim == 3:
            ref = ref.mean(-1)
        for ax, a, t in ((axes[0], img, "ours (JAX WoSt)"),
                         (axes[1], ref, "reference (committed wost.pfm)")):
            ax.imshow(a, cmap="turbo", vmin=0.0, vmax=1.1, origin="lower")
            ax.set_title(t)
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(os.path.join(args.out, "engine_compare.png"), dpi=140)
    except Exception as e:          # keep the solve result regardless
        print("plot skipped:", e)
        ref = None

    report = {"grid": R, "n_walks": args.n_walks, "sec": round(wall, 1),
              "n_points": int(len(todo)),
              "device": str(jax.devices()[0])}
    if ref is not None and ref.shape == img.shape:
        # orientation-robust compare: committed PFM vs ours both ways
        for name, r in (("asis", ref), ("flipud", np.flipud(ref).copy())):
            m = (np.abs(r) > 1e-12) & (np.abs(img) > 1e-12)
            if m.sum() == 0:
                continue
            rel = (np.linalg.norm((img - r)[m])
                   / max(np.linalg.norm(r[m]), 1e-12))
            corr = float(np.corrcoef(img[m], r[m])[0, 1])
            report[f"rel_l2_{name}"] = round(float(rel), 4)
            report[f"corr_{name}"] = round(corr, 4)
            report[f"overlap_{name}"] = round(float(m.mean()), 4)
    print(json.dumps(report))
    with open(os.path.join(args.out, "engine_report.json"), "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
