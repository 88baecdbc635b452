"""Three-way engine-demo comparison: fresh reference run vs ours vs the
committed solution (round-4 verdict ask #6 — close the drift claim with
the reference's own binary).

Round 4 argued from orientation scoring that the committed
`solutions/wost.pfm` reflects older assets. Round 5 ran the decisive
experiment: the reference's standalone demo executable
(bindings/zombie/demo/demo.cpp:365-390) rebuilt from the tree already
used for BASELINE_WALL — with one twist discovered on the way: the
CURRENT reference's demo/scene.h has the boundary-image loading
COMMENTED OUT (scene.h:28-45: isNeumann is hardcoded to 1.0 and both
boundary-value images to 0.0 — the fluid authors gutted the demo scene
loader for their all-Neumann fluid use), so the shipped tree CANNOT
regenerate its own committed engine solution at all. The experiment
restores those loads (in a scratch copy; /root/reference untouched),
regenerates the missing is_neumann.pfm with the reference's own
scenes/image2pfm.py (only the .png ships), and runs wost.json as-is.

This tool ingests the fresh PFM and writes the three-way report:
  fresh-reference vs ours        -> agreement proves our asset reading
  fresh-reference vs committed   -> the drift, now a measurement

Usage: python -m nmcfluid.tools_engine_fresh --fresh PATH/wost.pfm \
           [--ours docs/engine/wost_ours.pfm] [--out docs/engine]
"""
import argparse
import json
import os

import numpy as np

from nmcfluid.utils.pfm import read_pfm


def _stats(a, b, mask):
    d = (a - b)[mask]
    denom = np.sqrt(np.mean(b[mask] ** 2)) + 1e-12
    corr = np.corrcoef(a[mask].ravel(), b[mask].ravel())[0, 1]
    return {"rel_l2": float(np.sqrt(np.mean(d ** 2)) / denom),
            "corr": float(corr),
            "mean_abs": float(np.abs(d).mean()),
            "p95_abs": float(np.percentile(np.abs(d), 95))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fresh", required=True,
                    help="wost.pfm produced by the restored demo binary")
    ap.add_argument("--ours", default="docs/engine/wost_ours.pfm")
    ap.add_argument("--committed",
                    default="/root/reference/bindings/zombie/demo/scenes/"
                            "engine/solutions/wost.pfm")
    ap.add_argument("--out", default="docs/engine")
    args = ap.parse_args()

    fresh = read_pfm(args.fresh)[0]
    ours = read_pfm(args.ours)[0]
    committed = read_pfm(args.committed)[0]
    if fresh.ndim == 3:
        fresh = fresh[..., 0]
    if committed.ndim == 3:
        committed = committed[..., 0]
    if ours.ndim == 3:
        ours = ours[..., 0]

    # the demo masks exterior/near-boundary texels to 0 in all three
    # grids; compare where BOTH operands are informative
    def m(a, b):
        return (a != 0.0) & (b != 0.0) & np.isfinite(a) & np.isfinite(b)

    rep = {
        "shapes": {"fresh": list(fresh.shape), "ours": list(ours.shape),
                   "committed": list(committed.shape)},
        "fresh_vs_ours": _stats(fresh, ours, m(fresh, ours)),
        "fresh_vs_committed": _stats(fresh, committed,
                                     m(fresh, committed)),
        "ours_vs_committed": _stats(ours, committed, m(ours, committed)),
        "note": ("fresh = reference demo.cpp rebuilt with scene.h image "
                 "loads restored (shipped tree has them commented out "
                 "and cannot regenerate its own committed solution); "
                 "is_neumann.pfm regenerated from the shipped .png via "
                 "the reference's scenes/image2pfm.py --normalize"),
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "engine_fresh_report.json"),
              "w") as f:
        json.dump(rep, f, indent=2)
    print(json.dumps(rep, indent=2))

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 3, figsize=(13, 4.2))
        for ax, (img, t) in zip(axes, [(fresh, "fresh reference run"),
                                       (ours, "ours (JAX estimator)"),
                                       (committed,
                                        "committed wost.pfm")]):
            im = ax.imshow(img, origin="lower", vmin=0.0, vmax=1.1,
                           cmap="turbo")
            ax.set_title(t, fontsize=9)
            ax.axis("off")
        fig.colorbar(im, ax=axes, shrink=0.8)
        fig.savefig(os.path.join(args.out, "engine_threeway.png"),
                    dpi=140, bbox_inches="tight")
        print("wrote engine_threeway.png")
    except Exception as e:   # noqa: BLE001 — plotting is best-effort
        print("plot skipped:", e)


if __name__ == "__main__":
    main()
