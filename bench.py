"""Benchmark: sec/frame of the 2D Taylor-Green step at reference scale.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

The frame matches the reference cost structure (BASELINE.md): an advection
fit + a projection fit (<=10k Adam iters each, early stop 1.1e-10) around
one WoSt solve (512^2 = 262,144 pressure points x 500 walks, sigma=350,
RR 0.99) with a 1000^2 autodiff divergence grid — all on-device. The first
step compiles + warms; the second is timed. Taylor-Green is the scene the
reference publishes its quantitative results on (error_ours.txt); other
scenes are benchmarked via NMCFLUID_BENCH_SCENE (e.g. karman).

vs_baseline: the reference publishes no wall-clock (BASELINE.json.published
is empty), so BASELINE_WALL.json records the measured cost of the
reference's C++ WoSt pressure solve at the shipped per-frame config
(zombie_bindings rebuilt on a host CPU — see its _doc for the
NaN/orientation fixes required). vs_baseline = reference_wost_seconds / our_FULL_frame
(>1 means faster); it understates the true ratio because the reference
frame also runs two <=10k-iter GPU training fits we cannot time here.

Env overrides for quick checks: NMCFLUID_BENCH_SCALE (divides resolutions),
NMCFLUID_BENCH_ITERS (caps Adam iters), NMCFLUID_BENCH_SCENE,
NMCFLUID_BENCH_PROJECTION, NMCFLUID_BENCH_PLATEAU, NMCFLUID_BENCH_UNROLL
(Adam iterations per while_loop trip — numerically identical at any
value, see _adam_fit), NMCFLUID_BENCH_DETAIL (where to write the detail
JSON; default bench_detail.json).

The headline line stays the reference-parity MC (wost) frame; the same
invocation also times the flagship deterministic mode (bem in 2D,
spectral in 3D) and records it under bench_detail.json["flagship"]
(disable with NMCFLUID_BENCH_FLAGSHIP=0). fit_plateau remains off
everywhere: the round-3 TG gate measured 7.8e-4 / 6.3e-4 error at plateau
500 / 1000 vs the published 4.142e-4.

The benchmark runs on a GPU only: on any other backend it exits non-zero
before timing anything. bench_detail.json names the device (platform,
device_kind, count) and the card's nvidia-smi name and power limit.
"""
import json
import os
import time


def main():
    import jax
    from nmcfluid.run import _enable_compile_cache
    from nmcfluid.utils.device import (card_name_power, device_info,
                                       require_gpu)
    require_gpu()
    _enable_compile_cache()
    from nmcfluid.scenes import get_scene
    from nmcfluid.sim import NeuralFluid

    scale = int(os.environ.get("NMCFLUID_BENCH_SCALE", "1"))
    iters = os.environ.get("NMCFLUID_BENCH_ITERS")
    scene_name = os.environ.get("NMCFLUID_BENCH_SCENE", "taylorgreen")
    projection = os.environ.get("NMCFLUID_BENCH_PROJECTION", "wost")

    scene = get_scene(scene_name)
    # NMCFLUID_BENCH_MESH=N: run the whole frame under an N-device
    # points_mesh. N=1 bounds the sharding overhead on one card.
    mesh = None
    mesh_n = int(os.environ.get("NMCFLUID_BENCH_MESH", "0"))
    if mesh_n:
        from nmcfluid.parallel import points_mesh
        mesh = points_mesh(mesh_n)
    walk_algo = os.environ.get("NMCFLUID_BENCH_ALGO", "gen")
    fluid = NeuralFluid(
        scene,
        projection=projection,
        mesh=mesh,
        fit_plateau=int(os.environ.get("NMCFLUID_BENCH_PLATEAU", "0")),
        fit_unroll=int(os.environ.get("NMCFLUID_BENCH_UNROLL", "4")),
        max_n_iters=int(iters) if iters else scene.max_n_iters,
        sample_resolution=max(8, scene.sample_resolution // scale),
        wost_resolution=max(8, scene.wost_resolution // scale),
        # None -> dim-correct default (1000^2 in 2D, vis_resolution^3 in 3D)
        div_resolution=None if scale == 1 else max(
            32, (1000 if scene.dim == 2 else scene.vis_resolution) // scale),
        walk_settings=scene.walk_settings(
            n_walks=max(8, scene.n_walks // scale), algo=walk_algo))

    state = fluid.init_state(0)
    state = fluid.add_source(state)
    if scene_name == "karman":
        state = state._replace(eps=state.eps / 2)    # main.py:161-163

    t0 = time.time()
    state = fluid.step(state)                     # compile + warm
    jax.block_until_ready(state.params)
    warm = time.time() - t0

    t0 = time.time()
    state = fluid.step(state)
    jax.block_until_ready(state.params)
    sec = time.time() - t0

    # third step: per-stage wall-clock breakdown (synchronized between
    # stages, so run AFTER the clean timed step)
    fluid.profile = True
    fluid.stage_times = {}
    state = fluid.step(state)
    jax.block_until_ready(state.params)
    stages = {k: round(v, 3) for k, v in fluid.stage_times.items()}

    baseline = None
    try:
        with open(os.path.join(os.path.dirname(__file__),
                               "BASELINE_WALL.json")) as f:
            baseline = json.load(f).get(f"{scene_name}_sec_per_frame")
    except (OSError, json.JSONDecodeError):
        pass
    vs = (baseline / sec) if baseline else 1.0

    # flagship frame (the parity wost frame AND the best deterministic
    # mode in one capture): bem in 2D, spectral in 3D
    # (the 3D scenes keep obstacles out of the WoSt boundary, so the DCT
    # box solve is exact — README per-scene defaults table). plateau
    # stays off (killed by the r3 TG error gate).
    flagship = None
    flag_proj = "bem" if scene.dim == 2 else "spectral"
    if (projection == "wost"
            and os.environ.get("NMCFLUID_BENCH_FLAGSHIP") != "0"):
        fl2 = NeuralFluid(
            scene, projection=flag_proj,
            max_n_iters=int(iters) if iters else scene.max_n_iters,
            sample_resolution=max(8, scene.sample_resolution // scale),
            wost_resolution=max(8, scene.wost_resolution // scale),
            div_resolution=None if scale == 1 else max(
                32,
                (1000 if scene.dim == 2 else scene.vis_resolution) // scale),
            walk_settings=scene.walk_settings(
                n_walks=max(8, scene.n_walks // scale)))
        st2 = fl2.add_source(fl2.init_state(0))
        if scene_name == "karman":
            st2 = st2._replace(eps=st2.eps / 2)
        st2 = fl2.step(st2)                  # compile + warm
        jax.block_until_ready(st2.params)
        t0 = time.time()
        st2 = fl2.step(st2)
        jax.block_until_ready(st2.params)
        fsec = time.time() - t0
        flagship = {"projection": flag_proj, "timed_step_s": round(fsec, 3),
                    "vs_baseline": round(baseline / fsec, 3)
                    if baseline else None}

    print(json.dumps({
        "metric": f"{scene_name}{scene.dim}d_sec_per_frame",
        "value": round(sec, 3),
        "unit": "s",
        "vs_baseline": round(vs, 3),
        # the baseline wall-clock is the reference's zombie walk stage on
        # ONE host CPU core (BASELINE_WALL.json) — not a like-for-like
        # accelerator number
        "baseline_host": "1-core CPU (reference wost stage)",
    }))
    # the stdout contract is one line; diagnostics go to the detail file
    detail_path = os.environ.get("NMCFLUID_BENCH_DETAIL", "bench_detail.json")
    with open(detail_path, "w") as f:
        json.dump({"warm_step_s": warm, "timed_step_s": sec,
                   "baseline_host": "1-core CPU (reference wost stage)",
                   "stage_breakdown_s": stages,
                   "flagship": flagship,
                   "scene": scene_name, "projection": projection,
                   "scale": scale, "iters_cap": iters,
                   "mesh_devices": mesh_n or None,
                   "walk_algo": walk_algo,
                   "device": device_info(),
                   "card": card_name_power()}, f, indent=2)


def _entry():
    scene_name = os.environ.get("NMCFLUID_BENCH_SCENE", "taylorgreen")
    try:
        main()
    except Exception as e:    # noqa: BLE001 — contract: one JSON line
        print(json.dumps({
            "metric": f"{scene_name}_sec_per_frame",
            "value": None, "unit": "s", "vs_baseline": None,
            "error": f"{type(e).__name__}: {e}"[:400],
        }))
        raise SystemExit(1)


if __name__ == "__main__":
    _entry()
