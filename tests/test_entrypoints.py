"""The program's entry points as a user meets them: matmul precision, the
compile-cache location, what the entry modules import, the GPU-only
benchmark and smoke run, and the simulation CLI end to end."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)      # bench.py and chip_smoke.py live at the root


def _python(code, env=None, cwd=ROOT, timeout=120):
    full = dict(os.environ, JAX_PLATFORMS="cpu")
    full.pop("JAX_COMPILATION_CACHE_DIR", None)
    full.update(env or {})
    return subprocess.run([sys.executable, "-c", code], env=full, cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


# ------------------------------------------------------------ precision


def test_precision_default_is_highest(monkeypatch):
    from nmcfluid.models.siren import resolve_precision
    monkeypatch.delenv("NMCFLUID_MATMUL_PRECISION", raising=False)
    assert resolve_precision() == jax.lax.Precision.HIGHEST


def test_precision_high_is_tf32_class(monkeypatch):
    from nmcfluid.models.siren import resolve_precision
    monkeypatch.setenv("NMCFLUID_MATMUL_PRECISION", "HIGH")
    assert resolve_precision() == jax.lax.Precision.HIGH
    assert resolve_precision("highest") == jax.lax.Precision.HIGHEST


def test_precision_unknown_raises():
    from nmcfluid.models.siren import resolve_precision
    with pytest.raises(ValueError, match="NMCFLUID_MATMUL_PRECISION"):
        resolve_precision("tf32")


# -------------------------------------------------------- compile cache


def test_compile_cache_env_dir_is_used_verbatim(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the program sets no directory of
    its own: JAX's cache is exactly that directory, no subdirectory."""
    from nmcfluid.run import compile_cache_dir
    env_dir = str(tmp_path / "cc")
    assert compile_cache_dir(
        "gpu", {"JAX_COMPILATION_CACHE_DIR": env_dir}) is None
    r = _python("import jax; from nmcfluid.run import _enable_compile_cache;"
                " _enable_compile_cache();"
                " print(jax.config.jax_compilation_cache_dir)",
                env={"JAX_COMPILATION_CACHE_DIR": env_dir})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == env_dir


def test_compile_cache_default_is_checkout_gpu_dir(tmp_path, monkeypatch):
    from nmcfluid.run import compile_cache_dir
    monkeypatch.chdir(tmp_path)
    want = os.path.join(ROOT, ".jax_cache", "gpu")
    assert compile_cache_dir("gpu", {}) == want
    # the CPU cache stays off unless opted into (host-specific AOT code)
    assert compile_cache_dir("cpu", {}) is None
    opt_in = compile_cache_dir("cpu", {"NMCFLUID_CPU_CACHE": "1"})
    assert opt_in.startswith(os.path.join(ROOT, ".jax_cache", "cpu-"))


# -------------------------------------------------------------- imports


def test_entry_modules_import_no_pallas_or_matplotlib():
    r = _python("import sys, nmcfluid.run, bench, chip_smoke;"
                " import nmcfluid.transport, nmcfluid.sim.bem;"
                " bad = sorted(m for m in sys.modules"
                " if m.startswith(('jax.experimental.pallas', 'matplotlib')));"
                " print(bad)")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


# ------------------------------------------------ GPU-only entry points


def test_bench_refuses_cpu_before_timing(monkeypatch, capsys):
    import bench
    import nmcfluid.sim

    def no_fluid(*a, **k):
        raise AssertionError("bench built a fluid on the CPU")

    monkeypatch.setattr(nmcfluid.sim, "NeuralFluid", no_fluid)
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.main()
    with pytest.raises(SystemExit) as exc:
        bench._entry()
    assert exc.value.code == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] is None and "no GPU" in line["error"]


def test_chip_smoke_fails_on_cpu_without_result():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


# ------------------------------------------------------------------ CLI


def test_run_main_writes_checkpoints_without_matplotlib(tmp_path,
                                                         monkeypatch):
    """The CLI's simulate path and the TG error it is judged by need no
    plotting library (None in sys.modules makes the import fail)."""
    from nmcfluid import run
    import chip_smoke
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    args = ["taylorgreen", "--n_timesteps", "1", "--max_n_iters", "30",
            "--sample_resolution", "8", "--wost_resolution", "8",
            "--div_resolution", "16", "--n_walks", "8",
            "--walk_step_cap", "8", "--out", str(tmp_path)]
    assert run.main(args) is None
    model_dir = tmp_path / "taylorgreen" / "model"
    assert sorted(os.listdir(model_dir)) == ["ckpt_step_t000.npz",
                                             "ckpt_step_t001.npz"]
    cfg = json.loads((tmp_path / "taylorgreen" / "config.json").read_text())
    assert cfg["n_timesteps"] == 1
    fluid = run.make_fluid(run.build_parser().parse_args(args))
    errs = chip_smoke.tg_errors(fluid, str(model_dir), 1, n=32)
    assert len(errs) == 2 and np.all(np.isfinite(errs))


@pytest.mark.parametrize("scene_name", ["taylorgreen", "karman", "smoke"])
def test_chip_smoke_float64_siren_reference(scene_name):
    """The smoke run's float64 forward/backprop reference agrees with the
    repo's SIREN and jax.grad on the CPU at each family's depth."""
    import jax.numpy as jnp
    import chip_smoke
    from nmcfluid.models.siren import SirenConfig, apply_siren, init_siren
    from nmcfluid.scenes import get_scene
    sc = get_scene(scene_name)
    cfg = SirenConfig(sc.dim, sc.dim, num_hidden_layers=sc.num_hidden_layers,
                      hidden_features=sc.hidden_features)
    params = init_siren(jax.random.PRNGKey(1), cfg)
    x = jax.random.uniform(jax.random.PRNGKey(2), (64, sc.dim),
                           minval=-1.0, maxval=1.0)
    t = jax.random.normal(jax.random.PRNGKey(3), (64, sc.dim))
    p64 = [(np.asarray(W), np.asarray(b)) for W, b in params]
    u64, _ = chip_smoke._siren_f64(p64, np.asarray(x))
    assert chip_smoke._rel(apply_siren(params, cfg, x), u64) < 1e-5
    g = jax.grad(lambda p: jnp.mean(jnp.sum(
        (apply_siren(p, cfg, x) - t) ** 2, -1)))(params)
    g64 = chip_smoke._siren_grad_f64(p64, np.asarray(x), np.asarray(t))
    for (gw, gb), (rw, rb) in zip(g, g64):
        assert chip_smoke._rel(gw, rw) < 1e-5
        assert chip_smoke._rel(gb, rb) < 1e-5
