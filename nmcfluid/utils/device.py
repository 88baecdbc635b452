"""The device a measurement ran on, as the benchmark and the smoke run
record it."""
import subprocess

import jax


def require_gpu():
    """Raise unless JAX's default backend is a GPU. A timing taken on any
    other backend is not a device measurement, so there is no fallback."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {backend!r}")


def device_info():
    """platform, device_kind and device count as JAX reports them."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_name_power():
    """The cards' `name, power.limit` lines from nvidia-smi, read by a
    child process that does not import JAX. A card below its maximum
    power limit runs slower under load, so every number is kept with
    this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
