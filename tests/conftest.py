import os

# Tests run on the CPU, on a virtual 8-device mesh: sharding paths are
# exercised without accelerators, and results are deterministic across
# machines.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
# Hermetic suite: no persistent compile cache. XLA:CPU cache entries are
# host-specific AOT code (run.py:compile_cache_dir), and an e2e test
# calling run.main() must not turn the opt-in cache on for the process.
os.environ.pop("NMCFLUID_CPU_CACHE", None)
os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_executables_between_modules():
    """Free jitted executables after each test module.

    The full suite compiles thousands of XLA:CPU programs; keeping every
    executable alive for the whole run segfaults LLVM's JIT memory
    manager deterministically ~85% in (inside backend_compile_and_load,
    compiling a trivial slice op — tests/test_spectral.py passes in
    isolation and crashes only after the preceding modules' compilations
    accumulate). Dropping the caches per module keeps the live-code
    footprint bounded; cross-module recompiles are minor since modules
    rarely share jit signatures."""
    yield
    jax.clear_caches()
