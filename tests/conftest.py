"""Test harness config: force an 8-device virtual CPU platform.

Multi-chip sharding is validated without accelerator hardware by running
every test on `--xla_force_host_platform_device_count=8` CPU devices
(SURVEY.md §4: the reference has no test suite at all; this is the strategy
we build).
Must run before the first `import jax` anywhere in the test session.
"""

import os

# Unit tests always run on the virtual 8-device CPU platform, even on a
# machine with a GPU: the env var is set before JAX is imported and
# jax.config is updated as well, in case JAX was configured earlier.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# Keep compile times sane in CI.
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# NOTE: do NOT enable the persistent compilation cache here. A shared
# on-disk cache written by concurrent pytest processes produced corrupted
# entries whose READ aborts the whole process from C++
# (compilation_cache.get_executable_and_time -> Fatal Python error:
# Aborted) — measured reproducibly in round 4. In-process caching is
# enough for a single suite run.

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _bound_compiled_program_maps():
    """Keep the process under vm.max_map_count (default 65530).

    Every XLA-compiled executable holds JIT code pages as separate memory
    mappings; a full single-process suite run accumulates ~1.5k mappings
    per minute and SEGFAULTS inside an arbitrary late compile when the
    kernel map budget runs out (VERDICT r3 Weak-7 — measured: maps grow
    monotonically to the 65k limit at the observed ~35-40 min crash
    point). Dropping the jit caches between modules releases the
    executables and their mappings; shared programs recompile cheaply.
    """
    yield
    try:
        with open("/proc/self/maps") as f:
            n_maps = sum(1 for _ in f)
    except OSError:
        n_maps = 0
    if n_maps > 25000:
        jax.clear_caches()
