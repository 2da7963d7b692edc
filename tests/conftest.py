"""Test environment: force CPU with 8 virtual devices for sharding tests.

Must run before the first ``import jax`` anywhere in the test process.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# XLA:CPU's LLVM passes recurse deeply on large fused scan bodies; with the
# default 8 MiB main-thread stack a long pytest process can SIGSEGV inside
# backend_compile_and_load (observed round 4 compiling simulate_fleet after
# ~40 min of suite — the same compile passes in a fresh process).  The main
# thread's stack grows up to RLIMIT_STACK on Linux, so raising the soft
# limit at runtime gives the compiler headroom.
import resource

_soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
if _soft != resource.RLIM_INFINITY:
    _want = _hard if _hard != resource.RLIM_INFINITY else 512 * 1024 * 1024
    resource.setrlimit(resource.RLIMIT_STACK, (_want, _hard))

import jax

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release compiled executables after each test module.

    XLA:CPU keeps every JIT'd program loaded for the life of the process;
    after ~120 tests the accumulated code volume deterministically
    SIGSEGVs a later compile inside backend_compile_and_load (observed
    round 4: the same simulate_fleet compile crashes at the same point in
    full-suite order and passes in any shorter order or fresh process).
    Dropping the caches between modules bounds the live-code volume; the
    per-module recompiles cost far less than the suite they protect."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def sim_track():
    """The Sim_Track scenario fully built (map + path + speed profile)."""
    from multi_purpose_mpc_tpu.config import sim_track_preset
    from multi_purpose_mpc_tpu.utils.maps import add_obstacles_host, load_grid_map
    from multi_purpose_mpc_tpu.ops.path import build_reference_path

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    map_cfg, path_cfg, model_cfg, mpc_cfg, speed_cfg, obstacles = sim_track_preset(
        asset_dir=os.path.join(repo, "assets", "maps"))
    grid = load_grid_map(map_cfg)
    path = build_reference_path(grid, path_cfg)
    if obstacles:
        grid = add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution, obstacles)
    return dict(grid=grid, path=path, map_cfg=map_cfg, path_cfg=path_cfg,
                model_cfg=model_cfg, mpc_cfg=mpc_cfg, speed_cfg=speed_cfg,
                obstacles=obstacles)
