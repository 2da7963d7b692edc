"""LiDAR-in-the-loop closed loop: the controller drives on a map built
online from scans of the true world (BASELINE.json config 4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multi_purpose_mpc_tpu.config import LidarConfig, SimConfig
from multi_purpose_mpc_tpu.ops.grid import make_grid_map
from multi_purpose_mpc_tpu.ops.speed_profile import compute_speed_profile
from multi_purpose_mpc_tpu.simulation import simulate_lidar_loop
from multi_purpose_mpc_tpu.utils.maps import add_obstacles_host


@pytest.fixture(scope="module")
def scenario(sim_track):
    path = compute_speed_profile(sim_track["path"], sim_track["speed_cfg"])
    return dict(sim_track, path=path)


def test_lidar_loop_discovers_map_and_drives(scenario):
    """Start from an optimistic all-free known map: scans must populate it
    and the car must still track the path."""
    true_grid = scenario["grid"]
    known0 = make_grid_map(np.ones_like(np.asarray(true_grid.occ)),
                           (float(true_grid.origin[0]), float(true_grid.origin[1])),
                           float(true_grid.resolution))
    lidar = LidarConfig(FoV=360, range=1.0, resolution=4, n_ray_samples=192)

    T = 40
    res, known = simulate_lidar_loop(true_grid, known0, scenario["path"],
                                     scenario["mpc_cfg"], scenario["model_cfg"],
                                     SimConfig(max_steps=T), lidar)
    occ0 = np.asarray(known0.occ)
    occT = np.asarray(known.occ)
    # scans discovered occupancy
    n_found = int((occ0 - occT).sum())
    assert n_found > 200, f"only {n_found} cells discovered"
    # the car made progress and stayed controlled
    assert float(res.final_state.s) > 1.0
    assert not bool(res.final_state.failed)
    assert np.abs(np.asarray(res.log.e_y)).max() < 0.25


def test_lidar_fleet_per_lane_matches_single(scenario):
    """Fleet LiDAR loop with per-lane grids: lane 0 (same start, same map)
    must reproduce the single-lane lidar loop; other lanes evolve their own
    maps independently."""
    from multi_purpose_mpc_tpu.simulation import init_fleet, simulate_lidar_fleet

    true_grid = scenario["grid"]
    known0 = make_grid_map(np.ones_like(np.asarray(true_grid.occ)),
                           (float(true_grid.origin[0]),
                            float(true_grid.origin[1])),
                           float(true_grid.resolution))
    lidar = LidarConfig(FoV=360, range=1.0, resolution=6, n_ray_samples=160)
    T = 15

    single, known_s = simulate_lidar_loop(
        true_grid, known0, scenario["path"], scenario["mpc_cfg"],
        scenario["model_cfg"], SimConfig(max_steps=T), lidar)

    fleet0 = init_fleet(scenario["path"], scenario["mpc_cfg"].N, batch=3,
                        wp_id0=jnp.asarray([0, 60, 120], jnp.int32))
    res, occs = simulate_lidar_fleet(true_grid, known0, scenario["path"],
                                     scenario["mpc_cfg"],
                                     scenario["model_cfg"],
                                     SimConfig(max_steps=T), lidar, fleet0)
    assert occs.shape == (3,) + np.asarray(true_grid.occ).shape
    # lane 0 vs single lane: the fleet path vectorizes gathers/reductions at
    # batch 3 (different float reduction order than batch 1), so commands
    # agree to the same ~5e-3 band as test_fleet_matches_single
    np.testing.assert_allclose(np.asarray(res.log.v)[:, 0],
                               np.asarray(single.log.v), atol=5e-3)
    # lane 0 discovers (essentially) the same map.  The commands agree to
    # 5e-3 (above), but batch-width-dependent XLA vectorization rounds
    # per-lane floats differently at B=3 vs B=1; over 15 closed-loop steps
    # the sub-mm pose drift flips which boundary cells each scan marks, so
    # the cell-diff count is a chaotic metric — bound it loosely.
    d0 = np.asarray(known0.occ) - np.asarray(occs[0])
    ds_ = np.asarray(known0.occ) - np.asarray(known_s.occ)
    n_diff = int((np.asarray(occs[0]) != np.asarray(known_s.occ)).sum())
    assert n_diff < 0.2 * max(ds_.sum(), 1), n_diff
    assert abs(d0.sum() - ds_.sum()) < 0.1 * max(ds_.sum(), 1)
    # every lane made progress on its own discovered map
    ds = np.asarray(res.final_state.s) - np.asarray(fleet0.s)
    assert (ds > 0.3).all(), ds
    assert not np.asarray(res.final_state.failed).any()
    # lanes discovered different parts of the world
    assert not np.array_equal(np.asarray(occs[0]), np.asarray(occs[1]))


def test_lidar_fleet_shared_grid_pools_observations(scenario):
    """shared_grid=True: one cooperatively-built map — the union of all
    lanes' discoveries, deterministic (hit writes commute)."""
    from multi_purpose_mpc_tpu.simulation import init_fleet, simulate_lidar_fleet

    true_grid = scenario["grid"]
    known0 = make_grid_map(np.ones_like(np.asarray(true_grid.occ)),
                           (float(true_grid.origin[0]),
                            float(true_grid.origin[1])),
                           float(true_grid.resolution))
    lidar = LidarConfig(FoV=360, range=1.0, resolution=6, n_ray_samples=160)
    T = 10
    starts = jnp.asarray([0, 50, 100, 150], jnp.int32)
    fleet0 = init_fleet(scenario["path"], scenario["mpc_cfg"].N, batch=4,
                        wp_id0=starts)

    res, occ = simulate_lidar_fleet(true_grid, known0, scenario["path"],
                                    scenario["mpc_cfg"], scenario["model_cfg"],
                                    SimConfig(max_steps=T), lidar, fleet0,
                                    shared_grid=True)
    assert occ.shape == np.asarray(true_grid.occ).shape
    # pooled map discovered more than any single lane would alone
    n_shared = int((np.asarray(known0.occ) - np.asarray(occ)).sum())
    res1, occ1 = simulate_lidar_fleet(true_grid, known0, scenario["path"],
                                      scenario["mpc_cfg"],
                                      scenario["model_cfg"],
                                      SimConfig(max_steps=T), lidar,
                                      jax.tree.map(lambda a: a[:1], fleet0))
    n_single = int((np.asarray(known0.occ) - np.asarray(occ1[0])).sum())
    assert n_shared > n_single > 0
    # determinism: same fleet, same pooled map
    res2, occ2 = simulate_lidar_fleet(true_grid, known0, scenario["path"],
                                      scenario["mpc_cfg"],
                                      scenario["model_cfg"],
                                      SimConfig(max_steps=T), lidar, fleet0,
                                      shared_grid=True)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(occ2))
    assert not np.asarray(res.final_state.failed).any()


def test_lidar_fleet_shared_grid_clear_free(scenario):
    """shared_grid=True + clear_free=True: pooled free-space clearing — a
    stale occupied cell that every scan now sees as free must be cleared in
    the shared map (ADVICE r2: clear_free used to be silently ignored)."""
    from multi_purpose_mpc_tpu.simulation import init_fleet, simulate_lidar_fleet

    true_grid = scenario["grid"]
    # known map starts as the true map PLUS a phantom obstacle on the path
    # near lane 0's start — the true world has no obstacle there
    occ0 = np.asarray(true_grid.occ).copy()
    p = scenario["path"]
    px0 = int((float(p.x[5]) - float(true_grid.origin[0]))
              / float(true_grid.resolution))
    py0 = int((float(p.y[5]) - float(true_grid.origin[1]))
              / float(true_grid.resolution))
    occ0[py0 - 2:py0 + 3, px0 - 2:px0 + 3] = 0.0
    known0 = make_grid_map(occ0,
                           (float(true_grid.origin[0]),
                            float(true_grid.origin[1])),
                           float(true_grid.resolution))
    lidar = LidarConfig(FoV=360, range=1.0, resolution=6, n_ray_samples=224)
    fleet0 = init_fleet(scenario["path"], scenario["mpc_cfg"].N, batch=2,
                        wp_id0=jnp.asarray([0, 80], jnp.int32))
    _, occ = simulate_lidar_fleet(true_grid, known0, scenario["path"],
                                  scenario["mpc_cfg"], scenario["model_cfg"],
                                  SimConfig(max_steps=8), lidar, fleet0,
                                  clear_free=True, shared_grid=True)
    phantom_left = float((1.0 - np.asarray(occ)[py0 - 2:py0 + 3,
                                                px0 - 2:px0 + 3]).sum())
    phantom_before = float((1.0 - occ0[py0 - 2:py0 + 3, px0 - 2:px0 + 3]).sum())
    assert phantom_left < phantom_before, (phantom_left, phantom_before)
    # without clear_free the phantom stays
    _, occ_keep = simulate_lidar_fleet(true_grid, known0, scenario["path"],
                                       scenario["mpc_cfg"],
                                       scenario["model_cfg"],
                                       SimConfig(max_steps=8), lidar, fleet0,
                                       clear_free=False, shared_grid=True)
    kept = float((1.0 - np.asarray(occ_keep)[py0 - 2:py0 + 3,
                                             px0 - 2:px0 + 3]).sum())
    assert kept == phantom_before


def test_resolve_lidar_backends_policy():
    """One policy for both entry points (review finding: the duplicated
    resolution had already drifted), the same on CPU and GPU platforms."""
    from multi_purpose_mpc_tpu.simulation import resolve_lidar_backends

    for platform in ("cpu", "gpu"):
        assert resolve_lidar_backends(False, "auto", "auto",
                                      platform=platform) == \
            ("march", "scatter")
        assert resolve_lidar_backends(True, "auto", "auto",
                                      platform=platform) == \
            ("march", "scatter")
        # sharded shared grid must pool masks -> dense
        assert resolve_lidar_backends(True, "auto", "auto",
                                      multi_device=True,
                                      platform=platform) == ("march", "dense")
    # explicit choices pass through; removed or unknown ones raise
    assert resolve_lidar_backends(False, "cells", "dense") == \
        ("cells", "dense")
    with pytest.raises(ValueError, match="writeback"):
        resolve_lidar_backends(False, "auto", "fused")
    with pytest.raises(ValueError, match="writeback"):
        resolve_lidar_backends(True, "auto", "packed")
    with pytest.raises(ValueError, match="dense"):
        resolve_lidar_backends(True, "auto", "scatter",
                               multi_device=True)


def test_pair_mask_pooled_chunking():
    """The chunked pooled-mask path (big fleets) == the single-call path."""
    from multi_purpose_mpc_tpu.ops.lidar import _pair_mask_pooled

    rng = np.random.default_rng(3)
    S, h, w = 1000, 40, 56
    py = jnp.asarray(rng.integers(0, h, S), jnp.int32)
    px = jnp.asarray(rng.integers(0, w, S), jnp.int32)
    valid = jnp.asarray(rng.random(S) < 0.7)
    one = _pair_mask_pooled(py, px, valid, h, w)  # S < default chunk
    for chunk in (128, 250, 999, 1000):  # pad path, exact-fit path
        m = _pair_mask_pooled(py, px, valid, h, w, chunk_elems=chunk)
        np.testing.assert_array_equal(np.asarray(m), np.asarray(one))
    # reference: dense scatter
    ref = np.zeros((h, w), bool)
    ref[np.asarray(py)[np.asarray(valid)], np.asarray(px)[np.asarray(valid)]] = True
    np.testing.assert_array_equal(np.asarray(one), ref)


def test_lidar_config_validate_for_grid():
    """Conservative-mode exactness check (ADVICE r2): sample spacing must
    beat the grid resolution."""
    ok = LidarConfig(FoV=360, range=1.0, resolution=4, n_ray_samples=256)
    ok.validate_for_grid(0.005)  # spacing ~0.0039 < 0.005: fine
    import pytest as _pytest
    coarse = LidarConfig(FoV=360, range=5.0, resolution=4, n_ray_samples=64)
    with _pytest.raises(ValueError, match="n_ray_samples"):
        coarse.validate_for_grid(0.005)


def test_lidar_loop_true_map_equivalence(scenario):
    """With the known map == the true map, the lidar loop must behave like
    the plain closed loop (scans discover nothing new)."""
    from multi_purpose_mpc_tpu.simulation import simulate_closed_loop

    true_grid = scenario["grid"]
    lidar = LidarConfig(FoV=180, range=0.5, resolution=10, n_ray_samples=96)
    T = 12
    # plain loop ALSO with in-loop extraction (static_grid=False) so the
    # corridor computation matches exactly
    plain = simulate_closed_loop(true_grid, scenario["path"],
                                 scenario["mpc_cfg"], scenario["model_cfg"],
                                 SimConfig(max_steps=T, static_grid=False))
    loop, known = simulate_lidar_loop(true_grid, true_grid, scenario["path"],
                                      scenario["mpc_cfg"], scenario["model_cfg"],
                                      SimConfig(max_steps=T), lidar)
    # scan hits only re-mark already-occupied cells
    np.testing.assert_array_equal(np.asarray(known.occ),
                                  np.asarray(true_grid.occ))
    # the two rollouts are different compiled programs (per-lane vs shared
    # occ layout); fusion-dependent rounding through the eps=1e-3 QP solver
    # bounds agreement at ~1e-4, not float-eps
    np.testing.assert_allclose(np.asarray(loop.log.v), np.asarray(plain.log.v),
                               atol=2e-4)
