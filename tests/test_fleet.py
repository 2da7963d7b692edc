"""Fleet sharding tests on the 8-virtual-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multi_purpose_mpc_tpu.config import SimConfig
from multi_purpose_mpc_tpu.ops.speed_profile import compute_speed_profile
from multi_purpose_mpc_tpu.parallel.fleet import simulate_fleet_sharded
from multi_purpose_mpc_tpu.parallel.mesh import (
    fleet_mesh,
    fleet_metrics,
    fleet_sharding,
    round_up_batch,
    shard_fleet_state,
)
from multi_purpose_mpc_tpu.simulation import init_fleet, simulate_fleet


@pytest.fixture(scope="module")
def scenario(sim_track):
    path = compute_speed_profile(sim_track["path"], sim_track["speed_cfg"])
    return dict(sim_track, path=path)


def test_eight_virtual_devices_available():
    assert len(jax.devices()) == 8, (
        "sharding tests need xla_force_host_platform_device_count=8")


def test_mesh_and_sharding_placement(scenario):
    mesh = fleet_mesh()
    assert mesh.devices.size == 8
    batch = round_up_batch(10, mesh)
    assert batch == 16
    fleet0 = init_fleet(scenario["path"], scenario["mpc_cfg"].N, batch)
    sharded = shard_fleet_state(fleet0, mesh)
    # leading axis split across all 8 devices
    assert len(sharded.x.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(sharded.x), np.asarray(fleet0.x))


def test_sharded_rollout_matches_single_device(scenario):
    T = 8
    mesh = fleet_mesh()
    batch = 8
    e_y0 = jnp.linspace(-0.03, 0.03, batch)
    fleet0 = init_fleet(scenario["path"], scenario["mpc_cfg"].N, batch, e_y0=e_y0)

    plain = simulate_fleet(scenario["grid"], scenario["path"],
                           scenario["mpc_cfg"], scenario["model_cfg"],
                           SimConfig(max_steps=T), fleet0)
    sharded = simulate_fleet_sharded(mesh, scenario["grid"], scenario["path"],
                                     scenario["mpc_cfg"], scenario["model_cfg"],
                                     SimConfig(max_steps=T), fleet0)
    # GSPMD partitioning reassociates float reductions (rho adaptation,
    # polish selection), and the cost-flat curvature direction amplifies the
    # diffs chaotically — compare behaviorally: early prefix elementwise,
    # then progress/tracking envelopes.
    np.testing.assert_allclose(np.asarray(sharded.log.v)[:3],
                               np.asarray(plain.log.v)[:3], atol=5e-3)
    np.testing.assert_allclose(np.asarray(sharded.log.s)[-1],
                               np.asarray(plain.log.s)[-1], atol=0.02)
    assert np.abs(np.asarray(sharded.log.e_y)).max() < \
        np.abs(np.asarray(plain.log.e_y)).max() + 0.02
    assert np.asarray(sharded.log.ok).mean() > 0.9
    # same sharded program twice is bitwise deterministic, and the second
    # call reuses the compiled program
    from multi_purpose_mpc_tpu.parallel.fleet import _fleet_rollout

    n_compiled = _fleet_rollout._cache_size()
    sharded2 = simulate_fleet_sharded(mesh, scenario["grid"], scenario["path"],
                                      scenario["mpc_cfg"], scenario["model_cfg"],
                                      SimConfig(max_steps=T), fleet0)
    np.testing.assert_array_equal(np.asarray(sharded.log.x),
                                  np.asarray(sharded2.log.x))
    assert _fleet_rollout._cache_size() == n_compiled


def test_fleet_metrics_aggregate(scenario):
    T = 8
    fleet0 = init_fleet(scenario["path"], scenario["mpc_cfg"].N, 8)
    res = simulate_fleet(scenario["grid"], scenario["path"],
                         scenario["mpc_cfg"], scenario["model_cfg"],
                         SimConfig(max_steps=T), fleet0)
    m = jax.jit(fleet_metrics)(res.log, scenario["path"].length)
    assert 0.0 < float(m["qp_solve_rate"]) <= 1.0
    assert float(m["mean_progress"]) > 0.0
    assert float(m["mean_speed"]) > 0.0
    assert np.isfinite(float(m["max_abs_e_y"]))


def test_sharded_dynamic_grid_fleet(scenario):
    """static_grid=False under sharding: per-step corridor re-extraction
    (scanline-table backends) runs inside the shard_map body; the table is
    built host-side outside the traced region."""
    T = 4
    mesh = fleet_mesh()
    e_y0 = jnp.linspace(-0.03, 0.03, 8)
    fleet0 = init_fleet(scenario["path"], scenario["mpc_cfg"].N, 8, e_y0=e_y0)
    sim = SimConfig(max_steps=T, static_grid=False)

    plain = simulate_fleet(scenario["grid"], scenario["path"],
                           scenario["mpc_cfg"], scenario["model_cfg"],
                           sim, fleet0)
    shd = simulate_fleet_sharded(mesh, scenario["grid"], scenario["path"],
                                 scenario["mpc_cfg"], scenario["model_cfg"],
                                 sim, fleet0)
    np.testing.assert_allclose(np.asarray(shd.log.v)[:2],
                               np.asarray(plain.log.v)[:2], atol=5e-3)
    assert np.asarray(shd.log.ok).mean() > 0.9


def _all_free_like(grid):
    from multi_purpose_mpc_tpu.ops.grid import make_grid_map

    return make_grid_map(np.ones_like(np.asarray(grid.occ)),
                         (float(grid.origin[0]), float(grid.origin[1])),
                         float(grid.resolution))


def test_sharded_lidar_fleet_per_lane(scenario):
    """LiDAR fleet with per-lane maps sharded over the 8-device mesh: lanes
    (and their map stack — the HBM-dominant state) split across devices,
    zero collectives; behavior matches the unsharded fleet."""
    from multi_purpose_mpc_tpu.config import LidarConfig
    from multi_purpose_mpc_tpu.parallel.fleet import simulate_lidar_fleet_sharded
    from multi_purpose_mpc_tpu.simulation import simulate_lidar_fleet

    mesh = fleet_mesh()
    true_grid = scenario["grid"]
    known0 = _all_free_like(true_grid)
    lidar = LidarConfig(FoV=360, range=1.0, resolution=6, n_ray_samples=160)
    T = 6
    fleet0 = init_fleet(scenario["path"], scenario["mpc_cfg"].N, 8,
                        wp_id0=jnp.arange(8, dtype=jnp.int32) * 25)

    plain, occ_p = simulate_lidar_fleet(true_grid, known0, scenario["path"],
                                        scenario["mpc_cfg"],
                                        scenario["model_cfg"],
                                        SimConfig(max_steps=T), lidar, fleet0)
    shd, occ_s = simulate_lidar_fleet_sharded(
        mesh, true_grid, known0, scenario["path"], scenario["mpc_cfg"],
        scenario["model_cfg"], SimConfig(max_steps=T), lidar, fleet0)

    assert occ_s.shape == occ_p.shape
    assert len(occ_s.sharding.device_set) == 8
    # behavioral bands (cf. test_sharded_rollout_matches_single_device),
    # but the scan->map->corridor loop amplifies per-device vectorization
    # drift faster than the static fleet: tight window is 2 steps, then
    # progress envelope only
    np.testing.assert_allclose(np.asarray(shd.log.v)[:2],
                               np.asarray(plain.log.v)[:2], atol=5e-3)
    np.testing.assert_allclose(np.asarray(shd.log.s)[-1],
                               np.asarray(plain.log.s)[-1], atol=0.05)
    # each lane's discovered map is (essentially) the unsharded lane's map;
    # sub-mm pose drift can flip individual boundary cells (see
    # test_lidar_fleet_per_lane_matches_single)
    n_disc = (np.asarray(known0.occ) - np.asarray(occ_p)).sum()
    n_diff = int((np.asarray(occ_s) != np.asarray(occ_p)).sum())
    assert n_diff < 0.2 * max(n_disc, 1), (n_diff, n_disc)
    assert not np.asarray(shd.final_state.failed).any()
    # bitwise-deterministic across runs, with no second compile
    from multi_purpose_mpc_tpu.parallel.fleet import _lidar_rollout

    n_compiled = _lidar_rollout._cache_size()
    shd2, occ_s2 = simulate_lidar_fleet_sharded(
        mesh, true_grid, known0, scenario["path"], scenario["mpc_cfg"],
        scenario["model_cfg"], SimConfig(max_steps=T), lidar, fleet0)
    np.testing.assert_array_equal(np.asarray(occ_s), np.asarray(occ_s2))
    np.testing.assert_array_equal(np.asarray(shd.log.x),
                                  np.asarray(shd2.log.x))
    assert _lidar_rollout._cache_size() == n_compiled


def test_sharded_lidar_fleet_shared_grid(scenario):
    """Cooperative mapping across devices: the shared map is pooled with one
    pmax per mask class each step — the framework's hot-loop collectives.
    Must match the unsharded shared-grid pool behaviorally, and the map
    carry must stay replicated-identical."""
    from multi_purpose_mpc_tpu.config import LidarConfig
    from multi_purpose_mpc_tpu.parallel.fleet import simulate_lidar_fleet_sharded
    from multi_purpose_mpc_tpu.simulation import simulate_lidar_fleet

    mesh = fleet_mesh()
    true_grid = scenario["grid"]
    known0 = _all_free_like(true_grid)
    lidar = LidarConfig(FoV=360, range=1.0, resolution=6, n_ray_samples=160)
    T = 5
    fleet0 = init_fleet(scenario["path"], scenario["mpc_cfg"].N, 8,
                        wp_id0=jnp.arange(8, dtype=jnp.int32) * 20)

    plain, occ_p = simulate_lidar_fleet(
        true_grid, known0, scenario["path"], scenario["mpc_cfg"],
        scenario["model_cfg"], SimConfig(max_steps=T), lidar, fleet0,
        shared_grid=True, clear_free=True, writeback_backend="dense")
    shd, occ_s = simulate_lidar_fleet_sharded(
        mesh, true_grid, known0, scenario["path"], scenario["mpc_cfg"],
        scenario["model_cfg"], SimConfig(max_steps=T), lidar, fleet0,
        shared_grid=True, clear_free=True)

    assert occ_s.shape == np.asarray(true_grid.occ).shape
    np.testing.assert_allclose(np.asarray(shd.log.v)[:2],
                               np.asarray(plain.log.v)[:2], atol=5e-3)
    # pooled discovery counts agree closely (cell-level diffs only from
    # sub-mm pose drift between the two programs)
    n_p = (np.asarray(known0.occ) - np.asarray(occ_p)).sum()
    n_s = (np.asarray(known0.occ) - np.asarray(occ_s)).sum()
    assert abs(n_p - n_s) < 0.1 * max(n_p, 1), (n_p, n_s)
    assert not np.asarray(shd.final_state.failed).any()


def test_shared_mask_pooling_bitwise(scenario):
    """The cross-device mask pool (pmax = or) is EXACTLY the single-device
    all-lane pool — no solver in the loop, so this one is bitwise."""
    from multi_purpose_mpc_tpu.config import LidarConfig
    from multi_purpose_mpc_tpu.ops.lidar import (apply_observation_masks,
                                                 fleet_observation_masks,
                                                 scan_fleet)
    from multi_purpose_mpc_tpu.parallel.fleet import shard_map
    from jax.sharding import PartitionSpec as P

    mesh = fleet_mesh()
    true_grid = scenario["grid"]
    known0 = _all_free_like(true_grid)
    lidar = LidarConfig(FoV=360, range=1.0, resolution=6, n_ray_samples=160)
    h, w = np.asarray(known0.occ).shape
    fleet0 = init_fleet(scenario["path"], scenario["mpc_cfg"].N, 8,
                        wp_id0=jnp.arange(8, dtype=jnp.int32) * 25)
    x, y, psi = fleet0.x, fleet0.y, fleet0.psi

    def pooled(x_, y_, psi_):
        scans = scan_fleet(true_grid, x_, y_, psi_, lidar, backend="march")
        hm, fm = fleet_observation_masks(known0, h, w, x_, y_, psi_, scans,
                                         lidar, clear_free=True, shared=True)
        return apply_observation_masks(known0.occ, hm, fm)

    ref = jax.jit(pooled)(x, y, psi)

    def pooled_sharded(x_, y_, psi_):
        scans = scan_fleet(true_grid, x_, y_, psi_, lidar, backend="march")
        hm, fm = fleet_observation_masks(known0, h, w, x_, y_, psi_, scans,
                                         lidar, clear_free=True, shared=True)
        hm = jax.lax.pmax(hm.astype(jnp.float32), "fleet") > 0.5
        fm = jax.lax.pmax(fm.astype(jnp.float32), "fleet") > 0.5
        return apply_observation_masks(known0.occ, hm, fm)

    fn = shard_map(pooled_sharded, mesh=mesh,
                   in_specs=(P("fleet"), P("fleet"), P("fleet")),
                   out_specs=P(), check_vma=False)
    out = jax.jit(fn)(x, y, psi)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_per_lane_failure_isolation(scenario):
    """One lane marked failed must freeze without affecting the others —
    the fleet semantics replacing the reference's exit(1) (SURVEY.md §5)."""
    T = 6
    batch = 4
    fleet0 = init_fleet(scenario["path"], scenario["mpc_cfg"].N, batch)
    fleet0 = fleet0.replace(
        failed=jnp.asarray([False, True, False, False]))
    res = simulate_fleet(scenario["grid"], scenario["path"],
                         scenario["mpc_cfg"], scenario["model_cfg"],
                         SimConfig(max_steps=T), fleet0)
    v = np.asarray(res.log.v)
    assert (v[:, 1] == 0.0).all(), "failed lane must not move"
    assert (v[-1, [0, 2, 3]] > 0.0).all(), "healthy lanes must advance"
    s = np.asarray(res.log.s)
    assert (s[-1, [0, 2, 3]] > 0.0).all()
