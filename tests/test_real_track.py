"""Real_Track scenario (reference: simulation.py:58-88): non-circular path on
the real 867x767 map, plus manual boundary rasterization
(reference_path.py:687-723)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

pytestmark = pytest.mark.slow

from multi_purpose_mpc_tpu.config import SimConfig, real_track_preset
from multi_purpose_mpc_tpu.ops.grid import add_boundary
from multi_purpose_mpc_tpu.ops.path import build_reference_path
from multi_purpose_mpc_tpu.ops.speed_profile import compute_speed_profile
from multi_purpose_mpc_tpu.simulation import simulate_closed_loop
from multi_purpose_mpc_tpu.utils.maps import load_grid_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def real_track():
    map_cfg, path_cfg, model_cfg, mpc_cfg, speed_cfg, _ = real_track_preset(
        asset_dir=os.path.join(REPO, "assets", "maps"))
    grid = load_grid_map(map_cfg)
    path = build_reference_path(grid, path_cfg)
    path = compute_speed_profile(path, speed_cfg)
    return dict(grid=grid, path=path, model_cfg=model_cfg, mpc_cfg=mpc_cfg)


def test_real_track_geometry(real_track):
    grid = real_track["grid"]
    path = real_track["path"]
    assert grid.occ.shape == (767, 867)
    assert not path.circular
    assert path.n_wp > 100
    assert float(path.length) > 30.0
    # non-circular: horizon gather clamps at the end instead of wrapping
    assert (np.asarray(path.ub) >= 0).all() and (np.asarray(path.lb) <= 0).all()


def test_real_track_full_traversal(real_track):
    """Drive the WHOLE Real_Track to completion — the reference's second
    scenario runs until ``car.s >= reference_path.length``
    (simulation.py:58-88, 134).  A non-circular end-of-path (clamped horizon
    gathers + done masks, ops/path.py) is exactly the seam only a full
    traversal exercises.  Measured: ~1,230 active steps, accept rate 1.0,
    |e_y| < 0.6 m inside the 1.5 m corridor."""
    path = real_track["path"]
    res = simulate_closed_loop(real_track["grid"], path,
                               real_track["mpc_cfg"], real_track["model_cfg"],
                               SimConfig(max_steps=1400))
    final = res.final_state
    assert bool(final.done), f"traversal incomplete: s={float(final.s):.2f}"
    assert not bool(final.failed)
    assert float(final.s) >= float(path.length)

    act = np.asarray(res.log.active)
    assert 900 < act.sum() < 1400, act.sum()
    # every active control accepted (no replay needed on the obstacle-free
    # real map) and the car stays well inside the corridor
    assert np.asarray(res.log.ok)[act].mean() > 0.99
    e_y = np.asarray(res.log.e_y)[act]
    assert np.abs(e_y).max() < float(np.asarray(path.ub).max()) + 0.05
    # after completion the lane freezes (done-mask semantics vs the
    # reference's exit(1), reference_path.py:366-369)
    assert (np.asarray(res.log.v)[~act] == 0.0).all()


def test_boundary_rasterization_world_coords(real_track):
    """add_boundary blocks the drivable area along world-space segments
    (reference: map.py:139-155, used by the Real_Track demo)."""
    grid = real_track["grid"]
    g2 = add_boundary(grid, [(-0.02, -2.72)], [(1.5, 1.0)], n_samples=512)
    assert float(g2.occ.sum()) < float(grid.occ.sum())


def test_real_track_lidar_fleet_smoke(real_track):
    """The dynamic-corridor machinery (scanline tables, cells scan, dense
    write-back) on the SECOND scenario: bigger 867x767 map, coarser 0.06
    m/px resolution, non-circular path."""
    from multi_purpose_mpc_tpu.config import LidarConfig
    from multi_purpose_mpc_tpu.ops.grid import make_grid_map
    from multi_purpose_mpc_tpu.ops.lidar import occupied_cell_table
    from multi_purpose_mpc_tpu.simulation import init_fleet, simulate_lidar_fleet

    grid = real_track["grid"]
    path = real_track["path"]
    known0 = make_grid_map(np.ones_like(np.asarray(grid.occ)),
                           (float(grid.origin[0]), float(grid.origin[1])),
                           float(grid.resolution))
    # coarse map: validate_for_grid passes easily at these settings
    lidar = LidarConfig(FoV=360, range=5.0, resolution=6, n_ray_samples=128)
    lidar.validate_for_grid(float(grid.resolution))
    fleet0 = init_fleet(path, real_track["mpc_cfg"].N, batch=2,
                        wp_id0=jnp.asarray([0, 60], jnp.int32))
    # exercise the gather-free scan and matmul write-back backends
    res, occ = simulate_lidar_fleet(
        grid, known0, path, real_track["mpc_cfg"], real_track["model_cfg"],
        SimConfig(max_steps=10, static_grid=False), lidar, fleet0,
        scan_backend="cells", writeback_backend="dense")
    ds = np.asarray(res.final_state.s) - np.asarray(fleet0.s)
    assert (ds > 0.3).all(), ds
    assert not np.asarray(res.final_state.failed).any()
    # scans populated both per-lane maps
    n0 = float((np.asarray(known0.occ) - np.asarray(occ[0])).sum())
    n1 = float((np.asarray(known0.occ) - np.asarray(occ[1])).sum())
    assert n0 > 50 and n1 > 50, (n0, n1)
