"""Fleet-scale LiDAR backends: the "cells" scan (dense per-occupied-cell
sweep — the gather-free form of the reference's per-cell loop,
lidar_model.py:62-108) and the dense matmul write-back, against their
reference-semantics counterparts."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multi_purpose_mpc_tpu.config import LidarConfig
from multi_purpose_mpc_tpu.ops.lidar import (fleet_writeback,
                                             free_space_pixels,
                                             occupied_cell_table, scan,
                                             scan_fleet,
                                             update_grid_from_scan)


@pytest.fixture(scope="module")
def poses(sim_track):
    """Random poses near the path, filtered to FREE sensor cells — the
    cells backend's exactness precondition (a sensor inside an obstacle is
    a crashed lane; see occupied_cell_table)."""
    from multi_purpose_mpc_tpu.ops.grid import lookup_world

    path = sim_track["path"]
    grid = sim_track["grid"]
    B = 12
    rng = np.random.default_rng(3)
    xs, ys, ps = [], [], []
    while len(xs) < B:
        i = int(rng.integers(0, path.n_wp))
        x = float(np.asarray(path.x)[i] + rng.normal(0, 0.02))
        y = float(np.asarray(path.y)[i] + rng.normal(0, 0.02))
        if float(lookup_world(grid, x, y)) > 0.5:  # free cell
            xs.append(x)
            ys.append(y)
            ps.append(float(rng.uniform(-np.pi, np.pi)))
    return (jnp.asarray(xs, jnp.float32), jnp.asarray(ys, jnp.float32),
            jnp.asarray(ps, jnp.float32))


@pytest.fixture(scope="module")
def lidar():
    return LidarConfig(FoV=360, range=1.0, resolution=4, n_ray_samples=256)


def test_scan_fleet_march_equals_vmapped_scan(sim_track, poses, lidar):
    grid = sim_track["grid"]
    x, y, psi = poses
    a = scan_fleet(grid, x, y, psi, lidar, backend="march")
    b = jax.vmap(lambda u, v, w: scan(grid, u, v, w, lidar))(x, y, psi)
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))


def test_scan_fleet_cells_matches_conservative(sim_track, poses, lidar):
    """The cells backend implements the same ray-square-intersection
    reduction as scan(conservative=True) (== the reference's corner-span
    update, lidar_model.py:75-108).  Eager-mode agreement is exact; under
    jit, fused-rounding can flip corner-GRAZING cells (perp == support
    boundary), shifting a few beams by exactly one cell."""
    grid = sim_track["grid"]
    lidar.validate_for_grid(float(grid.resolution))  # conservative is exact
    x, y, psi = poses
    cells = occupied_cell_table(grid.occ)
    a = jax.jit(lambda u, v, w: scan_fleet(grid, u, v, w, lidar, cells=cells,
                                           backend="cells"))(x, y, psi)
    b = jax.jit(lambda u, v, w: jax.vmap(
        lambda p, q, r: scan(grid, p, q, r, lidar, conservative=True)
    )(u, v, w))(x, y, psi)
    np.testing.assert_array_equal(np.asarray(a.hit), np.asarray(b.hit))
    ra, rb = np.asarray(a.ranges), np.asarray(b.ranges)
    res = float(grid.resolution)
    assert np.abs(ra - rb).max() <= res + 1e-6  # grazing ties: one cell max
    frac_exact = float((np.abs(ra - rb) <= 1e-6).mean())
    assert frac_exact > 0.95, frac_exact


def test_scan_fleet_pruned_table_matches_global(sim_track, lidar):
    """The per-waypoint pruned candidate table (waypoint_cell_table) is pure
    geometry: for poses within the slack radius of their waypoint, the
    pruned sweep returns BITWISE the full-table sweep."""
    from multi_purpose_mpc_tpu.ops.grid import lookup_world
    from multi_purpose_mpc_tpu.ops.lidar import (waypoint_cell_table,
                                                 waypoint_slack)

    path = sim_track["path"]
    grid = sim_track["grid"]
    cells = occupied_cell_table(grid.occ)
    slack = waypoint_slack(path)
    wpc = waypoint_cell_table(cells, grid, path, lidar.range + slack)
    assert wpc.shape[0] == path.n_wp and wpc.shape[2] == 2
    assert wpc.shape[1] < cells.shape[0]  # it actually prunes

    rng = np.random.default_rng(9)
    xs, ys, ps, wid = [], [], [], []
    while len(xs) < 10:
        i = int(rng.integers(0, path.n_wp))
        x = float(np.asarray(path.x)[i] + rng.normal(0, 0.03))
        y = float(np.asarray(path.y)[i] + rng.normal(0, 0.03))
        if float(lookup_world(grid, x, y)) > 0.5:
            xs.append(x)
            ys.append(y)
            ps.append(float(rng.uniform(-np.pi, np.pi)))
            wid.append(i)
    x, y, psi = (jnp.asarray(v, jnp.float32) for v in (xs, ys, ps))
    wp_id = jnp.asarray(wid, jnp.int32)

    full = scan_fleet(grid, x, y, psi, lidar, cells=cells, backend="cells")
    pruned = scan_fleet(grid, x, y, psi, lidar, cells=wpc, backend="cells",
                        wp_id=wp_id)
    for fa, fb in zip(full, pruned):
        np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))


def test_fleet_writeback_dense_equals_scatter(sim_track, poses, lidar):
    grid = sim_track["grid"]
    x, y, psi = poses
    B = x.shape[0]
    scans = scan_fleet(grid, x, y, psi, lidar, backend="march")
    occ_b = jnp.broadcast_to(grid.occ, (B,) + grid.occ.shape)
    for cf in (False, True):
        dense = fleet_writeback(grid, occ_b, x, y, psi, scans, lidar,
                                clear_free=cf, shared=False)
        scat = jax.vmap(
            lambda oo, a, b, c, s: update_grid_from_scan(
                grid.replace(occ=oo), a, b, c, s, lidar, clear_free=cf).occ,
            in_axes=(0, 0, 0, 0, 0))(occ_b, x, y, psi, scans)
        np.testing.assert_array_equal(np.asarray(dense), np.asarray(scat))


def test_fleet_writeback_shared_pooled(sim_track, poses, lidar):
    """shared=True: clears pooled over all lanes first, hits after (an
    observed obstacle always wins), matching the documented semantics."""
    from multi_purpose_mpc_tpu.ops.grid import w2m

    grid = sim_track["grid"]
    x, y, psi = poses
    scans = scan_fleet(grid, x, y, psi, lidar, backend="march")
    dense = fleet_writeback(grid, grid.occ, x, y, psi, scans, lidar,
                            clear_free=True, shared=True)
    o = np.asarray(grid.occ).copy()
    fpx, fpy = jax.vmap(lambda a, b, c, s: free_space_pixels(grid, a, b, c, s)
                        )(x, y, psi, scans)
    o[np.asarray(fpy).reshape(-1), np.asarray(fpx).reshape(-1)] = 1.0
    hpx, hpy = w2m(grid, scans.hit_xy[..., 0], scans.hit_xy[..., 1])
    hpx = np.clip(np.asarray(hpx), 0, o.shape[1] - 1)
    hpy = np.clip(np.asarray(hpy), 0, o.shape[0] - 1)
    hm = np.asarray(scans.hit)
    o[hpy[hm], hpx[hm]] = 0.0
    np.testing.assert_array_equal(np.asarray(dense), o)
