"""LiDAR-in-the-loop mapping fleet (BASELINE.json config 4 at batch scale).

A fleet of cars starts on the Sim_Track with an OPTIMISTIC map (all free);
each lane scans the true world every control step, writes the hits into its
own working map (or one shared, cooperatively-built map with
``--shared``), and the MPC corridor is extracted from that evolving map —
the reference's out-of-repo ROS mapping pipeline (README.md:76) as one
jitted program.

Usage:
    python examples/lidar_mapping_fleet.py [--batch 64] [--steps 120]
                                           [--shared] [--out /tmp/map.png]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax.numpy as jnp

from multi_purpose_mpc_tpu.config import (LidarConfig, SimConfig,
                                          sim_track_preset)
from multi_purpose_mpc_tpu.ops.grid import make_grid_map
from multi_purpose_mpc_tpu.ops.path import build_reference_path
from multi_purpose_mpc_tpu.ops.speed_profile import compute_speed_profile
from multi_purpose_mpc_tpu.simulation import init_fleet, simulate_lidar_fleet
from multi_purpose_mpc_tpu.utils.compile_cache import enable_compile_cache
from multi_purpose_mpc_tpu.utils.maps import add_obstacles_host, load_grid_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--shared", action="store_true",
                    help="one cooperatively-built map instead of per-lane")
    ap.add_argument("--scan-backend", default="auto",
                    choices=["auto", "march", "cells"],
                    help="march = point-sampled ray march; cells = exact "
                         "corner-span dense sweep (gather-free)")
    ap.add_argument("--sharded", action="store_true",
                    help="shard lanes (and their maps) over all devices via "
                         "parallel.fleet.simulate_lidar_fleet_sharded; with "
                         "--shared the map is pooled across devices by "
                         "per-step pmax collectives")
    ap.add_argument(
        "--out",
        default=os.path.join(tempfile.gettempdir(), "lidar_fleet_map.png"))
    args = ap.parse_args()
    enable_compile_cache()

    map_cfg, path_cfg, model_cfg, mpc_cfg, speed_cfg, obstacles = (
        sim_track_preset(asset_dir=os.path.join(REPO, "assets", "maps")))
    true_grid = load_grid_map(map_cfg)
    path = build_reference_path(true_grid, path_cfg)
    true_grid = add_obstacles_host(true_grid, map_cfg.origin,
                                   map_cfg.resolution, obstacles)
    path = compute_speed_profile(path, speed_cfg)

    known0 = make_grid_map(np.ones_like(np.asarray(true_grid.occ)),
                           map_cfg.origin, map_cfg.resolution)
    lidar = LidarConfig(FoV=360, range=1.0, resolution=4, n_ray_samples=192)

    rng = np.random.default_rng(0)
    fleet0 = init_fleet(path, mpc_cfg.N, args.batch,
                        wp_id0=jnp.asarray(
                            rng.integers(0, path.n_wp, args.batch), jnp.int32))

    if args.sharded:
        from multi_purpose_mpc_tpu.parallel.fleet import (
            simulate_lidar_fleet_sharded)
        from multi_purpose_mpc_tpu.parallel.mesh import fleet_mesh

        res, occ = simulate_lidar_fleet_sharded(
            fleet_mesh(), true_grid, known0, path, mpc_cfg, model_cfg,
            SimConfig(max_steps=args.steps, static_grid=False), lidar,
            fleet0, shared_grid=args.shared, scan_backend=args.scan_backend)
    else:
        res, occ = simulate_lidar_fleet(
            true_grid, known0, path, mpc_cfg, model_cfg,
            SimConfig(max_steps=args.steps, static_grid=False), lidar, fleet0,
            shared_grid=args.shared, scan_backend=args.scan_backend)

    act = np.asarray(res.log.active)
    print(f"batch {args.batch}, {args.steps} steps, "
          f"accept rate {np.asarray(res.log.ok)[act].mean():.3f}, "
          f"failed lanes {int(np.asarray(res.final_state.failed).sum())}")
    occ = np.asarray(occ if args.shared else occ[0])
    discovered = int((np.asarray(known0.occ) - occ).sum())
    print(f"{'shared' if args.shared else 'lane-0'} map: "
          f"{discovered} occupied cells discovered")

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(12, 6))
    for ax, (g, title) in zip(axes, [
            (np.asarray(true_grid.occ), "true world"),
            (occ, "discovered map" + (" (shared)" if args.shared else
                                      " (lane 0)"))]):
        ax.imshow(g, cmap="gray", origin="lower")
        ax.plot(*np.asarray(
            jnp.stack([(path.x - true_grid.origin[0]) / true_grid.resolution,
                       (path.y - true_grid.origin[1]) / true_grid.resolution])),
            lw=0.5, c="tab:blue")
        ax.set_title(title)
        ax.set_axis_off()
    fig.savefig(args.out, dpi=120, bbox_inches="tight")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
