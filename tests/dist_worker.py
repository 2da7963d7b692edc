"""Worker process for the 2-process ``jax.distributed`` integration test.

Launched by ``tests/test_distributed.py`` (never collected by pytest): each
of the two OS processes brings up 4 virtual CPU devices, joins the
distributed runtime through ``init_distributed`` (the framework's multi-host
seam, parallel/mesh.py), builds the GLOBAL 8-device fleet mesh, runs
``simulate_fleet_sharded`` on the Sim_Track scenario, and dumps its local
lane block (assembled from addressable shards) for the parent to check
against a single-process run of the same sharded program.
"""

import os
import sys


def main() -> None:
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]
    out_path = sys.argv[4]

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)

    import jax

    import numpy as np

    from multi_purpose_mpc_tpu.parallel.mesh import (global_fleet_mesh,
                                                     init_distributed,
                                                     local_lane_slice)

    ok = init_distributed(coordinator_address=f"localhost:{port}",
                          num_processes=nproc, process_id=pid)
    assert ok, "init_distributed returned False with explicit coordinates"
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.local_devices()) == 4, jax.local_devices()
    assert len(jax.devices()) == 4 * nproc, jax.devices()

    import jax.numpy as jnp

    from multi_purpose_mpc_tpu.config import SimConfig, sim_track_preset
    from multi_purpose_mpc_tpu.ops.path import build_reference_path
    from multi_purpose_mpc_tpu.ops.speed_profile import compute_speed_profile
    from multi_purpose_mpc_tpu.parallel.fleet import simulate_fleet_sharded
    from multi_purpose_mpc_tpu.simulation import init_fleet
    from multi_purpose_mpc_tpu.utils.maps import (add_obstacles_host,
                                                  load_grid_map)

    map_cfg, path_cfg, model_cfg, mpc_cfg, speed_cfg, obstacles = (
        sim_track_preset(asset_dir=os.path.join(repo, "assets", "maps")))
    grid = load_grid_map(map_cfg)
    path = build_reference_path(grid, path_cfg)
    grid = add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution,
                              obstacles)
    path = compute_speed_profile(path, speed_cfg)

    B, T = 8, 4
    fleet = init_fleet(path, mpc_cfg.N, B,
                       e_y0=jnp.linspace(-0.03, 0.03, B))
    mesh = global_fleet_mesh()
    assert mesh.devices.size == 4 * nproc
    res = simulate_fleet_sharded(mesh, grid, path, mpc_cfg, model_cfg,
                                 SimConfig(max_steps=T), fleet)

    def local_block(arr, axis):
        """Assemble this process's contiguous lane block from its
        addressable shards of a global jax.Array."""
        shards = sorted(arr.addressable_shards,
                        key=lambda s: s.index[axis].start or 0)
        return np.concatenate([np.asarray(s.data) for s in shards],
                              axis=axis)

    sl = local_lane_slice(B, jax.process_index(), nproc)
    np.savez(out_path,
             lo=sl.start, hi=sl.stop,
             s=local_block(res.final_state.s, 0),
             x=local_block(res.log.x, 1),
             v=local_block(res.log.v, 1),
             ok=local_block(res.log.ok, 1))
    print(f"worker {pid}: OK, lanes [{sl.start}:{sl.stop}]")


if __name__ == "__main__":
    main()
