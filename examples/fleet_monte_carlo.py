"""Fleet Monte-Carlo demo (BASELINE.json config 5): thousands of perturbed
cars on the obstructed track in one on-device rollout, with cross-fleet
metrics, checkpoint/resume, and a multi-lane render.

    python examples/fleet_monte_carlo.py --batch 1024 --steps 200
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from multi_purpose_mpc_tpu.config import SimConfig, sim_track_preset
from multi_purpose_mpc_tpu.ops.path import build_reference_path
from multi_purpose_mpc_tpu.ops.speed_profile import compute_speed_profile
from multi_purpose_mpc_tpu.parallel.mesh import fleet_mesh, fleet_metrics, round_up_batch
from multi_purpose_mpc_tpu.parallel.fleet import simulate_fleet_sharded
from multi_purpose_mpc_tpu.simulation import init_fleet
from multi_purpose_mpc_tpu.utils.checkpoint import load_fleet_state, save_fleet_state
from multi_purpose_mpc_tpu.utils.compile_cache import enable_compile_cache
from multi_purpose_mpc_tpu.utils.maps import add_obstacles_host, load_grid_map
from multi_purpose_mpc_tpu.utils.viz import render_trajectory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--checkpoint",
        default=os.path.join(tempfile.gettempdir(), "fleet_ckpt.npz"))
    p.add_argument("--resume", action="store_true")
    p.add_argument(
        "--out",
        default=os.path.join(tempfile.gettempdir(), "fleet_trajectories.png"))
    args = p.parse_args()
    enable_compile_cache()

    map_cfg, path_cfg, model_cfg, mpc_cfg, speed_cfg, obstacles = (
        sim_track_preset(asset_dir=os.path.join(REPO, "assets", "maps")))
    grid = load_grid_map(map_cfg)
    path = build_reference_path(grid, path_cfg)
    grid = add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution, obstacles)
    path = compute_speed_profile(path, speed_cfg)

    mesh = fleet_mesh()
    batch = round_up_batch(args.batch, mesh)
    rng = np.random.default_rng(args.seed)
    fleet = init_fleet(
        path, mpc_cfg.N, batch,
        e_y0=jnp.asarray(rng.uniform(-0.04, 0.04, batch), jnp.float32),
        e_psi0=jnp.asarray(rng.uniform(-0.2, 0.2, batch), jnp.float32),
        wp_id0=jnp.asarray(rng.integers(0, path.n_wp, batch), jnp.int32))
    start_step = 0
    if args.resume and os.path.exists(args.checkpoint):
        fleet, start_step = load_fleet_state(args.checkpoint, like=fleet)
        print(f"[resume] from step {start_step}")

    print(f"[setup] fleet {batch} lanes over mesh {mesh.devices.size} "
          f"device(s) ({jax.devices()[0].platform})")
    t0 = time.perf_counter()
    res = simulate_fleet_sharded(mesh, grid, path, mpc_cfg, model_cfg,
                                 SimConfig(max_steps=args.steps), fleet)
    jax.block_until_ready(res)
    dt = time.perf_counter() - t0
    print(f"[run] {args.steps} steps x {batch} lanes in {dt:.2f}s "
          f"= {batch * args.steps / dt:.0f} car-steps/s (incl. compile)")

    m = jax.jit(fleet_metrics)(res.log, path.length)
    for k, v in m.items():
        print(f"  {k}: {float(v):.4f}")
    n_failed = int(np.asarray(res.final_state.failed).sum())
    n_done = int(np.asarray(res.final_state.done).sum())
    print(f"  lanes done: {n_done}/{batch}, failed: {n_failed}")

    save_fleet_state(args.checkpoint, res.final_state,
                     step=start_step + args.steps)
    print(f"[ckpt] -> {args.checkpoint}")

    render_trajectory(grid, path, obstacles, res.log, model_cfg,
                      out_path=args.out, lanes=24)
    print(f"[viz] -> {args.out}")


if __name__ == "__main__":
    main()
