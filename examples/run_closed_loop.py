"""Closed-loop demo driver (the equivalent of reference simulation.py).

Runs one of the reference scenarios end to end on-device, then renders the
trajectory post-hoc (the reference redraws matplotlib inside the loop every
step — simulation.py:151-163 — which an on-device loop must not do).

    python examples/run_closed_loop.py --scenario sim_track --mode tracking
    python examples/run_closed_loop.py --mode time_optimal --gif out.gif
    python examples/run_closed_loop.py --batch 512        # fleet Monte-Carlo
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

from multi_purpose_mpc_tpu.config import (
    SimConfig,
    real_track_preset,
    sim_track_preset,
    time_optimal_config,
)
from multi_purpose_mpc_tpu.ops.path import build_reference_path
from multi_purpose_mpc_tpu.ops.speed_profile import compute_speed_profile
from multi_purpose_mpc_tpu.simulation import (
    init_fleet,
    simulate_closed_loop,
    simulate_fleet,
)
from multi_purpose_mpc_tpu.parallel.mesh import fleet_metrics
from multi_purpose_mpc_tpu.utils.compile_cache import enable_compile_cache
from multi_purpose_mpc_tpu.utils.maps import add_obstacles_host, load_grid_map
from multi_purpose_mpc_tpu.utils.viz import render_trajectory, save_animation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--scenario", choices=["sim_track", "real_track"],
                   default="sim_track")
    p.add_argument("--mode", choices=["tracking", "time_optimal"],
                   default="tracking")
    p.add_argument("--obstacles", action="store_true", default=True)
    p.add_argument("--no-obstacles", dest="obstacles", action="store_false")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument(
        "--out",
        default=os.path.join(tempfile.gettempdir(), "mpc_trajectory.png"))
    p.add_argument("--gif", default=None)
    args = p.parse_args()
    enable_compile_cache()

    preset = sim_track_preset if args.scenario == "sim_track" else real_track_preset
    map_cfg, path_cfg, model_cfg, mpc_cfg, speed_cfg, obstacles = preset(
        asset_dir=os.path.join(REPO, "assets", "maps"))
    if not args.obstacles:
        obstacles = ()
    if args.mode == "time_optimal":
        mpc_cfg = time_optimal_config(mpc_cfg)

    grid = load_grid_map(map_cfg)
    path = build_reference_path(grid, path_cfg)
    if obstacles:
        grid = add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution,
                                  obstacles)
    path = compute_speed_profile(path, speed_cfg)
    print(f"[setup] {args.scenario}: {path.n_wp} waypoints, "
          f"{float(path.length):.2f} m, device={jax.devices()[0]}")

    sim = SimConfig(max_steps=args.steps)
    t0 = time.perf_counter()
    if args.batch > 1:
        rng = np.random.default_rng(0)
        fleet0 = init_fleet(path, mpc_cfg.N, args.batch,
                            e_y0=jnp.asarray(rng.uniform(-0.02, 0.02, args.batch),
                                             jnp.float32))
        res = simulate_fleet(grid, path, mpc_cfg, model_cfg, sim, fleet0)
    else:
        res = simulate_closed_loop(grid, path, mpc_cfg, model_cfg, sim)
    jax.block_until_ready(res.log.x)
    dt = time.perf_counter() - t0

    log = res.log
    n_active = int(np.asarray(log.active).sum())
    print(f"[run] {args.steps} steps x {args.batch} lanes in {dt:.2f}s "
          f"({n_active / dt:.0f} active car-steps/s, incl. compile)")
    m = jax.jit(fleet_metrics)(log, path.length)
    for k, v in m.items():
        print(f"  {k}: {float(v):.4f}")

    done_steps = np.asarray(log.s) >= float(path.length)
    if done_steps.any():
        lap_steps = int(np.argmax(done_steps.any(axis=-1) if done_steps.ndim > 1
                                  else done_steps))
        print(f"  lap completed at step {lap_steps} "
              f"({lap_steps * model_cfg.Ts:.2f} s sim time)")

    render_trajectory(grid, path, obstacles, log, model_cfg,
                      out_path=args.out, lanes=min(args.batch, 16))
    print(f"[viz] trajectory -> {args.out}")
    if args.gif and args.batch == 1:
        save_animation(grid, path, obstacles, log, model_cfg, args.gif)
        print(f"[viz] animation -> {args.gif}")


if __name__ == "__main__":
    main()
