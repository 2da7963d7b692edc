"""Closed-loop MPC throughput: car-steps/sec on one device.

Runs the full sense->corridor->linearize->QP-solve->actuate->integrate loop
as a jitted ``lax.scan`` over a fleet on four workloads: the Sim_Track
obstacle-avoidance fleet at batch 4096 (the headline), the Real_Track fleet
at batch 1024, the LiDAR-in-the-loop fleet with per-lane maps at batch 1024,
and a single car.

Prints ONE JSON line: {"metric", "value", "unit", "detail"}, where detail
names the device (platform, kind, count) and carries the other workloads'
rates and the headline fleet's health.  Every timed call is warmed up first
and fenced with ``jax.block_until_ready``; each rate is the median of three
runs.  Fails (non-zero exit) when a fleet-health gate does not hold.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from multi_purpose_mpc_tpu.config import (LidarConfig, SimConfig,
                                          real_track_preset, sim_track_preset)
from multi_purpose_mpc_tpu.ops.path import build_reference_path
from multi_purpose_mpc_tpu.ops.speed_profile import compute_speed_profile
from multi_purpose_mpc_tpu.simulation import (feasible_starts, init_fleet,
                                              simulate_closed_loop,
                                              simulate_fleet,
                                              simulate_lidar_fleet)
from multi_purpose_mpc_tpu.utils.compile_cache import enable_compile_cache
from multi_purpose_mpc_tpu.utils.maps import add_obstacles_host, load_grid_map

MAPS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                    "maps")
BATCH = 4096
STEPS = 50


def _median_wall(run, inputs):
    """Warm up on ``inputs[0]``; median wall of the remaining inputs."""
    jax.block_until_ready(run(inputs[0]))
    times = []
    for x in inputs[1:]:
        jax.block_until_ready(x)
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(x))
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2], out


def _gate(cond, msg):
    if not cond:
        raise RuntimeError(f"fleet-health gate failed: {msg}")


def main():
    enable_compile_cache()
    map_cfg, path_cfg, model_cfg, mpc_cfg, speed_cfg, obstacles = (
        sim_track_preset(asset_dir=MAPS))
    grid = load_grid_map(map_cfg)
    path = build_reference_path(grid, path_cfg)
    grid = add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution,
                              obstacles)
    path = compute_speed_profile(path, speed_cfg)

    def make_fleet(seed, batch=BATCH):
        # starts whose first QP is certified feasible (simulation.feasible_
        # starts): a random spawn inside an obstacle's safety zone would
        # measure a doomed lane, not driving
        rng = np.random.default_rng(seed)
        wp0, e_y0 = feasible_starts(grid, path, mpc_cfg, model_cfg, batch,
                                    rng)
        return init_fleet(path, mpc_cfg.N, batch, e_y0=e_y0, wp_id0=wp0)

    sim = SimConfig(max_steps=STEPS)
    dt, res = _median_wall(
        lambda f: simulate_fleet(grid, path, mpc_cfg, model_cfg, sim, f),
        [make_fleet(s) for s in range(4)])
    car_steps_per_sec = BATCH * STEPS / dt

    active = np.asarray(res.log.active)
    ok = np.asarray(res.log.ok)
    floor = np.asarray(res.log.floor)
    solve_rate = float(ok[active].mean())
    rej = (~ok) & active
    # rejected steps split into certified-infeasible QPs (car outside the
    # margin-shrunk corridor; the reference replays there too) and feasible
    # QPs the solver left unconverged
    infeas_rate = float((rej & (floor > 0)).sum() / max(active.sum(), 1))
    solver_failure_rate = float((rej & (floor <= 0)).sum()
                                / max(active.sum(), 1))
    failed_lanes = int(np.asarray(res.final_state.failed).sum())
    progress = float(np.asarray(res.log.s[-1] - res.log.s[0]).mean())
    exp_progress = 0.5 * float(np.asarray(path.v_ref).mean()) * STEPS * 0.05
    max_ey = float(np.abs(np.asarray(res.log.e_y)[active]).max())
    _gate(failed_lanes == 0, f"{failed_lanes} lanes failed (replay overrun)")
    _gate(progress > exp_progress,
          f"mean progress {progress:.3f} m < floor {exp_progress:.3f} m")
    _gate(max_ey < 0.30, f"max |e_y| {max_ey:.3f} m out of corridor scale")
    _gate(solver_failure_rate < 0.02,
          f"solver failure rate {solver_failure_rate:.4f}")

    # single car (latency-bound)
    from multi_purpose_mpc_tpu.models.bicycle import init_car_state

    single_sim = SimConfig(max_steps=100)
    t_single, _ = _median_wall(
        lambda st: simulate_closed_loop(grid, path, mpc_cfg, model_cfg,
                                        single_sim, state0=st),
        [init_car_state(path, mpc_cfg.N, e_y=1e-4 * k) for k in range(4)])
    single_steps_per_sec = 100 / t_single

    # LiDAR-in-the-loop fleet: per-lane scans, per-lane online maps,
    # in-loop corridor extraction
    LIDAR_BATCH = 1024
    LIDAR_STEPS = 50
    lidar = LidarConfig(FoV=360, range=1.0, resolution=4, n_ray_samples=192)
    from multi_purpose_mpc_tpu.ops.corridor_extract import build_scanline_table

    ltable = build_scanline_table(grid, path, mpc_cfg.n_scan_samples)
    lsim = SimConfig(max_steps=LIDAR_STEPS, static_grid=False)
    t_lidar, _ = _median_wall(
        lambda f: simulate_lidar_fleet(grid, grid, path, mpc_cfg, model_cfg,
                                       lsim, lidar, f, table=ltable),
        [make_fleet(s, LIDAR_BATCH) for s in range(4, 8)])
    lidar_rate = LIDAR_BATCH * LIDAR_STEPS / t_lidar

    # Real_Track fleet (the reference's second scenario): non-circular real
    # map, Monte-Carlo starts over the first half of the path
    rt_map, rt_path_cfg, rt_model, rt_mpc, rt_speed, _ = real_track_preset(
        asset_dir=MAPS)
    rt_grid = load_grid_map(rt_map)
    rt_path = compute_speed_profile(build_reference_path(rt_grid, rt_path_cfg),
                                    rt_speed)
    RT_BATCH = 1024
    RT_STEPS = 30

    def make_rt_fleet(seed):
        rng = np.random.default_rng(seed)
        return init_fleet(
            rt_path, rt_mpc.N, RT_BATCH,
            e_y0=jnp.asarray(rng.uniform(-0.1, 0.1, RT_BATCH), jnp.float32),
            wp_id0=jnp.asarray(rng.integers(0, rt_path.n_wp // 2, RT_BATCH),
                               jnp.int32))

    rt_sim = SimConfig(max_steps=RT_STEPS)
    t_rt, _ = _median_wall(
        lambda f: simulate_fleet(rt_grid, rt_path, rt_mpc, rt_model, rt_sim,
                                 f),
        [make_rt_fleet(s) for s in range(8, 12)])
    rt_rate = RT_BATCH * RT_STEPS / t_rt

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "closed-loop MPC car-steps/sec (linearize+corridor+QP+"
                  "rollout), batch 4096, obstacle-avoidance config",
        "value": round(car_steps_per_sec, 1),
        "unit": "steps/s",
        "detail": {
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "batch": BATCH,
            "scan_steps": STEPS,
            "wall_s": round(dt, 4),
            "qp_solve_rate": round(solve_rate, 4),
            "qp_infeasible_rate": round(infeas_rate, 4),
            "qp_solver_failure_rate": round(solver_failure_rate, 5),
            "failed_lanes": failed_lanes,
            "max_abs_e_y": round(max_ey, 4),
            "single_car_steps_per_sec": round(single_steps_per_sec, 1),
            "lidar_fleet_steps_per_sec": round(lidar_rate, 1),
            "lidar_fleet_batch": LIDAR_BATCH,
            "real_track_steps_per_sec": round(rt_rate, 1),
            "real_track_batch": RT_BATCH,
        },
    }))


if __name__ == "__main__":
    main()
