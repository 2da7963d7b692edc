"""Controller-tuning sweep: one batched rollout, every lane a differently
weighted MPC.

The reference frames its controller as "multi-purpose" because tracking,
time-optimal driving, and obstacle avoidance are weight choices on one QP
(reference README.md:17-19; the weights are inline constants at
simulation.py:100-103, so trying a new tuning means editing the script and
re-running).  Here the weights are runtime data (`mpc.WeightSet`), so an
entire tuning grid — Q_ey x R_v x terminal-time weight — runs as ONE
compiled fleet program and the whole grid is scored in a single rollout.

    python examples/weight_sweep.py --steps 300
"""

import argparse
import itertools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from multi_purpose_mpc_tpu.config import SimConfig, sim_track_preset
from multi_purpose_mpc_tpu.mpc import WeightSet
from multi_purpose_mpc_tpu.ops.path import build_reference_path
from multi_purpose_mpc_tpu.ops.speed_profile import compute_speed_profile
from multi_purpose_mpc_tpu.simulation import init_fleet, simulate_fleet
from multi_purpose_mpc_tpu.utils.compile_cache import enable_compile_cache
from multi_purpose_mpc_tpu.utils.maps import add_obstacles_host, load_grid_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--repeats", type=int, default=4,
                   help="perturbed starts per weight config (Monte-Carlo)")
    args = p.parse_args()
    enable_compile_cache()

    map_cfg, path_cfg, model_cfg, mpc_cfg, speed_cfg, obstacles = (
        sim_track_preset(asset_dir=os.path.join(REPO, "assets", "maps")))
    grid = load_grid_map(map_cfg)
    path = build_reference_path(grid, path_cfg)
    grid = add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution,
                              obstacles)
    path = compute_speed_profile(path, speed_cfg)

    # tuning grid: tracking weight x speed-tracking weight x time weight
    q_ey_grid = (0.5, 1.0, 2.0, 5.0)
    r_v_grid = (0.01, 0.1, 0.5)
    t_w_grid = (0.0, 10.0, 100.0)
    combos = list(itertools.product(q_ey_grid, r_v_grid, t_w_grid))
    B = len(combos) * args.repeats
    rows = combos * args.repeats
    ws = WeightSet(
        Q=jnp.asarray([[q, 0.0, 0.0] for q, _, _ in rows], jnp.float32),
        R=jnp.asarray([[r, 0.0] for _, r, _ in rows], jnp.float32),
        QN=jnp.asarray([[q, 0.0, tw] for q, _, tw in rows], jnp.float32))

    rng = np.random.default_rng(0)
    fleet = init_fleet(
        path, mpc_cfg.N, B,
        e_y0=jnp.asarray(rng.uniform(-0.03, 0.03, B), jnp.float32))

    print(f"[setup] {len(combos)} weight configs x {args.repeats} starts "
          f"= {B} lanes on {jax.devices()[0].platform}")
    t0 = time.perf_counter()
    res = simulate_fleet(grid, path, mpc_cfg, model_cfg,
                         SimConfig(max_steps=args.steps), fleet, weights=ws)
    jax.block_until_ready(res)
    dt = time.perf_counter() - t0
    print(f"[run] {args.steps} steps x {B} lanes in {dt:.2f}s "
          f"(incl. compile)")

    # score each config: lap completion steps (lower = faster), mean |e_y|
    s_log = np.asarray(res.log.s)  # (T, B)
    e_y = np.abs(np.asarray(res.log.e_y))
    act = np.asarray(res.log.active)
    failed = np.asarray(res.final_state.failed)
    done = s_log >= float(path.length)
    lap = np.where(done.any(0), done.argmax(0), args.steps)  # (B,)

    K = len(combos)
    lap_c = lap.reshape(args.repeats, K).mean(0)
    # a config whose lanes all fail instantly has an empty active mask —
    # score it inf so it sorts last instead of NaN-corrupting the lexsort
    ey_c = np.array([e_y[:, i::K][act[:, i::K]].mean()
                     if act[:, i::K].any() else np.inf for i in range(K)])
    fail_c = failed.reshape(args.repeats, K).sum(0)

    print(f"{'Q_ey':>6} {'R_v':>6} {'t_w':>6} | {'lap steps':>9} "
          f"{'mean|e_y|':>9} {'failed':>6}")
    order = np.lexsort((ey_c, lap_c))
    for i in order:
        q, r, tw = combos[i]
        print(f"{q:6.2f} {r:6.2f} {tw:6.1f} | {lap_c[i]:9.1f} "
              f"{ey_c[i]:9.4f} {int(fail_c[i]):6d}")
    best = order[0]
    print(f"[best] Q_ey={combos[best][0]}, R_v={combos[best][1]}, "
          f"t_weight={combos[best][2]} -> {lap_c[best]:.0f} steps, "
          f"mean |e_y| {ey_c[best]:.4f} m")


if __name__ == "__main__":
    main()
