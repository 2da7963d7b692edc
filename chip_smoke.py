"""Smoke run of the closed-loop MPC fleet on one GPU.

    python chip_smoke.py          # phases a-e on one GPU
    python chip_smoke.py --four   # the four-GPU sharded phases only

Drives the system through its public entry points at full width and checks
the results with the repository's own gates:

a. Sim_Track obstacle fleet (``simulate_fleet``, B=4096, N=30, 50 steps):
   fleet-health gates, with the GPU kernel and with the XLA solver.  A lane
   that fails passes only as a knife-edge start: both solvers fail some of
   its ulp-perturbed copies.
b. The ADMM kernel as compiled for the GPU against the XLA reference solver
   on B=4096 scenario QPs, at N=30 and N=60.
c. Single car (``simulate_closed_loop``): one Sim_Track lap.
d. Real_Track fleet (B=1024, 30 steps): fleet-health gates, with the GPU
   kernel and with the XLA solver.
e. LiDAR mapping fleet with per-lane maps (B=1024, 50 steps).

``--four`` runs only the sharded fleets over a 1-D mesh of four GPUs, each
compared lane by lane with the same fleet on one GPU.

Timings printed here are smoke timings (compile and one steady run), not
benchmark results.  Any failed check raises, so the process exits non-zero
and prints no result line.  The last line of a passing run is one JSON
object naming the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FLEET = 4096  # lanes of the Sim_Track fleet and of the kernel check
SMALL_FLEET = 1024  # lanes of the Real_Track and LiDAR fleets


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def timed(label, fn):
    """Run ``fn`` twice (compile + run, then steady); print both walls."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    t1 = time.perf_counter()
    out = jax.block_until_ready(fn())
    t2 = time.perf_counter()
    print(f"  [{label}] smoke timing: first call (compile + run) "
          f"{t1 - t0:.2f} s, steady call {t2 - t1:.4f} s", flush=True)
    return out, t2 - t1


# |e_y| gates: the Sim_Track fleet gate (its corridor half-width is at most
# 0.23 m) and, on the 1.5 m Real_Track corridor, the bound the full
# Real_Track traversal keeps (tests/test_real_track.py: |e_y| < 0.6 m).
EY_LIMIT = {"sim": 0.30, "real": 0.60}
# failed lanes phase a tolerates, each only if it is a knife-edge start
MAX_KNIFE_EDGE = 4


def scenario(track="sim"):
    from multi_purpose_mpc_tpu.config import real_track_preset, sim_track_preset
    from multi_purpose_mpc_tpu.ops.path import build_reference_path
    from multi_purpose_mpc_tpu.ops.speed_profile import compute_speed_profile
    from multi_purpose_mpc_tpu.utils.maps import (add_obstacles_host,
                                                  load_grid_map)

    maps = os.path.join(REPO, "assets", "maps")
    if track == "sim":
        map_cfg, path_cfg, model, cfg, speed, obstacles = sim_track_preset(
            asset_dir=maps)
    else:
        map_cfg, path_cfg, model, cfg, speed, obstacles = real_track_preset(
            asset_dir=maps)
    grid = load_grid_map(map_cfg)
    path = build_reference_path(grid, path_cfg)
    if obstacles:
        grid = add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution,
                                  obstacles)
    path = compute_speed_profile(path, speed)
    return grid, path, model, cfg


def monte_carlo_fleet(grid, path, cfg, model, batch, seed):
    from multi_purpose_mpc_tpu.simulation import feasible_starts, init_fleet

    wp0, e_y0 = feasible_starts(grid, path, cfg, model, batch,
                                np.random.default_rng(seed))
    return init_fleet(path, cfg.N, batch, e_y0=e_y0, wp_id0=wp0)


def fleet_health(name, res, path, steps, fleet, track="sim"):
    """The fleet-health gates: no failed lanes, a progress floor, |e_y|
    in corridor scale, solver-failure share below 2%."""
    active = np.asarray(res.log.active)
    ok = np.asarray(res.log.ok)
    floor = np.asarray(res.log.floor)
    failed = int(np.asarray(res.final_state.failed).sum())
    progress = float(np.asarray(res.log.s[-1] - res.log.s[0]).mean())
    want = 0.5 * float(np.asarray(path.v_ref).mean()) * steps * 0.05
    max_ey = float(np.abs(np.asarray(res.log.e_y)[active]).max())
    rej = (~ok) & active
    n_act = max(int(active.sum()), 1)
    solver_fail = float((rej & (floor <= 0)).sum() / n_act)
    print(f"  [{name}] failed lanes {failed}, mean progress {progress:.4f} m "
          f"(floor {want:.4f}), max|e_y| {max_ey:.4f} m (limit "
          f"{EY_LIMIT[track]:.2f}), accept rate "
          f"{float(ok[active].mean()):.4f}, solver-failure share "
          f"{solver_fail:.5f}", flush=True)
    if failed:
        lanes = np.flatnonzero(np.asarray(res.final_state.failed))
        s_end = np.asarray(res.final_state.s)[lanes]
        print(f"  [{name}] failed lanes {lanes.tolist()[:8]}: start wp "
              f"{np.asarray(fleet.wp_id)[lanes].tolist()[:8]}, start e_y "
              f"{np.asarray(fleet.e_y)[lanes].round(4).tolist()[:8]}, "
              f"final s {s_end.round(3).tolist()[:8]}", flush=True)
    return failed, progress, want, max_ey, EY_LIMIT[track], solver_fail


def check_health(name, health, knife_edge=0):
    """The gates; ``knife_edge`` failed lanes are tolerated, each of them
    shown by :func:`knife_edge_lanes` to fail under both solvers."""
    failed, progress, want, max_ey, ey_max, solver_fail = health
    check(failed <= knife_edge, f"{name}: {failed} lanes failed")
    check(progress > want, f"{name}: progress {progress} below {want}")
    check(max_ey < ey_max, f"{name}: max |e_y| {max_ey} >= {ey_max}")
    check(solver_fail < 0.02, f"{name}: solver-failure share {solver_fail}")


def ulp_copies(path, cfg, fleet, lane):
    """FLEET copies of one lane's start, its e_y0 moved by -2048..2047 ulps
    (about 4 um either way at e_y0 = 0.02 m)."""
    import jax.numpy as jnp

    from multi_purpose_mpc_tpu.simulation import init_fleet

    e0 = np.float32(np.asarray(fleet.e_y)[lane])
    k = (np.arange(FLEET) - FLEET // 2).astype(np.float32)
    return init_fleet(
        path, cfg.N, FLEET, e_y0=jnp.asarray(e0 + k * np.spacing(e0)),
        wp_id0=jnp.full((FLEET,), int(np.asarray(fleet.wp_id)[lane]),
                        jnp.int32))


def knife_edge_lanes(grid, path, model, sim, fleet, runs):
    """Every lane that failed under either solver, rerun from ulp-perturbed
    copies of its start under both (``runs``: name -> (cfg, result)).  A
    start where both solvers fail some copies is a knife edge of the closed
    loop: there, float rounding decides whether the lane fails, and a kernel
    and the XLA solver (or two XLA builds) part after a few steps.  A lane
    failed by one solver at a start where the other never fails is a fault,
    and fails the phase."""
    from multi_purpose_mpc_tpu.simulation import simulate_fleet

    failed = {name: np.asarray(res.final_state.failed)
              for name, (_, res) in runs.items()}
    lanes = np.flatnonzero(np.logical_or.reduce(list(failed.values())))
    check(lanes.size <= MAX_KNIFE_EDGE, f"{lanes.size} failed lanes")
    for lane in lanes.tolist():
        shares = {}
        for name, (cfg, _) in runs.items():
            out = simulate_fleet(grid, path, cfg, model, sim,
                                 ulp_copies(path, cfg, fleet, lane))
            shares[name] = float(np.asarray(out.final_state.failed).mean())
        print(f"  [a] lane {lane} failed under "
              f"{[n for n, f in failed.items() if f[lane]]}; share of its "
              f"{FLEET} ulp-perturbed starts that fail: "
              + ", ".join(f"{n} {v:.4f}" for n, v in shares.items()),
              flush=True)
        check(min(shares.values()) > 0,
              f"lane {lane} fails under one solver only: not a knife edge")
    return lanes.size


def phase_a():
    from multi_purpose_mpc_tpu.config import SimConfig
    from multi_purpose_mpc_tpu.simulation import simulate_fleet

    print("phase a: Sim_Track obstacle fleet, B=4096, N=30, 50 steps",
          flush=True)
    grid, path, model, cfg = scenario("sim")
    fleet = monte_carlo_fleet(grid, path, cfg, model, FLEET, seed=1)
    sim = SimConfig(max_steps=50)
    res, t_kernel = timed("fleet, platform solver", lambda: simulate_fleet(
        grid, path, cfg, model, sim, fleet))
    health = fleet_health("a", res, path, 50, fleet)
    cfg_x = dataclasses.replace(cfg, solver_backend="xla")
    res_x, t_xla = timed("fleet, XLA solver", lambda: simulate_fleet(
        grid, path, cfg_x, model, sim, fleet))
    health_x = fleet_health("a/xla", res_x, path, 50, fleet)
    print(f"  [a] step time: platform solver {1e3 * t_kernel / 50:.3f} ms, "
          f"XLA solver {1e3 * t_xla / 50:.3f} ms", flush=True)
    edge = knife_edge_lanes(grid, path, model, sim, fleet, {
        "platform": (cfg, res), "xla": (cfg_x, res_x)})
    check_health("a", health, knife_edge=edge)
    check_health("a/xla", health_x, knife_edge=edge)


def phase_b():
    import jax
    import jax.numpy as jnp

    from multi_purpose_mpc_tpu.models.bicycle import init_car_state
    from multi_purpose_mpc_tpu.mpc import mpc_corridor, mpc_locate, mpc_pre_solve
    from multi_purpose_mpc_tpu.ops import admm
    from multi_purpose_mpc_tpu.ops.admm_kernel import solve_ltv_qp_kernel
    from multi_purpose_mpc_tpu.ops.constraints import extract_all_segments
    from multi_purpose_mpc_tpu.ops.ltv_qp import solve_ltv_qp

    print("phase b: ADMM kernel vs XLA reference, B=4096 scenario QPs",
          flush=True)
    grid, path, model, cfg = scenario("sim")
    segs = extract_all_segments(grid, path, 2 * model.safety_margin,
                                n_samples=cfg.n_scan_samples,
                                max_segments=cfg.max_segments)
    B = FLEET
    rng = np.random.default_rng(7)
    e0 = jnp.asarray(rng.uniform(-0.02, 0.02, B), jnp.float32)
    wp0 = jnp.asarray(np.arange(B) % path.n_wp, jnp.int32)
    for N in (30, 60):
        c = dataclasses.replace(cfg, N=N)
        states = jax.vmap(lambda e, w: init_car_state(path, N, e_y=e, wp_id=w)
                          )(e0, wp0)
        with jax.default_matmul_precision("highest"):
            located = jax.vmap(lambda s: mpc_locate(s, path))(states)
            cor = jax.vmap(lambda w: mpc_corridor(w, path, grid, c, model,
                                                  segs))(located[0])
            qp, _ = jax.vmap(lambda s, loc, co: mpc_pre_solve(
                s, path, grid, c, model, segs, located=loc, corridor=co))(
                states, located, cor)
            ref_fn = jax.jit(jax.vmap(
                lambda q, w: solve_ltv_qp(q, c.solver, warm=w)))
            ref, t_ref = timed(f"N={N} XLA solve", lambda: ref_fn(
                qp, states.solver))
        out, t_ker = timed(f"N={N} kernel solve", lambda: solve_ltv_qp_kernel(
            qp, states.solver, c.solver))
        ok_out = np.asarray(out.r_prim) <= c.feas_tol
        ok_ref = np.asarray(ref.r_prim) <= c.feas_tol
        d_rp = np.abs(np.asarray(out.r_prim) - np.asarray(ref.r_prim))
        d_v0 = np.abs(np.asarray(out.U[:, 0, 0]) - np.asarray(ref.U[:, 0, 0]))
        n_div = int((np.asarray(out.status) == admm.DIVERGED).sum())
        acc = ok_ref | ok_out
        worst = int(np.argmax(d_rp))
        print(f"  [b N={N}] accept mismatches {int((ok_out != ok_ref).sum())}"
              f", accepted {int(ok_ref.sum())}/{B}; accepted lanes: max|d "
              f"r_prim| {d_rp[acc].max():.3e}, max|d U[:,0,0]| "
              f"{d_v0[acc].max():.3e}; all lanes: max|d r_prim| "
              f"{d_rp.max():.3e} (worst lane r_prim XLA "
              f"{float(ref.r_prim[worst]):.4e}, kernel "
              f"{float(out.r_prim[worst]):.4e}), max|d U[:,0,0]| "
              f"{d_v0.max():.3e}; diverged {n_div}; solve time kernel "
              f"{1e3 * t_ker:.3f} ms, XLA {1e3 * t_ref:.3f} ms", flush=True)
        # Rejected lanes hold QPs whose ADMM iterates do not converge, and
        # the controller replays instead of using their solution.  There the
        # residual and first control have no reference to hold the kernel
        # to: two XLA builds of the reference (host CPU and GPU) differ by up
        # to 0.52 in U[0,0] on the rejected steps of one fleet lane (PERF.md,
        # lane 843).  The bars therefore apply where a solver accepts; the
        # accept decision itself must agree on every lane.
        check((ok_out == ok_ref).all(), f"N={N}: accept decisions differ")
        check(d_rp[acc].max() <= 5e-3,
              f"N={N}: r_prim deviates by {d_rp[acc].max()}")
        check(d_v0[acc].max() <= 2e-2,
              f"N={N}: U[:,0,0] deviates by {d_v0[acc].max()}")
        check(n_div == 0, f"N={N}: {n_div} diverged lanes")


def phase_c():
    from multi_purpose_mpc_tpu.config import SimConfig
    from multi_purpose_mpc_tpu.simulation import simulate_closed_loop

    print("phase c: single car, Sim_Track lap, 250 steps", flush=True)
    grid, path, model, cfg = scenario("sim")
    res, _ = timed("single car", lambda: simulate_closed_loop(
        grid, path, cfg, model, SimConfig(max_steps=250)))
    active = np.asarray(res.log.active)
    accept = float(np.asarray(res.log.ok)[active].mean())
    steps = int(active.sum())
    done = bool(res.final_state.done)
    print(f"  [c] lap done {done} in {steps} active steps, accept rate "
          f"{accept:.4f}", flush=True)
    check(done and steps <= 200, f"lap not finished ({steps} steps)")
    check(accept >= 0.95, f"accept rate {accept}")


def phase_d():
    import jax.numpy as jnp

    from multi_purpose_mpc_tpu.config import SimConfig
    from multi_purpose_mpc_tpu.simulation import init_fleet, simulate_fleet

    print("phase d: Real_Track fleet, B=1024, 30 steps", flush=True)
    grid, path, model, cfg = scenario("real")
    B = SMALL_FLEET
    rng = np.random.default_rng(6)
    fleet = init_fleet(
        path, cfg.N, B,
        e_y0=jnp.asarray(rng.uniform(-0.1, 0.1, B), jnp.float32),
        wp_id0=jnp.asarray(rng.integers(0, path.n_wp // 2, B), jnp.int32))
    sim = SimConfig(max_steps=30)
    res, _ = timed("Real_Track fleet", lambda: simulate_fleet(
        grid, path, cfg, model, sim, fleet))
    health = fleet_health("d", res, path, 30, fleet, track="real")
    cfg_x = dataclasses.replace(cfg, solver_backend="xla")
    res_x, _ = timed("Real_Track fleet, XLA solver", lambda: simulate_fleet(
        grid, path, cfg_x, model, sim, fleet))
    health_x = fleet_health("d/xla", res_x, path, 30, fleet, track="real")
    check_health("d", health)
    check_health("d/xla", health_x)


def phase_e():
    from multi_purpose_mpc_tpu.config import LidarConfig, SimConfig
    from multi_purpose_mpc_tpu.simulation import simulate_lidar_fleet

    print("phase e: LiDAR fleet, per-lane maps, B=1024, 50 steps", flush=True)
    grid, path, model, cfg = scenario("sim")
    fleet = monte_carlo_fleet(grid, path, cfg, model, SMALL_FLEET, seed=4)
    lidar = LidarConfig(FoV=360, range=1.0, resolution=4, n_ray_samples=192)
    sim = SimConfig(max_steps=50, static_grid=False)
    (res, occ), _ = timed("LiDAR fleet", lambda: simulate_lidar_fleet(
        grid, grid, path, cfg, model, sim, lidar, fleet))
    ds = np.asarray(res.final_state.s - fleet.s)
    print(f"  [e] min progress {ds.min():.4f} m, mean {ds.mean():.4f} m, "
          f"map stack {tuple(occ.shape)}", flush=True)
    check((ds > 0).all(), f"{int((ds <= 0).sum())} lanes made no progress")
    check(np.isfinite(np.asarray(res.log.x)).all(), "non-finite poses")


def four_gpus():
    import jax

    from multi_purpose_mpc_tpu.config import LidarConfig, SimConfig
    from multi_purpose_mpc_tpu.parallel.fleet import (
        simulate_fleet_sharded, simulate_lidar_fleet_sharded)
    from multi_purpose_mpc_tpu.parallel.mesh import fleet_mesh
    from multi_purpose_mpc_tpu.simulation import (simulate_fleet,
                                                  simulate_lidar_fleet)

    devices = jax.devices()
    check(len(devices) == 4, f"--four needs 4 devices, found {len(devices)}")
    mesh = fleet_mesh(devices)
    grid, path, model, cfg = scenario("sim")

    print("four GPUs: sharded Sim_Track fleet, B=4096, 50 steps", flush=True)
    fleet = monte_carlo_fleet(grid, path, cfg, model, FLEET, seed=1)
    sim = SimConfig(max_steps=50)
    sharded, _ = timed("sharded fleet", lambda: simulate_fleet_sharded(
        mesh, grid, path, cfg, model, sim, fleet))
    single, _ = timed("one-GPU fleet", lambda: simulate_fleet(
        grid, path, cfg, model, sim, fleet))
    same = lanes_equal(sharded, single)
    d_s = np.abs(np.asarray(sharded.final_state.s - single.final_state.s))
    print(f"  [4gpu] lanes bitwise equal to one GPU (final state and logs) "
          f"{int(same.sum())}/{same.size}; per-lane |d s| max "
          f"{d_s.max():.3e} m", flush=True)
    # a lane's rollout does not depend on which device or batch holds it
    check(same.all(), f"{int((~same).sum())} sharded lanes differ from one GPU")

    print("four GPUs: shared-map LiDAR fleet, B=1024, 50 steps", flush=True)
    lfleet = monte_carlo_fleet(grid, path, cfg, model, SMALL_FLEET, seed=4)
    lidar = LidarConfig(FoV=360, range=1.0, resolution=4, n_ray_samples=192)
    lsim = SimConfig(max_steps=50, static_grid=False)
    (lres, occ4), _ = timed("sharded LiDAR fleet", lambda: (
        simulate_lidar_fleet_sharded(mesh, grid, grid, path, cfg, model, lsim,
                                     lidar, lfleet, shared_grid=True)))
    (lres1, occ1), _ = timed("one-GPU LiDAR fleet", lambda: (
        simulate_lidar_fleet(grid, grid, path, cfg, model, lsim, lidar,
                             lfleet, shared_grid=True,
                             writeback_backend="dense")))
    same = lanes_equal(lres, lres1)
    rows, cols = np.nonzero(np.asarray(occ4) != np.asarray(occ1))
    print(f"  [4gpu lidar] lanes bitwise equal to one GPU {int(same.sum())}/"
          f"{same.size}; occupancy cells differing {rows.size} of "
          f"{occ1.size}", flush=True)
    ds = np.asarray(lres.final_state.s - lfleet.s)
    check((ds > 0).all(), "sharded LiDAR lanes without progress")
    if same.all():
        # the pooled masks are or-reductions: equal poses, equal map
        check(rows.size == 0, "maps differ although every lane agrees")
    elif rows.size:
        # a cell can differ only where a lane that parted could see it
        px = np.concatenate([np.asarray(lfleet.x)[~same]] + [
            np.asarray(r.log.x)[:, ~same].ravel() for r in (lres, lres1)])
        py = np.concatenate([np.asarray(lfleet.y)[~same]] + [
            np.asarray(r.log.y)[:, ~same].ravel() for r in (lres, lres1)])
        reach = cell_reach(grid, rows, cols, px, py)
        print(f"  [4gpu lidar] differing cells lie within {reach:.3f} m of a "
              f"differing lane's pose (sensor range {lidar.range} m)",
              flush=True)
        check(reach <= lidar.range + 2 * float(grid.resolution),
              "map cells differ out of range of every lane that differs")


def cell_reach(grid, rows, cols, px, py):
    """Largest distance from a grid cell (centre) to its nearest pose."""
    res_m = float(grid.resolution)
    cx = (cols + 0.5) * res_m + float(grid.origin[0])
    cy = (rows + 0.5) * res_m + float(grid.origin[1])
    return max(np.hypot(cx[i:i + 256, None] - px, cy[i:i + 256, None] - py)
               .min(axis=1).max() for i in range(0, cx.size, 256))


def lanes_equal(a, b):
    """Per lane: is every final-state leaf and every log entry bitwise
    equal between two rollouts of the same fleet?"""
    import jax

    leaves = lambda t: [np.asarray(x) for x in jax.tree.leaves(t)]
    same = None
    for x, y in zip(leaves(a.final_state), leaves(b.final_state)):
        eq = (x == y).reshape(x.shape[0], -1).all(axis=1)
        same = eq if same is None else same & eq
    for x, y in zip(leaves(a.log), leaves(b.log)):
        same &= (x == y).reshape(x.shape[0], x.shape[1], -1).all(axis=(0, 2))
    return same


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-GPU sharded phases")
    args = parser.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"chip_smoke: no GPU found (JAX backend "
                 f"{jax.default_backend()!r}); nothing was run")
    from multi_purpose_mpc_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    for line in smi.stdout.strip().splitlines():
        print(f"gpu: {line.strip()}")
    print(f"jax.devices(): {jax.devices()}")
    print(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache: {cache}", flush=True)

    if args.four:
        four_gpus()
    else:
        for phase in (phase_a, phase_b, phase_c, phase_d, phase_e):
            phase()

    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
