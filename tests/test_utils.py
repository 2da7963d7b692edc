"""Auxiliary subsystems: checkpoint/resume, profiling, post-hoc viz
(SURVEY.md §5 — the reference has none of these)."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import matplotlib

matplotlib.use("Agg")

from multi_purpose_mpc_tpu.config import SimConfig
from multi_purpose_mpc_tpu.ops.speed_profile import compute_speed_profile
from multi_purpose_mpc_tpu.simulation import init_fleet, simulate_fleet
from multi_purpose_mpc_tpu.utils.checkpoint import load_fleet_state, save_fleet_state
from multi_purpose_mpc_tpu.utils.profiling import time_stages, timeit
from multi_purpose_mpc_tpu.utils.viz import render_frame, render_trajectory


def _rollout(scenario, fleet0, T):
    return simulate_fleet(scenario["grid"], scenario["path"],
                          scenario["mpc_cfg"], scenario["model_cfg"],
                          SimConfig(max_steps=T), fleet0)


def test_checkpoint_roundtrip_resumes_identically(sim_track, tmp_path):
    scenario = dict(sim_track,
                    path=compute_speed_profile(sim_track["path"],
                                               sim_track["speed_cfg"]))
    fleet0 = init_fleet(scenario["path"], scenario["mpc_cfg"].N, batch=3)

    # run 6 steps; checkpoint; run 4 more
    mid = _rollout(scenario, fleet0, 6).final_state
    ckpt = str(tmp_path / "fleet.npz")
    save_fleet_state(ckpt, mid, step=6)

    restored, step = load_fleet_state(ckpt, like=mid)
    assert step == 6
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                            np.asarray(b)),
                 mid, restored)

    # resuming from the checkpoint == continuing the original run
    cont = _rollout(scenario, mid, 4)
    resumed = _rollout(scenario, restored, 4)
    np.testing.assert_array_equal(np.asarray(cont.log.x),
                                  np.asarray(resumed.log.x))


def test_lidar_fleet_checkpoint_resume(sim_track, tmp_path):
    """Checkpoint/resume of the MAPPING fleet: the save/load helpers are
    pytree-generic, so the (CarState, known-map carry) tuple snapshots and
    resumes bitwise — the online map is part of the sim state."""
    from multi_purpose_mpc_tpu.config import LidarConfig
    from multi_purpose_mpc_tpu.ops.grid import make_grid_map
    from multi_purpose_mpc_tpu.simulation import simulate_lidar_fleet

    scenario = dict(sim_track,
                    path=compute_speed_profile(sim_track["path"],
                                               sim_track["speed_cfg"]))
    true_grid = scenario["grid"]
    known0 = make_grid_map(np.ones_like(np.asarray(true_grid.occ)),
                           (float(true_grid.origin[0]),
                            float(true_grid.origin[1])),
                           float(true_grid.resolution))
    lidar = LidarConfig(FoV=360, range=1.0, resolution=8, n_ray_samples=128)
    fleet0 = init_fleet(scenario["path"], scenario["mpc_cfg"].N, batch=2,
                        wp_id0=jnp.asarray([0, 70], jnp.int32))

    def roll(state, occ, steps):
        return simulate_lidar_fleet(
            true_grid, known0.replace(occ=occ), scenario["path"],
            scenario["mpc_cfg"], scenario["model_cfg"],
            SimConfig(max_steps=steps), lidar, state)

    res, occ_mid = roll(fleet0, known0.occ, 5)
    ckpt = str(tmp_path / "lidar_fleet.npz")
    save_fleet_state(ckpt, (res.final_state, occ_mid), step=5)
    (restored, occ_restored), step = load_fleet_state(
        ckpt, like=(res.final_state, occ_mid))
    assert step == 5
    np.testing.assert_array_equal(np.asarray(occ_mid),
                                  np.asarray(occ_restored))

    cont, occ_c = roll(res.final_state, occ_mid, 4)
    resumed, occ_r = roll(restored, occ_restored, 4)
    np.testing.assert_array_equal(np.asarray(cont.log.x),
                                  np.asarray(resumed.log.x))
    np.testing.assert_array_equal(np.asarray(occ_c), np.asarray(occ_r))


def test_orbax_checkpoint_roundtrip(sim_track, tmp_path):
    """The orbax backend round-trips the fleet pytree bitwise (VERDICT weak #7)."""
    import pytest

    pytest.importorskip("orbax.checkpoint")
    from multi_purpose_mpc_tpu.utils.checkpoint import (
        load_fleet_state_orbax, save_fleet_state_orbax)

    scenario = dict(sim_track,
                    path=compute_speed_profile(sim_track["path"],
                                               sim_track["speed_cfg"]))
    fleet0 = init_fleet(scenario["path"], scenario["mpc_cfg"].N, batch=3)
    mid = _rollout(scenario, fleet0, 6).final_state

    save_fleet_state_orbax(str(tmp_path / "orbax"), mid, step=6)
    restored = load_fleet_state_orbax(str(tmp_path / "orbax"), like=mid, step=6)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                            np.asarray(b)),
                 mid, restored)

    # resuming from the orbax checkpoint == continuing the original run
    cont = _rollout(scenario, mid, 4)
    resumed = _rollout(scenario, restored, 4)
    np.testing.assert_array_equal(np.asarray(cont.log.x),
                                  np.asarray(resumed.log.x))


def test_profiling_helpers():
    f = jax.jit(lambda x: (x * 2).sum())
    x = jnp.ones((64, 64))
    t = timeit(f, x, warmup=1, iters=3)
    assert t > 0
    stages = time_stages({"double": lambda: f(x)}, warmup=1, iters=2)
    assert stages["double"] > 0


def test_profiling_fence_agrees_with_bench_style_timing(sim_track):
    """`timeit` (fenced with block_until_ready) matches a manual
    measurement of the same jitted step fenced by a host transfer, so
    time_stages measures compute, not dispatch."""
    import time

    scenario = dict(sim_track,
                    path=compute_speed_profile(sim_track["path"],
                                               sim_track["speed_cfg"]))
    fleet0 = init_fleet(scenario["path"], scenario["mpc_cfg"].N, batch=8)

    def run():
        return _rollout(scenario, fleet0, 5).log.x

    t_helper = timeit(run, warmup=1, iters=3)

    run()  # warm
    manual = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = run()
        _ = float(np.asarray(out.sum()))  # host-transfer fence
        manual.append(time.perf_counter() - t0)
    t_manual = sorted(manual)[1]

    # Same order of magnitude: the dispatch-time artifact this guards
    # against is a ~1000x under-measurement, not a 3x jitter.
    assert t_helper > t_manual / 3
    assert t_helper < t_manual * 3 + 0.05


def test_multihost_seam_logic():
    """Process-count-aware lane partition + guarded init (VERDICT next #10)."""
    import pytest

    from multi_purpose_mpc_tpu.parallel.mesh import (
        global_fleet_mesh, init_distributed, local_lane_slice)

    # lane partition logic, pure
    assert local_lane_slice(4096, 0, 4) == slice(0, 1024)
    assert local_lane_slice(4096, 3, 4) == slice(3072, 4096)
    with pytest.raises(ValueError):
        local_lane_slice(10, 0, 4)

    # guarded init: no coordinator configured on this box -> no-op False
    assert init_distributed() is False

    # global mesh covers every device with the fleet axis
    mesh = global_fleet_mesh()
    assert mesh.axis_names == ("fleet",)
    assert mesh.devices.size == len(jax.devices())


def test_render_outputs(sim_track, tmp_path):
    scenario = dict(sim_track,
                    path=compute_speed_profile(sim_track["path"],
                                               sim_track["speed_cfg"]))
    from multi_purpose_mpc_tpu.simulation import simulate_closed_loop

    res = simulate_closed_loop(scenario["grid"], scenario["path"],
                               scenario["mpc_cfg"], scenario["model_cfg"],
                               SimConfig(max_steps=5))
    out = str(tmp_path / "traj.png")
    render_trajectory(scenario["grid"], scenario["path"],
                      scenario["obstacles"], res.log, scenario["model_cfg"],
                      out_path=out)
    assert os.path.getsize(out) > 1000
    ax = render_frame(scenario["grid"], scenario["path"], scenario["obstacles"],
                      res.log, 2, scenario["model_cfg"])
    assert ax is not None
