"""Closed-loop simulation tests: end-to-end parity with the float64 oracle,
tracking quality, fleet batching consistency, per-lane failure isolation."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multi_purpose_mpc_tpu.config import SimConfig
from multi_purpose_mpc_tpu.models.bicycle import init_car_state
from multi_purpose_mpc_tpu.ops.speed_profile import compute_speed_profile
from multi_purpose_mpc_tpu.simulation import (
    init_fleet,
    simulate_closed_loop,
    simulate_fleet,
)
from tests.oracle.sim import path_to_dict, simulate_oracle


@pytest.fixture(scope="module")
def scenario(sim_track):
    path = compute_speed_profile(sim_track["path"], sim_track["speed_cfg"])
    return dict(sim_track, path=path)


@pytest.fixture(scope="module")
def scenario_free(sim_track):
    """Sim_Track without obstacles: the S4 minimum end-to-end slice.

    Obstacle pinch-points make the QP near-infeasible at solver-dependent
    steps, forking trajectories legitimately (both sides enter the
    reference's replay path at different times) — so the tight oracle parity
    runs on the obstacle-free config, where QPs stay well-conditioned.
    """
    import os

    from multi_purpose_mpc_tpu.config import sim_track_preset
    from multi_purpose_mpc_tpu.utils.maps import load_grid_map
    from multi_purpose_mpc_tpu.ops.path import build_reference_path

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    map_cfg, path_cfg, model_cfg, mpc_cfg, speed_cfg, _ = sim_track_preset(
        asset_dir=os.path.join(repo, "assets", "maps"), use_obstacles=False)
    grid = load_grid_map(map_cfg)
    path = build_reference_path(grid, path_cfg)
    path = compute_speed_profile(path, speed_cfg)
    return dict(grid=grid, path=path, mpc_cfg=mpc_cfg, model_cfg=model_cfg)


def test_closed_loop_matches_oracle_behavior(scenario_free):
    scenario = scenario_free
    """Behavioral parity with the float64 CPU oracle.

    Elementwise pose parity is ill-posed for this controller: the reference
    cost (R = diag(0.5, 0)) leaves the curvature input nearly cost-flat, so
    even the float64 oracle returns kappa_0 anywhere in a ~[-5, +2] band
    depending on its tolerance (measured; OSQP at its default eps=1e-3 has
    the same property).  What IS pinned by the problem — and what we compare
    tightly — is the *behavior*: the speed command (strongly determined:
    oracle v_0 varies < 1e-5 across tolerances), path progress, cross-track
    error statistics, and corridor compliance.
    """
    T = 40
    grid = scenario["grid"]
    path = scenario["path"]
    cfg = scenario["mpc_cfg"]
    model = scenario["model_cfg"]

    res = simulate_closed_loop(grid, path, cfg, model, SimConfig(max_steps=T))
    log = res.log

    occ = np.asarray(grid.occ)
    origin = (float(grid.origin[0]), float(grid.origin[1]))
    r = float(grid.resolution)
    # ip oracle: ~5000x faster than the eps=1e-9 f64 ADMM on these QPs and
    # agrees to ~1e-7 where both converge (tests/oracle/sim.py) — the
    # behavioral bars below are at 1e-2..1e-1 scale.  Cuts this test from
    # ~227 s to well under a minute (r5 suite-time work, VERDICT #8).
    olog = simulate_oracle(occ, origin, r, path_to_dict(path), cfg, model, T,
                           K=cfg.n_scan_samples, S=cfg.max_segments,
                           qp_solver="ip")

    # Compare up to the first replay step on either side: near obstacle
    # pinch-points both controllers legitimately enter the reference's
    # replay path (MPC.py:208-216), after which step-by-step comparison is
    # meaningless.  Require a long clean prefix.
    ok_jax = np.asarray(log.ok)
    first_bad = min(
        int(np.argmax(~olog["solved"])) if (~olog["solved"]).any() else T,
        int(np.argmax(~ok_jax)) if (~ok_jax).any() else T,
        len(olog["x"]))
    To = first_bad
    assert To >= 35, f"clean comparison window too short: {To}"

    # Speed commands compare elementwise only at step 0 (cold kappa_pred):
    # from step 1 on, the (cost-flat, solver-arbitrary) kappa sequence feeds
    # back into the v_max_dyn = sqrt(ay_max/|kappa_pred|) cap — in the
    # reference exactly as here — so the tail comparison is statistical.
    assert abs(float(np.asarray(log.v)[0]) - olog["v"][0]) < 5e-3
    v_jax = np.asarray(log.v)[:To]
    v_orc = olog["v"][:To]
    # both solvers clamp v to sqrt(ay_max/|kappa_pred|) at kappa-flat-driven
    # steps; means agree to ~5%
    assert abs(v_jax.mean() - v_orc.mean()) < 0.05
    # path progress within the same ~5% band as speed
    ds = np.abs(np.asarray(log.s)[To - 1] - olog["s"][To - 1])
    assert ds < 0.05 * olog["s"][To - 1] + 0.01, f"progress deviation {ds:.3e}"
    # cross-track behavior: both tracks stay near the corridor center;
    # compare e_y envelopes rather than step-by-step poses
    e_jax = np.asarray(log.e_y)[:To]
    e_orc = olog["e_y"][:To]
    assert np.abs(e_jax).max() < max(np.abs(e_orc).max() + 0.02, 0.03)
    assert np.abs(e_jax.mean() - e_orc.mean()) < 0.01


def test_full_lap_completes_and_tracks(scenario):
    """Obstacle-avoidance config completes the lap with bounded path error
    and no failed lanes (the de-facto end-to-end criterion, SURVEY.md §4)."""
    res = simulate_closed_loop(scenario["grid"], scenario["path"],
                               scenario["mpc_cfg"], scenario["model_cfg"],
                               SimConfig(max_steps=400))
    final = res.final_state
    assert bool(final.done), f"lap incomplete: s={float(final.s):.2f}"
    assert not bool(final.failed)

    log = res.log
    active = np.asarray(log.active)
    # Most active-step controls accepted.  Near obstacle pinch-points the
    # corridor makes the QP genuinely near-infeasible and the replay fallback
    # engages — exactly the reference's "Infeasible problem!" path
    # (MPC.py:208-216) — so the bar is "mostly accepted + never lane-fatal".
    oks = np.asarray(log.ok)[active]
    assert oks.mean() > 0.85, f"accept rate {oks.mean():.3f}"
    # e_y stays within the static drivable envelope while active
    e_y = np.asarray(log.e_y)[active]
    assert np.abs(e_y).max() < float(np.asarray(scenario["path"].ub).max()) + 0.05


def test_fleet_matches_single_lane(scenario):
    T = 25
    grid = scenario["grid"]
    path = scenario["path"]
    cfg = scenario["mpc_cfg"]
    model = scenario["model_cfg"]

    single = simulate_closed_loop(grid, path, cfg, model, SimConfig(max_steps=T))
    fleet0 = init_fleet(path, cfg.N, batch=3,
                        e_y0=jnp.asarray([0.0, 0.02, -0.02]))
    fleet = simulate_fleet(grid, path, cfg, model, SimConfig(max_steps=T), fleet0)

    # Lane 0 of the fleet behaves like the single run.  The fleet path uses
    # the batched solver (different float reduction order), and the cost-flat
    # curvature direction amplifies tiny diffs chaotically over time, so the
    # elementwise comparison covers a short prefix and the rest is envelope.
    np.testing.assert_allclose(np.asarray(fleet.log.v)[:3, 0],
                               np.asarray(single.log.v)[:3], atol=5e-3)
    # progress within the ~5% kappa-feedback band (see oracle test note)
    s_f = float(np.asarray(fleet.log.s)[-1, 0])
    s_s = float(np.asarray(single.log.s)[-1])
    assert abs(s_f - s_s) < 0.05 * s_s + 0.01, (s_f, s_s)
    assert np.abs(np.asarray(fleet.log.e_y)[:, 0]).max() < \
        np.abs(np.asarray(single.log.e_y)).max() + 0.02
    # perturbed lanes converge back toward the path
    e_y_final = np.abs(np.asarray(fleet.log.e_y)[-1])
    assert (e_y_final < 0.05).all()


def test_fleet_determinism(scenario):
    T = 10
    fleet0 = init_fleet(scenario["path"], scenario["mpc_cfg"].N, batch=2)
    a = simulate_fleet(scenario["grid"], scenario["path"], scenario["mpc_cfg"],
                       scenario["model_cfg"], SimConfig(max_steps=T), fleet0)
    b = simulate_fleet(scenario["grid"], scenario["path"], scenario["mpc_cfg"],
                       scenario["model_cfg"], SimConfig(max_steps=T), fleet0)
    np.testing.assert_array_equal(np.asarray(a.log.x), np.asarray(b.log.x))


def test_done_lane_freezes(scenario):
    """A lane that finishes the lap must stop moving (v forced to 0)."""
    path = scenario["path"]
    st = init_car_state(path, scenario["mpc_cfg"].N)
    st = st.replace(s=jnp.float32(float(path.length) - 0.01))
    res = simulate_closed_loop(scenario["grid"], path, scenario["mpc_cfg"],
                               scenario["model_cfg"], SimConfig(max_steps=8),
                               state0=st)
    v = np.asarray(res.log.v)
    done_from = np.argmax(np.asarray(res.log.s) >= float(path.length))
    assert bool(res.final_state.done)
    assert (v[done_from + 1:] == 0.0).all()
