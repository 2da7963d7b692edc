"""Horizons beyond the reference's N=30: the reference treats N as a free
parameter (MPC.py:15).  The solvers loop over stages, so code size and
on-chip state do not grow with N — these tests pin N=60 end-to-end on the
XLA path and N=60 kernel parity in interpret mode; chip_smoke.py checks the
compiled N=60 kernel on the GPU."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multi_purpose_mpc_tpu.config import SimConfig, SolverConfig
from multi_purpose_mpc_tpu.ops.ltv_qp import init_solver_carry, solve_ltv_qp
from multi_purpose_mpc_tpu.ops.speed_profile import compute_speed_profile
from multi_purpose_mpc_tpu.simulation import init_fleet, simulate_fleet
from tests.test_ltv_qp import _random_qp


@pytest.fixture(scope="module")
def scenario60(sim_track):
    path = compute_speed_profile(sim_track["path"], sim_track["speed_cfg"])
    cfg = dataclasses.replace(sim_track["mpc_cfg"], N=60)
    return dict(sim_track, path=path, mpc_cfg=cfg)


def test_horizon_60_fleet_rollout(scenario60):
    """N=60 obstacle-avoidance fleet drives the track: corridor gathers,
    QP assembly/solve, and replay logic all at double the reference horizon."""
    T = 30
    fleet0 = init_fleet(scenario60["path"], 60, batch=3,
                        wp_id0=jnp.asarray([0, 70, 140], jnp.int32))
    res = simulate_fleet(scenario60["grid"], scenario60["path"],
                         scenario60["mpc_cfg"], scenario60["model_cfg"],
                         SimConfig(max_steps=T), fleet0)
    ds = np.asarray(res.final_state.s) - np.asarray(fleet0.s)
    assert (ds > 0.5).all(), ds
    assert not np.asarray(res.final_state.failed).any()
    act = np.asarray(res.log.active)
    assert np.asarray(res.log.ok)[act].mean() > 0.8
    assert np.abs(np.asarray(res.log.e_y)).max() < 0.25


def test_horizon_60_kernel_matches_xla(sim_track):
    """The ADMM kernel at N=60 stays in lockstep with the XLA stage-scan
    solver.  Reduced iteration budget: interpret mode pays ~N x iters host
    cost; correctness not convergence is at stake."""
    from multi_purpose_mpc_tpu.ops.admm_kernel import solve_ltv_qp_kernel

    cfg = SolverConfig(iterations=3, rho_updates=2, polish_iters=2)
    rng = np.random.default_rng(5)
    B = 2
    qps = [_random_qp(rng, N=60) for _ in range(B)]
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), *qps)
    warm = jax.vmap(lambda _: init_solver_carry(60))(jnp.arange(B))

    ref = jax.vmap(lambda qp, w: solve_ltv_qp(qp, cfg, warm=w))(batched, warm)
    out = solve_ltv_qp_kernel(batched, warm, cfg, interpret=True)
    np.testing.assert_array_equal(np.asarray(out.status),
                                  np.asarray(ref.status))
    np.testing.assert_allclose(np.asarray(out.r_prim),
                               np.asarray(ref.r_prim), atol=1e-3)
    np.testing.assert_allclose(np.asarray(out.U[..., 0]),
                               np.asarray(ref.U[..., 0]), atol=2e-3)
    np.testing.assert_allclose(np.asarray(out.X), np.asarray(ref.X),
                               atol=5e-3)
