"""The Pallas-Triton ADMM kernel (ops/admm_kernel.py) in interpret mode
against the XLA stage-scan solver, plus its wrapper's lane tiling and
padding.  The compiled kernel is checked against the same reference on the
GPU by ``chip_smoke.py`` (phase b)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multi_purpose_mpc_tpu.config import SolverConfig
from multi_purpose_mpc_tpu.ops import admm
from multi_purpose_mpc_tpu.ops.admm_kernel import (LANE_TILE, pad_lanes,
                                                   solve_ltv_qp_kernel)
from multi_purpose_mpc_tpu.ops.ltv_qp import init_solver_carry, solve_ltv_qp
from tests.test_ltv_qp import _random_qp

# small budget: interpret mode costs ~N x iterations host work per program;
# correctness of every phase (rounds, rho adaptation, polish), not
# convergence, is at stake
CFG = SolverConfig(iterations=3, rho_updates=2, polish_iters=2)


def _batch(N, B, seed=5):
    rng = np.random.default_rng(seed)
    qps = [_random_qp(rng, N=N) for _ in range(min(B, 4))]
    qps = [qps[i % len(qps)] for i in range(B)]
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), *qps)
    warm = jax.vmap(lambda _: init_solver_carry(N))(jnp.arange(B))
    return batched, warm


def _assert_matches(out, ref, x_tol):
    np.testing.assert_array_equal(np.asarray(out.status),
                                  np.asarray(ref.status))
    np.testing.assert_allclose(np.asarray(out.r_prim),
                               np.asarray(ref.r_prim), atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.r_dual),
                               np.asarray(ref.r_dual), rtol=1e-2, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.U[..., 0]),
                               np.asarray(ref.U[..., 0]), atol=2e-3)
    np.testing.assert_allclose(np.asarray(out.X), np.asarray(ref.X),
                               atol=x_tol)
    # rho adapts by square roots of residual ratios, which amplify float
    # noise in near-converged residuals
    np.testing.assert_allclose(np.asarray(out.carry.rho),
                               np.asarray(ref.carry.rho), rtol=0.1)


def test_kernel_matches_xla_n30():
    """Same algorithm stage for stage: statuses, residuals, adapted rho and
    solutions agree with the XLA solver at the reference horizon."""
    qp, warm = _batch(30, 3)
    ref = jax.vmap(lambda q, w: solve_ltv_qp(q, CFG, warm=w))(qp, warm)
    out = solve_ltv_qp_kernel(qp, warm, CFG, interpret=True)
    _assert_matches(out, ref, x_tol=5e-3)
    assert (np.asarray(out.status) != admm.DIVERGED).all()


def test_kernel_warm_start_carry():
    """The returned carry warm-starts the next solve exactly like the XLA
    solver's (primal, slack, dual and rho iterates all round-trip)."""
    qp, warm = _batch(8, 2, seed=11)
    ref = jax.vmap(lambda q, w: solve_ltv_qp(q, CFG, warm=w))(qp, warm)
    out = solve_ltv_qp_kernel(qp, warm, CFG, interpret=True)
    ref2 = jax.vmap(lambda q, w: solve_ltv_qp(q, CFG, warm=w))(qp, ref.carry)
    out2 = solve_ltv_qp_kernel(qp, out.carry, CFG, interpret=True)
    _assert_matches(out2, ref2, x_tol=5e-3)


def test_kernel_batch_padding():
    """A batch that is not a multiple of the lane tile is padded to it and
    trimmed back: every real lane matches the reference."""
    B = 301
    assert B % LANE_TILE != 0
    qp, warm = _batch(4, B)
    ref = jax.vmap(lambda q, w: solve_ltv_qp(q, CFG, warm=w))(qp, warm)
    out = solve_ltv_qp_kernel(qp, warm, CFG, interpret=True)
    assert out.X.shape == ref.X.shape and out.r_prim.shape == (B,)
    _assert_matches(out, ref, x_tol=1e-4)


@pytest.mark.gpu
def test_kernel_compiled_on_gpu():
    """The kernel as compiled for the GPU (no interpret mode) matches the
    reference; chip_smoke.py runs the same check at full width."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: the compiled kernel has no CPU "
                    "lowering (interpret-mode tests above cover the math)")
    qp, warm = _batch(30, 256)
    ref = jax.vmap(lambda q, w: solve_ltv_qp(q, CFG, warm=w))(qp, warm)
    out = solve_ltv_qp_kernel(qp, warm, CFG)
    _assert_matches(out, ref, x_tol=5e-3)


@pytest.mark.parametrize("batch", [1, 31, 32, 33, 100, 1024, 4097])
def test_lane_padding(batch):
    """The wrapper pads the lane axis of every leaf to whole 32-lane tiles
    with copies of lane 0 and leaves the real lanes untouched."""
    tree = {"a": jnp.arange(batch, dtype=jnp.float32),
            "b": jnp.arange(3 * batch, dtype=jnp.int32).reshape(batch, 3)}
    out = pad_lanes(tree, batch)
    Bp = -(-batch // LANE_TILE) * LANE_TILE
    for k in tree:
        got, src = np.asarray(out[k]), np.asarray(tree[k])
        assert got.shape == (Bp,) + src.shape[1:]
        np.testing.assert_array_equal(got[:batch], src)
        np.testing.assert_array_equal(got[batch:],
                                      np.broadcast_to(src[:1], got[batch:].shape))
