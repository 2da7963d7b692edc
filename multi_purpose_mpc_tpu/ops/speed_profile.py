"""Curvature-limited speed profile QP (the reference_path.py:289-354 port).

Assigns a reference velocity to every waypoint by solving

    minimize   sum_i ( 1/2 v_i^2 - v_max_dyn,i * v_i )
    subject to a_min <= (v_{i+1} - v_i) / (2 l_i) <= a_max      (i < N-1)
               v_min <= v_i <= min(v_max, sqrt(ay_max / |kappa_i|))

over the N = n_wp - 1 non-terminal waypoints, exactly the program the
reference builds row-by-row and hands to OSQP (reference_path.py:310-349).
Here the whole problem is assembled vectorized and solved by the in-house
dense ADMM — a one-time setup cost per path.

The last waypoint copies its neighbor's speed (reference_path.py:352-354).
"""

from __future__ import annotations

import jax.numpy as jnp

from multi_purpose_mpc_tpu.config import SolverConfig, SpeedProfileConstraints
from multi_purpose_mpc_tpu.ops.admm import admm_solve_jit
from multi_purpose_mpc_tpu.ops.path import PathData

_EPS = 1e-12


def compute_speed_profile(path: PathData, c: SpeedProfileConstraints,
                          solver: SolverConfig | None = None) -> PathData:
    """Returns a new PathData with ``v_ref`` filled in."""
    n = path.n_wp
    N = n - 1
    kappa = path.kappa[:N]
    # distance to the next waypoint (reference: Waypoint.__sub__ gather,
    # reference_path.py:319)
    li = path.seg_dist[:N]

    v_max_dyn = jnp.minimum(c.v_max, jnp.sqrt(c.ay_max / (jnp.abs(kappa) + _EPS)))

    # D1: forward-difference acceleration rows (N-1, N)
    rows = jnp.arange(N - 1)
    D1 = jnp.zeros((N - 1, N), jnp.float32)
    D1 = D1.at[rows, rows].set(-1.0 / (2.0 * li[:-1]))
    D1 = D1.at[rows, rows + 1].set(1.0 / (2.0 * li[:-1]))

    A = jnp.vstack([D1, jnp.eye(N, dtype=jnp.float32)])
    l = jnp.concatenate([jnp.full((N - 1,), c.a_min, jnp.float32),
                         jnp.full((N,), c.v_min, jnp.float32)])
    u = jnp.concatenate([jnp.full((N - 1,), c.a_max, jnp.float32), v_max_dyn])

    P = jnp.eye(N, dtype=jnp.float32)
    q = -v_max_dyn

    cfg = solver or SolverConfig(iterations=100, rho_updates=8)
    res = admm_solve_jit(P, q, A, l, u, cfg)

    v_ref = jnp.concatenate([res.x, res.x[-1:]])
    return path.replace(v_ref=v_ref.astype(path.x.dtype))
