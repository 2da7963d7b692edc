"""Batched on-device ADMM QP solver (the framework's OSQP replacement).

The reference outsources every QP to the OSQP C library and re-``setup``s a
fresh solver each control step (reference: MPC.py:157-159, 183;
reference_path.py:347-349).  This module implements the same
operator-splitting algorithm as a pure JAX program:

    minimize   1/2 z' P z + q' z
    subject to l <= A z <= u

with the full OSQP recipe — Ruiz equilibration, cost scaling, sigma-
regularized reduced-KKT iteration, over-relaxation, and periodic adaptive-rho
updates with refactorization:

    x~      = (P + sigma I + A' diag(rho) A)^-1 (sigma x - q + A'(rho*z - y))
    z~      = A x~
    x+      = alpha x~ + (1-alpha) x
    z+      = Pi_[l,u](alpha z~ + (1-alpha) z + y / rho)
    y+      = y + rho * (alpha z~ + (1-alpha) z - z+)

Design points (SURVEY.md §7 shift #2 and #3):

* **fixed iteration counts** — shape-static, so the whole solve jits and
  vmaps; convergence is a per-lane status *value* from residuals, never an
  exception;
* **equality rows** (l_i == u_i) get ``rho * rho_eq_scale``, which keeps the
  dynamics constraints tight (OSQP convention);
* all matmuls pin ``precision=HIGHEST`` — reduced-precision matmul passes
  shift the ADMM fixed point (measured ~5e-2 error on a benign QP);
* the KKT matrix is factorized once per rho update and reused across
  iterations — the thing OSQP was designed for but the reference's per-step
  ``setup()`` forfeits.

This dense version handles arbitrary QPs (it solves the speed-profile QP and
cross-checks the structured solver); the closed-loop hot path uses the
block-tridiagonal specialization in :mod:`multi_purpose_mpc_tpu.ops.ltv_qp`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from multi_purpose_mpc_tpu.config import SolverConfig
from multi_purpose_mpc_tpu.ops.linalg import mm, mtv, mv

# Status codes (per-lane values; the reference instead catches OSQP
# exceptions, MPC.py:185-216)
SOLVED = 0
MAX_ITER = 1  # finished without meeting tolerances — treated as infeasible
DIVERGED = 2  # non-finite iterates

_RHO_MIN = 1e-6
_RHO_MAX = 1e6


class ADMMResult(NamedTuple):
    x: jnp.ndarray  # (n,) primal solution
    z: jnp.ndarray  # (m,) constraint-space solution
    y: jnp.ndarray  # (m,) dual solution
    status: jnp.ndarray  # () int32
    r_prim: jnp.ndarray  # () float32 primal residual (inf-norm, unscaled)
    r_dual: jnp.ndarray  # () float32 dual residual (inf-norm, unscaled)


def _inf_norm(v, axis=None):
    return jnp.max(jnp.abs(v), axis=axis)


def ruiz_equilibrate(P, q, A, iters: int = 10):
    """Ruiz equilibration of the KKT block matrix [[P, A'], [A, 0]] plus
    OSQP's cost scaling.  Returns (Pb, qb, Ab, d, e, c) with
    ``Pb = c * D P D``, ``qb = c * D q``, ``Ab = E A D``.
    """
    n = P.shape[0]
    d = jnp.ones(n, P.dtype)
    e = jnp.ones(A.shape[0], P.dtype)

    def body(_, de):
        d, e = de
        Ps = d[:, None] * P * d[None, :]
        As = e[:, None] * A * d[None, :]
        # column norms of [[P],[A]] (length n) and of [[A'],[0]] (length m)
        cn = jnp.maximum(_inf_norm(Ps, axis=0), _inf_norm(As, axis=0))
        rn = _inf_norm(As, axis=1)
        d = d / jnp.sqrt(jnp.where(cn > 0, cn, 1.0))
        e = e / jnp.sqrt(jnp.where(rn > 0, rn, 1.0))
        return d, e

    d, e = jax.lax.fori_loop(0, iters, body, (d, e))
    Pb = d[:, None] * P * d[None, :]
    Ab = e[:, None] * A * d[None, :]
    qb = d * q

    # Cost scaling (OSQP): c = 1 / max(mean col-norm of Pb, ||qb||_inf)
    cnP = _inf_norm(Pb, axis=0)
    denom = jnp.maximum(jnp.mean(cnP), _inf_norm(qb))
    c = 1.0 / jnp.clip(denom, 1e-6, 1e6)
    return c * Pb, c * qb, Ab, d, e, c


def rho_vector(l: jnp.ndarray, u: jnp.ndarray, rho, cfg: SolverConfig) -> jnp.ndarray:
    """Per-constraint step size: equality rows get ``rho * rho_eq_scale``."""
    is_eq = (u - l) < 1e-9
    return jnp.where(is_eq, rho * cfg.rho_eq_scale, rho)


def admm_solve(P: jnp.ndarray, q: jnp.ndarray, A: jnp.ndarray, l: jnp.ndarray,
               u: jnp.ndarray, cfg: SolverConfig,
               x0: Optional[jnp.ndarray] = None,
               y0: Optional[jnp.ndarray] = None) -> ADMMResult:
    """Solve one dense QP; batch by ``vmap``-ing this function.

    Runs ``cfg.rho_updates`` rounds of ``cfg.iterations`` ADMM iterations;
    between rounds rho adapts from the primal/dual residual ratio and the
    reduced KKT matrix is refactorized (OSQP's adaptive-rho scheme, made
    shape-static).  ``x0``/``y0`` warm-start the iteration.
    """
    n = q.shape[0]
    dtype = q.dtype
    sigma = jnp.asarray(cfg.sigma, dtype)
    alpha = jnp.asarray(cfg.alpha, dtype)

    # --- scaling ---
    if cfg.scaling_iters > 0:
        Pb, qb, Ab, d, e, c = ruiz_equilibrate(P, q, A, cfg.scaling_iters)
        lb = e * l
        ub = e * u
    else:
        Pb, qb, Ab, lb, ub = P, q, A, l, u
        d = jnp.ones(n, dtype)
        e = jnp.ones(A.shape[0], dtype)
        c = jnp.asarray(1.0, dtype)
    # keep inf bounds inf under scaling (0 * inf -> nan guard)
    lb = jnp.where(jnp.isneginf(l), -jnp.inf, lb)
    ub = jnp.where(jnp.isposinf(u), jnp.inf, ub)

    x = jnp.zeros(n, dtype) if x0 is None else x0 / d
    y = jnp.zeros_like(lb) if y0 is None else y0 * c / e
    z = jnp.clip(mv(Ab, x), lb, ub)

    def run_round(carry, _):
        x, z, y, rho_scalar = carry
        rho = rho_vector(lb, ub, rho_scalar, cfg)
        M = Pb + sigma * jnp.eye(n, dtype=dtype) + mm(Ab.T * rho, Ab)
        L = jnp.linalg.cholesky(M)

        def kkt_solve(rhs):
            w = jax.scipy.linalg.solve_triangular(L, rhs, lower=True)
            return jax.scipy.linalg.solve_triangular(L.T, w, lower=False)

        def body(_, sxy):
            x, z, y = sxy
            rhs = sigma * x - qb + mtv(Ab, rho * z - y)
            x_t = kkt_solve(rhs)
            z_t = mv(Ab, x_t)
            x_n = alpha * x_t + (1.0 - alpha) * x
            z_pre = alpha * z_t + (1.0 - alpha) * z
            z_n = jnp.clip(z_pre + y / rho, lb, ub)
            y_n = y + rho * (z_pre - z_n)
            return x_n, z_n, y_n

        x, z, y = jax.lax.fori_loop(0, cfg.iterations, body, (x, z, y))

        # adaptive rho from scaled relative residuals (OSQP §5.2)
        Ax = mv(Ab, x)
        Px = mv(Pb, x)
        Aty = mtv(Ab, y)
        rp = _inf_norm(Ax - z) / jnp.maximum(
            jnp.maximum(_inf_norm(Ax), _inf_norm(z)), 1e-10)
        rd = _inf_norm(Px + qb + Aty) / jnp.maximum(
            jnp.maximum(_inf_norm(Px), jnp.maximum(_inf_norm(qb), _inf_norm(Aty))), 1e-10)
        ratio = jnp.sqrt(rp / jnp.maximum(rd, 1e-12))
        rho_new = jnp.clip(rho_scalar * ratio, _RHO_MIN, _RHO_MAX)
        rho_new = jnp.where(jnp.isfinite(rho_new), rho_new, rho_scalar)
        return (x, z, y, rho_new), None

    rho0 = jnp.asarray(cfg.rho, dtype)
    (x, z, y, _), _ = jax.lax.scan(run_round, (x, z, y, rho0), None,
                                   length=max(cfg.rho_updates, 1))

    # --- unscale and compute unscaled residuals / status ---
    x_u = d * x
    y_u = e * y / c
    z_u = z / e

    Ax = mv(A, x_u)
    Px = mv(P, x_u)
    Aty = mtv(A, y_u)
    r_prim = _inf_norm(Ax - z_u)
    r_dual = _inf_norm(Px + q + Aty)
    eps_p = cfg.eps_abs + cfg.eps_rel * jnp.maximum(_inf_norm(Ax), _inf_norm(z_u))
    eps_d = cfg.eps_abs + cfg.eps_rel * jnp.maximum(
        jnp.maximum(_inf_norm(Px), _inf_norm(q)), _inf_norm(Aty))

    finite = jnp.isfinite(x_u).all() & jnp.isfinite(y_u).all()
    converged = (r_prim <= eps_p) & (r_dual <= eps_d)
    status = jnp.where(~finite, DIVERGED,
                       jnp.where(converged, SOLVED, MAX_ITER)).astype(jnp.int32)
    return ADMMResult(x=x_u, z=z_u, y=y_u, status=status, r_prim=r_prim, r_dual=r_dual)


admm_solve_jit = jax.jit(admm_solve, static_argnames=("cfg",))
