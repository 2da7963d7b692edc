"""Structured ADMM solver for the horizon-N LTV-MPC QP (the hot path).

The reference assembles a scipy.sparse QP and hands it to OSQP every control
step (reference: MPC.py:128-159).  The QP's structure is *fixed* — only the
values of the stage matrices and bounds change (SURVEY.md §3.2):

    variables  z = [x_0..x_N | u_0..u_{N-1}],  nx = 3, nu = 2
    equality   -x_0 = -x0_meas;  A_n x_n + B_n u_n - x_{n+1} = uq_n
    inequality identity bounds on every variable (e_y corridor + input boxes)
    cost       P = blockdiag(Q x N, QN, R x N) (diagonal), q from corridor
               center-line and (v_ref, kappa_ref)

This module never materializes the 153x153 matrices.  Variables are grouped
per stage w_n = (x_n, u_n) in R^5 (x_N padded to 5), which makes the ADMM
reduced KKT matrix

    M = P + sigma I + rho_eq Aeq' Aeq + rho_in I

**block tridiagonal** with 5x5 blocks.  M is factorized by a block LU
(Schur-complement recursion) in one ``lax.scan`` over the N+1 stages, and
each ADMM iteration applies two stage scans (forward/backward substitution)
plus elementwise work — everything batches cleanly over a fleet axis under
``vmap`` (4096 lanes = batched (B, 5, 5) ops).

Complexity per solve: O(N) 5x5 factorizations + iters * O(N) 5x5 matvecs —
versus O((N nx)^3) for a dense factor.  This is the array-program equivalent
of exploiting OSQP's sparse KKT factorization (SURVEY.md §7 shift #2).  On a
GPU the same algorithm runs fused in one kernel (:mod:`.admm_kernel`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from multi_purpose_mpc_tpu.config import SolverConfig
from multi_purpose_mpc_tpu.ops import admm as admm_mod
from multi_purpose_mpc_tpu.ops.linalg import HIGHEST, mv
from multi_purpose_mpc_tpu.utils import pytree

NX = 3
NU = 2
NW = NX + NU  # stage width


@pytree.dataclass
class LTVQP:
    """One LTV-MPC QP instance (leading fleet axes allowed on every field).

    Mirrors the data the reference pours into scipy.sparse each step
    (MPC.py:61-155): stage dynamics, equality offsets, diagonal costs,
    linear cost from references, and per-variable bounds.
    """

    A: jnp.ndarray  # (N, 3, 3) stage transition
    B: jnp.ndarray  # (N, 3, 2) stage input
    beq: jnp.ndarray  # (N+1, 3) equality rhs: [-x0_meas, uq_0..uq_{N-1}]
    q_x: jnp.ndarray  # (N+1, 3) linear cost on states
    q_u: jnp.ndarray  # (N, 2) linear cost on inputs
    P_x: jnp.ndarray  # (N+1, 3) diagonal quadratic cost on states (Q, QN)
    P_u: jnp.ndarray  # (N, 2) diagonal quadratic cost on inputs (R)
    lx: jnp.ndarray  # (N+1, 3) state lower bounds
    ux: jnp.ndarray  # (N+1, 3) state upper bounds
    lu: jnp.ndarray  # (N, 2) input lower bounds
    uu: jnp.ndarray  # (N, 2) input upper bounds

    @property
    def N(self) -> int:
        return self.B.shape[-3]


@pytree.dataclass
class SolverCarry:
    """Complete ADMM iterate, persisted across control steps per lane.

    Consecutive MPC QPs differ by one path step, so warm-starting the primal,
    slack AND dual iterates (plus the adapted rho) cuts required iterations by
    an order of magnitude on tight active sets — the persistent-solver
    capability OSQP offers but the reference's per-step ``setup()`` forfeits
    (MPC.py:157-159, SURVEY.md §7 shift #2).
    """

    X: jnp.ndarray  # (N+1, 3)
    U: jnp.ndarray  # (N, 2)
    Zx: jnp.ndarray  # (N+1, 3)
    Zu: jnp.ndarray  # (N, 2)
    Yeq: jnp.ndarray  # (N+1, 3)
    Yx: jnp.ndarray  # (N+1, 3)
    Yu: jnp.ndarray  # (N, 2)
    rho: jnp.ndarray  # () adapted step size


def init_solver_carry(N: int, rho0: float = 0.1) -> SolverCarry:
    f32 = jnp.float32
    return SolverCarry(
        X=jnp.zeros((N + 1, NX), f32), U=jnp.zeros((N, NU), f32),
        Zx=jnp.zeros((N + 1, NX), f32), Zu=jnp.zeros((N, NU), f32),
        Yeq=jnp.zeros((N + 1, NX), f32), Yx=jnp.zeros((N + 1, NX), f32),
        Yu=jnp.zeros((N, NU), f32), rho=jnp.asarray(rho0, f32))


class LTVSolution(NamedTuple):
    X: jnp.ndarray  # (N+1, 3) primal states
    U: jnp.ndarray  # (N, 2) primal inputs
    status: jnp.ndarray  # () int32 — admm.SOLVED / MAX_ITER / DIVERGED
    r_prim: jnp.ndarray  # () inf-norm primal residual
    r_dual: jnp.ndarray  # () inf-norm dual residual
    carry: "SolverCarry" = None  # final iterate for the next step's warm start


# ---------------------------------------------------------------------------
# Constraint operators (never materialize Aeq)
# ---------------------------------------------------------------------------

def eq_apply(qp: LTVQP, X, U):
    """r = Aeq z: r_0 = -x_0, r_{n+1} = A_n x_n + B_n u_n - x_{n+1}."""
    r0 = -X[..., 0:1, :]
    rn = (mv(qp.A, X[..., :-1, :]) + mv(qp.B, U) - X[..., 1:, :])
    return jnp.concatenate([r0, rn], axis=-2)


def eq_applyT(qp: LTVQP, W):
    """(gx, gu) = Aeq' w for w in equality-row space (N+1, 3)."""
    w_next = W[..., 1:, :]  # rows 1..N pair with stages 0..N-1
    gx_head = -W[..., :-1, :] + jnp.einsum("...nij,...ni->...nj", qp.A, w_next,
                                           precision=HIGHEST)
    gx_tail = -W[..., -1:, :]
    gx = jnp.concatenate([gx_head, gx_tail], axis=-2)
    gu = jnp.einsum("...nij,...ni->...nj", qp.B, w_next, precision=HIGHEST)
    return gx, gu


# ---------------------------------------------------------------------------
# Block-tridiagonal factorization of the reduced KKT matrix
# ---------------------------------------------------------------------------

def _build_blocks(qp: LTVQP, rho_eq, rho_x, rho_u, sigma):
    """Diagonal blocks D_n and sub-diagonal blocks C_n of M in stage space.

    D_n (n < N) = [[Qd + s + diag(rho_x_n) + re (I + A_n'A_n),  re A_n'B_n],
                   [re B_n'A_n,  Rd + s + diag(rho_u_n) + re B_n'B_n]]
    D_N = diag(QNd + s + rho_x_N + re) padded to 5x5 with identity
    C_n = rows(stage n+1) x cols(stage n): [[-re A_n, -re B_n], [0, 0]]

    ``rho_x`` (N+1, 3) / ``rho_u`` (N, 2): per-row step sizes for the
    identity (box) constraints — equality-like rows (l == u) and polish-
    boosted active rows carry larger values, like OSQP's rho vector.
    """
    N = qp.N
    dtype = qp.A.dtype
    AtA = jnp.einsum("...nki,...nkj->...nij", qp.A, qp.A, precision=HIGHEST)
    AtB = jnp.einsum("...nki,...nkj->...nij", qp.A, qp.B, precision=HIGHEST)
    BtB = jnp.einsum("...nki,...nkj->...nij", qp.B, qp.B, precision=HIGHEST)

    batch = qp.A.shape[:-3]
    D = jnp.zeros(batch + (N + 1, NW, NW), dtype)
    eye3 = jnp.eye(NX, dtype=dtype)

    def embed_diag(v, n):
        return jnp.einsum("...i,ij->...ij", v, jnp.eye(n, dtype=dtype))

    # stages 0..N-1
    xx = (rho_eq * (eye3 + AtA)
          + embed_diag(sigma + rho_x[..., :-1, :] + qp.P_x[..., :-1, :], NX))
    uu = (rho_eq * BtB + embed_diag(sigma + rho_u + qp.P_u, NU))
    xu = rho_eq * AtB
    D = D.at[..., :-1, :NX, :NX].set(xx)
    D = D.at[..., :-1, :NX, NX:].set(xu)
    D = D.at[..., :-1, NX:, :NX].set(jnp.swapaxes(xu, -1, -2))
    D = D.at[..., :-1, NX:, NX:].set(uu)

    # terminal stage (x_N only; pad with identity so the 5x5 solve is benign)
    xxN = embed_diag(sigma + rho_eq + rho_x[..., -1, :] + qp.P_x[..., -1, :], NX)
    D = D.at[..., -1, :NX, :NX].set(xxN)
    D = D.at[..., -1, NX:, NX:].set(jnp.eye(NU, dtype=dtype))

    C = jnp.zeros(batch + (N, NW, NW), dtype)
    C = C.at[..., :, :NX, :NX].set(-rho_eq * qp.A)
    C = C.at[..., :, :NX, NX:].set(-rho_eq * qp.B)
    return D, C


def _factor(D, C):
    """Schur recursion S_0 = D_0, S_n = D_n - C_{n-1} S_{n-1}^-1 C_{n-1}'.

    Returns per-stage inverses Sinv (the factor used by the substitutions).
    Runs as a scan over stages; under vmap this becomes batched 5x5 ops.
    """

    def step(S_prev_inv, DC):
        Dn, Cn = DC
        G = jnp.matmul(Cn, S_prev_inv, precision=HIGHEST)
        S = Dn - jnp.matmul(G, jnp.swapaxes(Cn, -1, -2), precision=HIGHEST)
        Sinv = jnp.linalg.inv(S)
        return Sinv, Sinv

    S0_inv = jnp.linalg.inv(D[..., 0, :, :])
    _, Sinv_rest = jax.lax.scan(
        lambda carry, dc: step(carry, dc),
        S0_inv,
        (jnp.moveaxis(D[..., 1:, :, :], -3, 0), jnp.moveaxis(C, -3, 0)),
    )
    Sinv = jnp.concatenate([S0_inv[None], Sinv_rest], axis=0)
    return jnp.moveaxis(Sinv, 0, -3)  # (..., N+1, 5, 5)


def _solve(Sinv, C, b):
    """Solve M w = b given the Schur factors: forward then backward scan."""
    bs = jnp.moveaxis(b, -2, 0)  # (N+1, ..., 5)
    Cs = jnp.moveaxis(C, -3, 0)  # (N, ..., 5, 5)
    Ss = jnp.moveaxis(Sinv, -3, 0)  # (N+1, ..., 5, 5)

    def fwd(v_prev, inp):
        bn, Cn, Sn_prev = inp
        v = bn - mv(jnp.matmul(Cn, Sn_prev, precision=HIGHEST), v_prev)
        return v, v

    v0 = bs[0]
    _, v_rest = jax.lax.scan(fwd, v0, (bs[1:], Cs, Ss[:-1]))
    v = jnp.concatenate([v0[None], v_rest], axis=0)

    def bwd(w_next, inp):
        vn, Sn, Cn = inp
        w = mv(Sn, vn - mv(jnp.swapaxes(Cn, -1, -2), w_next))
        return w, w

    wN = mv(Ss[-1], v[-1])
    _, w_rest = jax.lax.scan(bwd, wN, (v[:-1], Ss[:-1], Cs), reverse=True)
    w = jnp.concatenate([w_rest, wN[None]], axis=0)
    return jnp.moveaxis(w, 0, -2)  # (..., N+1, 5)


# ---------------------------------------------------------------------------
# ADMM on the structured problem
# ---------------------------------------------------------------------------


def _pack_stages(X, U):
    # (N+1, 5): stage n -> (x_n, u_n), u_N slot zero-padded
    Upad = jnp.concatenate([U, jnp.zeros_like(U[..., :1, :])], axis=-2)
    return jnp.concatenate([X, Upad], axis=-1)


def _unpack_stages(W):
    return W[..., :NX], W[..., :-1, NX:]


def admm_iteration(qp: LTVQP, Sinv, C, rho_eq, rho_x, rho_u, sigma, alpha,
                   state):
    """One ADMM iteration on the factored stage system — THE iteration body
    of both the XLA solver below and (algorithmically) the GPU kernel
    (:mod:`.admm_kernel`).  Module-level so tools/flop_count.py can count
    exactly the production body.
    """
    X, U, Zx, Zu, Yeq, Yx, Yu = state
    # rhs = sigma z - q + A'(rho o z_c - y)
    weq = rho_eq * qp.beq - Yeq
    gx_eq, gu_eq = eq_applyT(qp, weq)
    rx = sigma * X - qp.q_x + gx_eq + (rho_x * Zx - Yx)
    ru = sigma * U - qp.q_u + gu_eq + (rho_u * Zu - Yu)
    W = _solve(Sinv, C, _pack_stages(rx, ru))
    Xt, Ut = _unpack_stages(W)

    Req = eq_apply(qp, Xt, Ut)
    Xn = alpha * Xt + (1 - alpha) * X
    Un = alpha * Ut + (1 - alpha) * U
    # eq rows: projection pins z to beq; dual accumulates violation
    Zeq_pre = alpha * Req + (1 - alpha) * qp.beq
    Yeq_n = Yeq + rho_eq * (Zeq_pre - qp.beq)
    # identity rows: box projection
    Zx_pre = alpha * Xt + (1 - alpha) * Zx
    Zu_pre = alpha * Ut + (1 - alpha) * Zu
    Zx_n = jnp.clip(Zx_pre + Yx / rho_x, qp.lx, qp.ux)
    Zu_n = jnp.clip(Zu_pre + Yu / rho_u, qp.lu, qp.uu)
    Yx_n = Yx + rho_x * (Zx_pre - Zx_n)
    Yu_n = Yu + rho_u * (Zu_pre - Zu_n)
    return Xn, Un, Zx_n, Zu_n, Yeq_n, Yx_n, Yu_n

def solve_ltv_qp(qp: LTVQP, cfg: SolverConfig,
                 X0: Optional[jnp.ndarray] = None,
                 U0: Optional[jnp.ndarray] = None,
                 warm: Optional[SolverCarry] = None) -> LTVSolution:
    """ADMM solve of one LTV-MPC QP (single lane; vmap for the fleet).

    Equality rows keep ``rho * rho_eq_scale``; the projection pins their
    z-block to ``beq`` exactly, so only the identity rows carry a box
    projection.  Fixed iteration counts; rho adapts between rounds with a
    refactorization (one extra stage scan), like OSQP.

    ``warm`` (preferred): a full :class:`SolverCarry` from the previous
    control step — primal + slack + dual + adapted rho.  ``X0``/``U0``:
    primal-only warm start (duals cold).
    """
    N = qp.N
    dtype = qp.A.dtype
    sigma = jnp.asarray(cfg.sigma, dtype)
    alpha = jnp.asarray(cfg.alpha, dtype)

    if warm is not None:
        X, U = warm.X, warm.U
        Zx = jnp.clip(warm.Zx, qp.lx, qp.ux)
        Zu = jnp.clip(warm.Zu, qp.lu, qp.uu)
        Yeq, Yx, Yu = warm.Yeq, warm.Yx, warm.Yu
        rho0 = (jnp.clip(warm.rho, 1e-6, 1e6) if cfg.carry_rho
                else jnp.asarray(cfg.rho, dtype))
    else:
        X = jnp.zeros((N + 1, NX), dtype) if X0 is None else X0
        U = jnp.zeros((N, NU), dtype) if U0 is None else U0
        # constraint-space iterates: eq block pinned, identity block boxed
        Zx = jnp.clip(X, qp.lx, qp.ux)
        Zu = jnp.clip(U, qp.lu, qp.uu)
        Yeq = jnp.zeros((N + 1, NX), dtype)
        Yx = jnp.zeros((N + 1, NX), dtype)
        Yu = jnp.zeros((N, NU), dtype)
        rho0 = jnp.asarray(cfg.rho, dtype)

    # per-row step sizes: equality-like box rows (l == u: the pinned x0 e_y
    # and collapsed-corridor rows) carry rho * rho_eq_scale like OSQP's rho
    # vector; polish boosts active rows further
    is_eq_x = (qp.ux - qp.lx) < 1e-9
    is_eq_u = (qp.uu - qp.lu) < 1e-9

    def rho_rows(rho_scalar, boost_x=None, boost_u=None):
        rx = jnp.where(is_eq_x, rho_scalar * cfg.rho_eq_scale, rho_scalar)
        ru = jnp.where(is_eq_u, rho_scalar * cfg.rho_eq_scale, rho_scalar)
        if boost_x is not None:
            rx = rx * boost_x
            ru = ru * boost_u
        return rx, ru

    def run_iters(iters, rho_scalar, state, boost_x=None, boost_u=None):
        X, U, Zx, Zu, Yeq, Yx, Yu = state
        rho_eq = rho_scalar * cfg.rho_eq_scale
        rho_x, rho_u = rho_rows(rho_scalar, boost_x, boost_u)
        D, C = _build_blocks(qp, rho_eq, rho_x, rho_u, sigma)
        Sinv = _factor(D, C)

        def body(_, state):
            return admm_iteration(qp, Sinv, C, rho_eq, rho_x, rho_u,
                                  sigma, alpha, state)

        return jax.lax.fori_loop(0, iters, body, (X, U, Zx, Zu, Yeq, Yx, Yu))

    def run_round(carry, _):
        (*state, rho_scalar) = carry
        X, U, Zx, Zu, Yeq, Yx, Yu = run_iters(cfg.iterations, rho_scalar,
                                              tuple(state))

        # adaptive rho from relative residuals
        Req = eq_apply(qp, X, U)
        rp_vec = jnp.maximum(jnp.max(jnp.abs(Req - qp.beq)),
                             jnp.maximum(jnp.max(jnp.abs(X - Zx)),
                                         jnp.max(jnp.abs(U - Zu))))
        gx_eq, gu_eq = eq_applyT(qp, Yeq)
        dx = qp.P_x * X + qp.q_x + gx_eq + Yx
        du = qp.P_u * U + qp.q_u + gu_eq + Yu
        rd_vec = jnp.maximum(jnp.max(jnp.abs(dx)), jnp.max(jnp.abs(du)))
        den_p = jnp.maximum(jnp.max(jnp.abs(Req)),
                            jnp.maximum(jnp.max(jnp.abs(X)), jnp.max(jnp.abs(U))))
        den_d = jnp.maximum(
            jnp.maximum(jnp.maximum(jnp.max(jnp.abs(qp.P_x * X)),
                                    jnp.max(jnp.abs(qp.P_u * U))),
                        jnp.maximum(jnp.max(jnp.abs(qp.q_x)),
                                    jnp.max(jnp.abs(qp.q_u)))),
            jnp.maximum(jnp.maximum(jnp.max(jnp.abs(gx_eq)),
                                    jnp.max(jnp.abs(gu_eq))), 1e-10))
        ratio = jnp.sqrt((rp_vec / jnp.maximum(den_p, 1e-10)) /
                         jnp.maximum(rd_vec / jnp.maximum(den_d, 1e-10), 1e-12))
        rho_new = jnp.clip(rho_scalar * ratio, 1e-6, 1e6)
        rho_new = jnp.where(jnp.isfinite(rho_new), rho_new, rho_scalar)
        return (X, U, Zx, Zu, Yeq, Yx, Yu, rho_new), None

    (X, U, Zx, Zu, Yeq, Yx, Yu, rho_out), _ = jax.lax.scan(
        run_round, (X, U, Zx, Zu, Yeq, Yx, Yu, rho0), None,
        length=max(cfg.rho_updates, 1))

    def primal_res(X, U, Zx, Zu):
        Req = eq_apply(qp, X, U)
        return jnp.maximum(
            jnp.max(jnp.abs(Req - qp.beq)),
            jnp.maximum(
                jnp.max(jnp.clip(qp.lx - X, 0, jnp.inf) + jnp.clip(X - qp.ux, 0, jnp.inf)),
                jnp.max(jnp.clip(qp.lu - U, 0, jnp.inf) + jnp.clip(U - qp.uu, 0, jnp.inf))))

    if cfg.polish_iters > 0:
        # Soft active-set polish: boost rho on rows at their (finite) bounds
        # and run a few extra iterations.  The polished iterate is only a
        # CANDIDATE — taken when it improves the primal residual; a wrong
        # active-set guess must neither degrade the answer nor poison the
        # next step's warm start (the carry below stays pre-polish either
        # way, selected by the same test).
        tol = 1e-4
        act_x = ((Zx <= qp.lx + tol) | (Zx >= qp.ux - tol)) & \
            jnp.isfinite(jnp.where(Zx <= qp.lx + tol, qp.lx, qp.ux))
        act_u = ((Zu <= qp.lu + tol) | (Zu >= qp.uu - tol)) & \
            jnp.isfinite(jnp.where(Zu <= qp.lu + tol, qp.lu, qp.uu))
        boost_x = jnp.where(act_x, cfg.polish_boost, 1.0)
        boost_u = jnp.where(act_u, cfg.polish_boost, 1.0)
        polished = run_iters(cfg.polish_iters, rho_out,
                             (X, U, Zx, Zu, Yeq, Yx, Yu),
                             boost_x=boost_x, boost_u=boost_u)
        rp_main = primal_res(X, U, Zx, Zu)
        rp_pol = primal_res(polished[0], polished[1], polished[2], polished[3])
        take = rp_pol < rp_main
        X, U, Zx, Zu, Yeq, Yx, Yu = jax.tree.map(
            lambda p, m: jnp.where(take, p, m),
            polished, (X, U, Zx, Zu, Yeq, Yx, Yu))

    # residuals / status (unscaled problem; per-lane values, never exceptions)
    Req = eq_apply(qp, X, U)
    r_prim = jnp.maximum(
        jnp.max(jnp.abs(Req - qp.beq)),
        jnp.maximum(jnp.max(jnp.clip(qp.lx - X, 0, jnp.inf) + jnp.clip(X - qp.ux, 0, jnp.inf)),
                    jnp.max(jnp.clip(qp.lu - U, 0, jnp.inf) + jnp.clip(U - qp.uu, 0, jnp.inf))))
    gx_eq, gu_eq = eq_applyT(qp, Yeq)
    dx = qp.P_x * X + qp.q_x + gx_eq + Yx
    du = qp.P_u * U + qp.q_u + gu_eq + Yu
    r_dual = jnp.maximum(jnp.max(jnp.abs(dx)), jnp.max(jnp.abs(du)))

    scale_p = jnp.maximum(jnp.max(jnp.abs(Req)),
                          jnp.maximum(jnp.max(jnp.abs(X)), jnp.max(jnp.abs(U))))
    scale_d = jnp.maximum(jnp.maximum(jnp.max(jnp.abs(qp.q_x)), jnp.max(jnp.abs(qp.q_u))),
                          jnp.maximum(jnp.max(jnp.abs(gx_eq)), jnp.max(jnp.abs(gu_eq))))
    eps_p = cfg.eps_abs + cfg.eps_rel * scale_p
    eps_d = cfg.eps_abs + cfg.eps_rel * scale_d

    finite = jnp.isfinite(X).all() & jnp.isfinite(U).all()
    converged = (r_prim <= eps_p) & (r_dual <= eps_d)
    status = jnp.where(~finite, admm_mod.DIVERGED,
                       jnp.where(converged, admm_mod.SOLVED,
                                 admm_mod.MAX_ITER)).astype(jnp.int32)
    # a diverged iterate must not poison the next step's warm start
    carry = SolverCarry(X=X, U=U, Zx=Zx, Zu=Zu, Yeq=Yeq, Yx=Yx, Yu=Yu,
                        rho=rho_out)
    carry = jax.tree.map(
        lambda a, z: jnp.where(finite, a, z),
        carry, init_solver_carry(N, cfg.rho))
    return LTVSolution(X=X, U=U, status=status, r_prim=r_prim, r_dual=r_dual,
                       carry=carry)


# ---------------------------------------------------------------------------
# Dense materialization (for cross-checks against the dense solver / oracle)
# ---------------------------------------------------------------------------

def materialize_dense(qp: LTVQP):
    """Build the dense (P, q, A, l, u) of this QP in the reference's variable
    order [x_0..x_N | u_0..u_{N-1}] (MPC.py:128-155).  Test/debug only."""
    import numpy as np

    N = qp.N
    n = NX * (N + 1) + NU * N
    A_np = np.asarray(qp.A)
    B_np = np.asarray(qp.B)

    Aeq = np.zeros((NX * (N + 1), n))
    for i in range(N + 1):
        Aeq[NX * i:NX * (i + 1), NX * i:NX * (i + 1)] = -np.eye(NX)
    for k in range(N):
        r = NX * (k + 1)
        Aeq[r:r + NX, NX * k:NX * (k + 1)] += A_np[k]
        Aeq[r:r + NX, NX * (N + 1) + NU * k:NX * (N + 1) + NU * (k + 1)] = B_np[k]

    A_full = np.vstack([Aeq, np.eye(n)])
    beq = np.asarray(qp.beq).reshape(-1)
    l = np.concatenate([beq, np.asarray(qp.lx).reshape(-1), np.asarray(qp.lu).reshape(-1)])
    u = np.concatenate([beq, np.asarray(qp.ux).reshape(-1), np.asarray(qp.uu).reshape(-1)])
    P = np.diag(np.concatenate([np.asarray(qp.P_x).reshape(-1),
                                np.asarray(qp.P_u).reshape(-1)]))
    q = np.concatenate([np.asarray(qp.q_x).reshape(-1), np.asarray(qp.q_u).reshape(-1)])
    return P, q, A_full, l, u
