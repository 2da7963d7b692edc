"""Pallas (Triton) GPU kernel for the batched LTV-MPC ADMM solve.

Why a kernel: the XLA formulation (:func:`~.ltv_qp.solve_ltv_qp` under
``vmap``) is a chain of about 12,000 dependent stage-scan steps per control
step (6 rho rounds x (one 31-stage factor scan + 30 iterations x two
31-stage substitution scans) + the polish), each a handful of tiny
``(B, 5, 5)`` operations.  This kernel runs that whole chain — every rho
round, iteration and the polish — inside one launch: each program owns a
tile of lanes and walks the stage recursions in loops.

Layout: every array is lanes-last, ``(stages, channels, B)``, so the
per-stage load of one channel for a tile of lanes is one contiguous vector.
Each lane is one element of those vectors: the 5x5 stage algebra is written
as explicit multiply-adds over per-lane scalars (fp32 FMAs, no tensor cores
and therefore no TF32).  The stage factors, the forward-substitution vectors,
the per-row step sizes and a copy of the iterate live in a device-memory
workspace (two more outputs of the call, about 6.5 KB per lane at N=30),
which the L2 cache holds at fleet batch sizes; the ADMM iterate is updated in
place in the output buffer, which aliases the warm-start input.

Math is :func:`~.ltv_qp.solve_ltv_qp`'s, stage for stage: the same
block-tridiagonal Schur factorization (inverted in closed form by
Gauss-Jordan, :func:`_gj_inverse_5x5`), the same iteration, adaptive rho,
guarded polish and residuals.  Each backward-substitution step also applies
that stage's ADMM update, so an iteration makes two passes over the stages.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from multi_purpose_mpc_tpu.config import SolverConfig
from multi_purpose_mpc_tpu.ops import admm as admm_mod
from multi_purpose_mpc_tpu.ops.ltv_qp import (NU, NW, NX, LTVQP, LTVSolution,
                                              SolverCarry, init_solver_carry)

# Channel layout of the packed arrays (per stage n = 0..N; stage N's AB = 0
# and its u-slot is a free pad variable with zero cost).
_AB, _BEQ, _PD, _QV, _LW, _UW = 0, 15, 18, 23, 28, 33
N_DATA = 38
_W, _ZW, _YW, _YEQ = 0, 5, 10, 15
N_STATE = 18
_SINV, _V, _RW = 0, 25, 30
N_WORK = 35
N_STATS = 5  # rho, r_prim, r_dual, scale_p, scale_d

# Lanes per program: one warp.  Each lane's solve is one long sequential
# stage chain, and wider programs ran faster than more, narrower ones even
# below one program per multiprocessor (PERF.md, lane-tile measurement).
LANE_TILE = 32


def pad_lanes(tree, batch: int):
    """Pad every leaf's leading (lane) axis from ``batch`` to a multiple of
    :data:`LANE_TILE` with copies of lane 0 (a solvable QP, trimmed off)."""
    pad = (-batch) % LANE_TILE
    if not pad:
        return tree
    return jax.tree.map(lambda a: jnp.concatenate(
        [a, jnp.broadcast_to(a[:1], (pad,) + a.shape[1:])], axis=0), tree)


def _dot(a, b):
    acc = a[0] * b[0]
    for x, y in zip(a[1:], b[1:]):
        acc = acc + x * y
    return acc


def _mv(M, v):
    """Row-major (5*5) list @ 5-list."""
    return [_dot(M[NW * i:NW * (i + 1)], v) for i in range(NW)]


def _ab_v(AB, v):
    """[A|B] (3x5, row-major list) @ 5-list -> 3-list."""
    return [_dot(AB[NW * i:NW * (i + 1)], v) for i in range(NX)]


def _ab_t(AB, w):
    """[A|B]' @ 3-list -> 5-list."""
    return [_dot([AB[NW * i + j] for i in range(NX)], w) for j in range(NW)]


def _gj_inverse_5x5(S):
    """Gauss-Jordan inverse of per-lane 5x5 blocks given as a list of row
    lists.  No pivoting: the Schur complements are positive definite by
    construction (P + sigma I + rho A'A).  Returns a row-major flat list."""
    one = jnp.ones_like(S[0][0])
    zero = jnp.zeros_like(S[0][0])
    a = [list(r) for r in S]
    inv = [[one if i == j else zero for j in range(NW)] for i in range(NW)]
    for k in range(NW):
        piv = 1.0 / a[k][k]
        a[k] = [x * piv for x in a[k]]
        inv[k] = [x * piv for x in inv[k]]
        for i in range(NW):
            if i == k:
                continue
            f = a[i][k]
            a[i] = [x - f * y for x, y in zip(a[i], a[k])]
            inv[i] = [x - f * y for x, y in zip(inv[i], inv[k])]
    return [x for row in inv for x in row]


def _make_kernel(N: int, cfg: SolverConfig):
    sigma = cfg.sigma
    alpha = cfg.alpha
    eq_scale = cfg.rho_eq_scale
    R = max(cfg.rho_updates, 1)
    polish = cfg.polish_iters > 0

    def kernel(data, state0, rho0, state, stats, work, saved):
        del state0  # aliased with ``state``: the iterate is updated in place

        def ld(ref, n, k0, m):
            return [ref[n, k0 + i, :] for i in range(m)]

        def st(ref, n, k0, vals):
            for i, v in enumerate(vals):
                ref[n, k0 + i, :] = v

        def factor(rho, boost):
            """Schur recursion S_n = D_n - C_{n-1} S_{n-1}^-1 C_{n-1}'; stores
            S_n^-1 and the per-row step sizes (rows at a finite bound scaled
            by ``1 + boost``: the polish).  Also saves the iterate the round
            starts from (the polish keeps it where polishing does not help)."""
            rho_eq = rho * eq_scale

            def step(n, M):
                AB = ld(data, n, _AB, NX * NW)
                pd = ld(data, n, _PD, NW)
                lw = ld(data, n, _LW, NW)
                uw = ld(data, n, _UW, NW)
                zw = ld(state, n, _ZW, NW)
                rw = []
                for k in range(NW):
                    at_lo = zw[k] <= lw[k] + 1e-4
                    act = ((at_lo | (zw[k] >= uw[k] - 1e-4))
                           & jnp.isfinite(jnp.where(at_lo, lw[k], uw[k])))
                    r = jnp.where(uw[k] - lw[k] < 1e-9, rho * eq_scale, rho)
                    rw.append(r * (1.0 + act.astype(jnp.float32) * boost))
                st(work, n, _RW, rw)
                st(saved, n, 0, ld(state, n, 0, N_STATE))
                S = []
                for i in range(NW):
                    row = []
                    for j in range(NW):
                        s = rho_eq * _dot([AB[NW * k + i] for k in range(NX)],
                                          [AB[NW * k + j] for k in range(NX)])
                        if i == j:
                            s = s + (pd[i] + sigma + rw[i])
                            if i < NX:
                                s = s + rho_eq
                        if i < NX and j < NX:
                            s = s - M[NX * i + j]
                        row.append(s)
                    S.append(row)
                Sinv = _gj_inverse_5x5(S)
                st(work, n, _SINV, Sinv)
                # rho_eq^2 AB_n S_n^-1 AB_n': the next stage's Schur term
                T = [_mv(Sinv, [AB[NW * i + j] for j in range(NW)])
                     for i in range(NX)]
                r2 = rho_eq * rho_eq
                return [r2 * _dot(AB[NW * i:NW * (i + 1)], T[j])
                        for i in range(NX) for j in range(NX)]

            zero = jnp.zeros_like(rho)
            jax.lax.fori_loop(0, N + 1, step, [zero] * (NX * NX))

        def update_eq(m, req, rho_eq, scale=1.0):
            """Equality-row dual update of stage m from its residual
            (``scale`` 0 leaves the row as it is)."""
            beq = ld(data, m, _BEQ, NX)
            yeq = ld(state, m, _YEQ, NX)
            out = []
            for i in range(NX):
                zpre = alpha * req[i] + (1.0 - alpha) * beq[i]
                out.append(yeq[i] + scale * (rho_eq * (zpre - beq[i])))
            st(state, m, _YEQ, out)

        def iterate(rho):
            rho_eq = rho * eq_scale

            def fwd(n, t):
                n1 = jnp.minimum(n + 1, N)  # stage N's AB is zero
                AB = ld(data, n, _AB, NX * NW)
                weq = [rho_eq * b - y for b, y in
                       zip(ld(data, n, _BEQ, NX), ld(state, n, _YEQ, NX))]
                weq1 = [rho_eq * b - y for b, y in
                        zip(ld(data, n1, _BEQ, NX), ld(state, n1, _YEQ, NX))]
                g = _ab_t(AB, weq1)
                W = ld(state, n, _W, NW)
                Zw = ld(state, n, _ZW, NW)
                Yw = ld(state, n, _YW, NW)
                qv = ld(data, n, _QV, NW)
                rw = ld(work, n, _RW, NW)
                v = []
                for k in range(NW):
                    gk = g[k] - weq[k] if k < NX else g[k]
                    r = sigma * W[k] - qv[k] + gk + (rw[k] * Zw[k] - Yw[k])
                    v.append(r + t[k] if k < NX else r)
                st(work, n, _V, v)
                s = _mv(ld(work, n, _SINV, NW * NW), v)
                return [rho_eq * x for x in _ab_v(AB, s)]

            zero = jnp.zeros_like(rho)
            jax.lax.fori_loop(0, N + 1, fwd, [zero] * NX)

            def bwd(k, w_next):
                n = N - k
                AB = ld(data, n, _AB, NX * NW)
                c = _ab_t(AB, w_next[:NX])
                v = ld(work, n, _V, NW)
                w = _mv(ld(work, n, _SINV, NW * NW),
                        [vi + rho_eq * ci for vi, ci in zip(v, c)])
                # ADMM update of stage n's primal, box slack and box dual
                W = ld(state, n, _W, NW)
                Zw = ld(state, n, _ZW, NW)
                Yw = ld(state, n, _YW, NW)
                lw = ld(data, n, _LW, NW)
                uw = ld(data, n, _UW, NW)
                rw = ld(work, n, _RW, NW)
                Wn, Zn, Yn = [], [], []
                for i in range(NW):
                    Wn.append(alpha * w[i] + (1.0 - alpha) * W[i])
                    zpre = alpha * w[i] + (1.0 - alpha) * Zw[i]
                    z = jnp.clip(zpre + Yw[i] / rw[i], lw[i], uw[i])
                    Zn.append(z)
                    Yn.append(Yw[i] + rw[i] * (zpre - z))
                st(state, n, _W, Wn)
                st(state, n, _ZW, Zn)
                st(state, n, _YW, Yn)
                # equality row n+1: r = AB_n w_n - x_{n+1} (none past N)
                req = [a - b for a, b in zip(_ab_v(AB, w), w_next[:NX])]
                update_eq(jnp.minimum(n + 1, N), req, rho_eq,
                          scale=(n < N).astype(jnp.float32))
                return w

            w0 = jax.lax.fori_loop(0, N + 1, bwd, [zero] * NW)
            update_eq(0, [-x for x in w0[:NX]], rho_eq)

        def residuals():
            """Max-norm residual terms of the iterate: (r_prim vs slack,
            r_prim vs box, r_dual, scale_p, max|P w|, max|q|, max|A'y|)."""

            def step(n, c):
                abw, rp_z, rp_box, rd, den_p, pw_m, q_m, g_m = c
                n1 = jnp.minimum(n + 1, N)
                AB = ld(data, n, _AB, NX * NW)
                W = ld(state, n, _W, NW)
                Zw = ld(state, n, _ZW, NW)
                Yw = ld(state, n, _YW, NW)
                beq = ld(data, n, _BEQ, NX)
                pd = ld(data, n, _PD, NW)
                qv = ld(data, n, _QV, NW)
                lw = ld(data, n, _LW, NW)
                uw = ld(data, n, _UW, NW)
                yeq = ld(state, n, _YEQ, NX)
                g = _ab_t(AB, ld(state, n1, _YEQ, NX))
                for i in range(NX):
                    g[i] = g[i] - yeq[i]
                    req = abw[i] - W[i]  # r_0 = -x_0 (abw = 0 at n = 0)
                    e = jnp.abs(req - beq[i])
                    rp_z = jnp.maximum(rp_z, e)
                    rp_box = jnp.maximum(rp_box, e)
                    den_p = jnp.maximum(den_p, jnp.abs(req))
                for k in range(NW):
                    viol = (jnp.clip(lw[k] - W[k], 0.0, jnp.inf)
                            + jnp.clip(W[k] - uw[k], 0.0, jnp.inf))
                    rp_z = jnp.maximum(rp_z, jnp.abs(W[k] - Zw[k]))
                    rp_box = jnp.maximum(rp_box, viol)
                    pw = pd[k] * W[k]
                    rd = jnp.maximum(rd, jnp.abs(pw + qv[k] + g[k] + Yw[k]))
                    den_p = jnp.maximum(den_p, jnp.abs(W[k]))
                    pw_m = jnp.maximum(pw_m, jnp.abs(pw))
                    q_m = jnp.maximum(q_m, jnp.abs(qv[k]))
                    g_m = jnp.maximum(g_m, jnp.abs(g[k]))
                return (_ab_v(AB, W), rp_z, rp_box, rd, den_p, pw_m, q_m, g_m)

            zero = jnp.zeros_like(rho0[0, :])
            c = jax.lax.fori_loop(0, N + 1, step,
                                  ([zero] * NX,) + (zero,) * 7)
            return c[1:]

        def run_round(r, carry):
            """Rounds 0..R-1 adapt rho; round R (when polishing) is the
            guarded active-set polish of ltv_qp.solve_ltv_qp: boosted rho on
            rows at a finite bound, a few iterations, rho unchanged."""
            rho, _, last = carry
            # scalar selects do not lower to Triton: blend arithmetically
            is_polish = (r == R).astype(jnp.int32)
            factor(rho, is_polish.astype(jnp.float32) * (cfg.polish_boost
                                                         - 1.0))
            iters = cfg.iterations + is_polish * (cfg.polish_iters
                                                  - cfg.iterations)

            def body(_, c):
                iterate(rho)
                return c

            jax.lax.fori_loop(0, iters, body, 0)
            rp_z, rp_box, rd, den_p, pw_m, q_m, g_m = residuals()
            den_d = jnp.maximum(jnp.maximum(pw_m, q_m),
                                jnp.maximum(g_m, 1e-10))
            ratio = jnp.sqrt((rp_z / jnp.maximum(den_p, 1e-10))
                             / jnp.maximum(rd / den_d, 1e-12))
            rho_new = jnp.clip(rho * ratio, 1e-6, 1e6)
            polishing = jnp.zeros(rho.shape, jnp.int32) + is_polish > 0
            rho_new = jnp.where(jnp.isfinite(rho_new) & ~polishing, rho_new,
                                rho)
            # (r_prim, r_dual, scale_p, scale_d) of this round's iterate
            res = (rp_box, rd, den_p, jnp.maximum(q_m, g_m))
            return rho_new, last, res

        zero = jnp.zeros_like(rho0[0, :])
        empty = (zero,) * 4
        rho, main, res = jax.lax.fori_loop(0, R + polish, run_round,
                                           (rho0[0, :], empty, empty))
        if polish:
            # keep the polished iterate only where it lowers r_prim; the
            # pre-polish iterate is in ``saved``, its residuals in ``main``
            take = res[0] < main[0]

            def select(n, c):
                st(state, n, 0, [jnp.where(take, p, m) for p, m in zip(
                    ld(state, n, 0, N_STATE), ld(saved, n, 0, N_STATE))])
                return c

            jax.lax.fori_loop(0, N + 1, select, 0)
            res = [jnp.where(take, p, m) for p, m in zip(res, main)]
        for i, v in enumerate((rho,) + tuple(res)):
            stats[i, :] = v

    return kernel


def _pack_stages(x_part, u_part):
    """(B, N+1, 3) + (B, N, 2) -> (B, N+1, 5); stage N's u-slot zero."""
    u_pad = jnp.concatenate([u_part, jnp.zeros_like(u_part[:, :1])], axis=1)
    return jnp.concatenate([x_part, u_pad], axis=-1)


@functools.partial(jax.jit, static_argnames=("cfg", "interpret"))
def solve_ltv_qp_kernel(qp: LTVQP, warm: SolverCarry, cfg: SolverConfig,
                        interpret: bool = False) -> LTVSolution:
    """Batched solve, a drop-in for ``vmap(solve_ltv_qp)`` with a full warm
    start: ``qp`` and ``warm`` carry a leading batch axis B, which is padded
    to a multiple of :data:`LANE_TILE`.  ``interpret=True`` runs the kernel
    body in the Pallas interpreter (the CPU test path)."""
    B = qp.A.shape[0]
    N = qp.N
    L = LANE_TILE
    qp, warm = pad_lanes((qp, warm), B)
    Bp = qp.A.shape[0]

    AB = jnp.concatenate([qp.A, qp.B], axis=-1).reshape(Bp, N, NX * NW)
    AB = jnp.concatenate([AB, jnp.zeros_like(AB[:, :1])], axis=1)
    beq = qp.beq
    inf = jnp.full((Bp, 1, NU), jnp.inf, qp.lu.dtype)
    lw = _pack_stages(qp.lx, qp.lu).at[:, N:, NX:].set(-inf)
    uw = _pack_stages(qp.ux, qp.uu).at[:, N:, NX:].set(inf)
    data = jnp.concatenate([AB, beq, _pack_stages(qp.P_x, qp.P_u),
                            _pack_stages(qp.q_x, qp.q_u), lw, uw], axis=-1)
    zw0 = _pack_stages(jnp.clip(warm.Zx, qp.lx, qp.ux),
                       jnp.clip(warm.Zu, qp.lu, qp.uu))
    state0 = jnp.concatenate([_pack_stages(warm.X, warm.U), zw0,
                              _pack_stages(warm.Yx, warm.Yu), warm.Yeq],
                             axis=-1)
    lanes_last = lambda a: jnp.transpose(a, (1, 2, 0))
    if cfg.carry_rho:
        rho0 = jnp.clip(warm.rho, 1e-6, 1e6)
    else:
        rho0 = jnp.full((Bp,), cfg.rho, jnp.float32)

    f32 = jnp.float32
    stage_spec = lambda k: pl.BlockSpec((N + 1, k, L), lambda i: (0, 0, i))
    row_spec = lambda k: pl.BlockSpec((k, L), lambda i: (0, i))
    state, stats, _, _ = pl.pallas_call(
        _make_kernel(N, cfg),
        grid=(Bp // L,),
        in_specs=[stage_spec(N_DATA), stage_spec(N_STATE), row_spec(1)],
        out_specs=[stage_spec(N_STATE), row_spec(N_STATS),
                   stage_spec(N_WORK), stage_spec(N_STATE)],
        out_shape=[jax.ShapeDtypeStruct((N + 1, N_STATE, Bp), f32),
                   jax.ShapeDtypeStruct((N_STATS, Bp), f32),
                   jax.ShapeDtypeStruct((N + 1, N_WORK, Bp), f32),
                   jax.ShapeDtypeStruct((N + 1, N_STATE, Bp), f32)],
        input_output_aliases={1: 0},
        compiler_params=pl_triton.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="admm_ltv_qp",
    )(lanes_last(data), lanes_last(state0), rho0[None, :].astype(f32))

    state = jnp.transpose(state, (2, 0, 1))[:B]
    rho, r_prim, r_dual, scale_p, scale_d = stats[:, :B]
    X = state[..., _W:_W + NX]
    U = state[:, :-1, _W + NX:_W + NW]
    carry = SolverCarry(X=X, U=U, Zx=state[..., _ZW:_ZW + NX],
                        Zu=state[:, :-1, _ZW + NX:_ZW + NW],
                        Yeq=state[..., _YEQ:_YEQ + NX],
                        Yx=state[..., _YW:_YW + NX],
                        Yu=state[:, :-1, _YW + NX:_YW + NW], rho=rho)

    # status and warm-start reset exactly as solve_ltv_qp
    finite = jnp.isfinite(X).all(axis=(-2, -1)) & jnp.isfinite(U).all(
        axis=(-2, -1))
    eps_p = cfg.eps_abs + cfg.eps_rel * scale_p
    eps_d = cfg.eps_abs + cfg.eps_rel * scale_d
    converged = (r_prim <= eps_p) & (r_dual <= eps_d)
    status = jnp.where(~finite, admm_mod.DIVERGED,
                       jnp.where(converged, admm_mod.SOLVED,
                                 admm_mod.MAX_ITER)).astype(jnp.int32)
    fresh = init_solver_carry(N, cfg.rho)
    carry = jax.tree.map(
        lambda a, z: jnp.where(
            finite.reshape((-1,) + (1,) * (a.ndim - 1)), a, z[None]),
        carry, fresh)
    return LTVSolution(X=X, U=U, status=status, r_prim=r_prim,
                       r_dual=r_dual, carry=carry)
