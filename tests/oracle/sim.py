"""Float64 closed-loop oracle simulator.

Drives the same control law as the framework — localization, t2s, dynamic
corridor, LTV QP (dense, solved to 1e-10 by the float64 ADMM), infeasibility
replay, forward-Euler plant — entirely in loop-based numpy.  Consumes the
same PathData arrays as the JAX implementation so the comparison isolates
the controller/solver/corridor stack (geometry parity is tested separately).
"""

from __future__ import annotations

import math

import numpy as np

from tests.oracle.corridor import free_segments_oracle, select_corridor_oracle
from tests.oracle.qp import solve_qp_f64, solve_qp_ip_f64


def horizon_index(path, wp_id, k):
    """Circular wrap or non-circular clamp — the framework's
    gather_waypoint_index semantics (ops/path.py, SURVEY.md Q4; the
    reference hard-exits past the end instead, reference_path.py:366-369)."""
    n_wp = len(path["x"])
    i = wp_id + k
    return i % n_wp if path["circular"] else min(i, n_wp - 1)


def assemble_dense_qp(path, cfg, model, wp_id, e_y, e_psi, kappa_pred, ub, lb):
    """Dense float64 QP in the reference variable order (SURVEY.md §3.2)."""
    N = cfg.N
    nx, nu = 3, 2
    idx = [horizon_index(path, wp_id, k) for k in range(N)]

    A_st = np.zeros((N, 3, 3))
    B_st = np.zeros((N, 3, 2))
    f_st = np.zeros((N, 3))
    ur = np.zeros((N, 2))
    for k, i in enumerate(idx):
        v_ref = path["v_ref"][i]
        kap = path["kappa"][i]
        ds = path["seg_dist"][i]
        A_st[k] = [[1, ds, 0], [-kap ** 2 * ds, 1, 0], [-kap / v_ref * ds, 0, 1]]
        B_st[k] = [[0, 0], [0, ds], [-ds / v_ref ** 2, 0]]
        f_st[k] = [0, 0, ds / v_ref]
        ur[k] = [v_ref, kap]

    n = nx * (N + 1) + nu * N
    Aeq = np.zeros((nx * (N + 1), n))
    for i in range(N + 1):
        Aeq[nx * i:nx * i + nx, nx * i:nx * i + nx] = -np.eye(nx)
    for k in range(N):
        r = nx * (k + 1)
        Aeq[r:r + nx, nx * k:nx * k + nx] += A_st[k]
        Aeq[r:r + nx, nx * (N + 1) + nu * k:nx * (N + 1) + nu * (k + 1)] = B_st[k]
    A_full = np.vstack([Aeq, np.eye(n)])

    x0 = np.array([e_y, e_psi, 0.0])
    uq = np.einsum("nij,nj->ni", B_st, ur) - f_st
    beq = np.concatenate([-x0, uq.reshape(-1)])

    inf = np.inf
    lx = np.full((N + 1, 3), -inf)
    ux = np.full((N + 1, 3), inf)
    lx[0, 0] = e_y
    ux[0, 0] = e_y
    lx[1:, 0] = lb
    ux[1:, 0] = ub
    kmax = math.tan(cfg.delta_max) / model.length
    vmax_dyn = np.minimum(cfg.v_max, np.sqrt(cfg.ay_max / (np.abs(kappa_pred) + 1e-12)))
    lu = np.tile([cfg.v_min, -kmax], (N, 1))
    uu = np.stack([vmax_dyn, np.full(N, kmax)], -1)

    l = np.concatenate([beq, lx.reshape(-1), lu.reshape(-1)])
    u = np.concatenate([beq, ux.reshape(-1), uu.reshape(-1)])

    Qd = np.asarray(cfg.Q, np.float64)
    QNd = np.asarray(cfg.QN, np.float64)
    Rd = np.asarray(cfg.R, np.float64)
    P_diag = np.concatenate([np.tile(Qd, N), QNd, np.tile(Rd, N)])
    P = np.diag(P_diag)

    xr = np.zeros((N + 1, 3))
    xr[1:, 0] = (lb + ub) / 2
    q = np.concatenate([(-np.concatenate([np.tile(Qd, N), QNd]).reshape(N + 1, 3) * xr).reshape(-1),
                        (-Rd * ur).reshape(-1)])
    return P, q, A_full, l, u


def locate(path, s):
    cum = path["cum_len"]
    n = len(cum)
    if path["circular"]:
        s = s % path["length"]
    nxt = int(np.searchsorted(cum > s, True))
    nxt = min(max(nxt, 1), n - 1)
    prv = nxt - 1
    return nxt if abs(s - cum[nxt]) < abs(s - cum[prv]) else prv


def simulate_oracle(occ, origin, res, path, cfg, model, T, K=128, S=8,
                    qp_eps=1e-9, qp_max_iter=40000, progress=None,
                    qp_solver="admm", s0=0.0):
    """Run T closed-loop steps; returns per-step logs as a dict of arrays.

    ``qp_solver``: "admm" (first-order float64, the default historical
    oracle) or "ip" (primal-dual interior point, ~5000x faster at 1e-10 on
    strictly convex configs where the ADMM iteration conditions badly, e.g.
    Q2 > 0; the two agree to ~1e-7 where both converge).
    ``qp_eps``/``qp_max_iter`` apply to the admm solver.
    ``progress``: optional int — print a heartbeat every that-many steps.
    ``s0``: starting arc length (the pose starts on the path there) — lets
    seam tests begin near the end of a non-circular track."""
    N = cfg.N
    sm = model.safety_margin
    n_wp = len(path["x"])

    s = float(s0)
    wp0 = locate(path, s)
    x = path["x"][wp0]
    y = path["y"][wp0]
    psi = path["psi"][wp0]
    u_seq = np.zeros((N, 2))
    ic = 0
    xw = yw = None  # warm-start carries across steps

    logs = {k: [] for k in ("x", "y", "psi", "v", "delta", "s", "e_y",
                            "solved", "ub", "lb")}
    # pre-step controller state, for per-step parity tests that drive the
    # framework's step from the oracle's exact state (x, y, psi, s, u_seq,
    # infeasibility counter)
    logs["pre"] = []
    import sys as _sys
    import time as _time
    _t0 = _time.time()
    for t in range(T):
        if progress and t % progress == 0:
            print(f"oracle step {t}/{T} ({_time.time()-_t0:.0f}s)", flush=True)
        logs["pre"].append((x, y, psi, s, u_seq.copy(), ic))
        wp_id = locate(path, s)
        wx, wy, wpsi = path["x"][wp_id], path["y"][wp_id], path["psi"][wp_id]
        e_y = math.cos(wpsi) * (y - wy) - math.sin(wpsi) * (x - wx)
        e_psi = (psi - wpsi + math.pi) % (2 * math.pi) - math.pi

        idx = [horizon_index(path, wp_id, 1 + k) for k in range(N)]
        seg_list = [free_segments_oracle(occ, origin, res,
                                         path["border_ub"][i], path["border_lb"][i],
                                         2 * sm, K, S) for i in idx]
        prev_idx = [idx[0]] + idx[:-1]
        ub, lb, _ = select_corridor_oracle(
            path["x"][idx], path["y"][idx], path["psi"][idx],
            path["seg_dist"][prev_idx], path["psi"][prev_idx], seg_list, sm)

        kappa_prev = u_seq[:, 1]
        kappa_pred = kappa_prev[np.minimum(np.arange(N) + 1, N - 1)]

        # dynamics gather starts at wp_id (MPC.py:93); the corridor covers
        # wp_id+1..wp_id+N and lands on the x_1..x_N bounds (MPC.py:116-122)
        P, q, A_full, l, u = assemble_dense_qp(path, cfg, model, wp_id,
                                               e_y, e_psi, kappa_pred, ub, lb)
        if qp_solver == "ip":
            xs, _info = solve_qp_ip_f64(P, q, A_full, l, u)
            if max(_info["gap"], _info["r_dual"], _info["r_prim"]) > 1e-6:
                # Marginally infeasible instances (pinched corridor + pinned
                # x0) have no strictly feasible point; the IP stalls there by
                # construction, while ADMM converges to the least-violation
                # optimum (what OSQP — and the framework — return).  Fall
                # back to the high-accuracy first-order oracle, warm-started
                # from the IP iterate.  ~5 of 220 Sim_Track steps (measured).
                xs, _, _ = solve_qp_f64(P, q, A_full, l, u, eps=1e-8,
                                        x0=xs, max_iter=60000)
        else:
            xs, ys_, _ = solve_qp_f64(P, q, A_full, l, u, eps=qp_eps,
                                      x0=xw, y0=yw, max_iter=qp_max_iter)
            xw, yw = xs, ys_
        r_prim = np.max(np.maximum(A_full @ xs - u, 0) +
                        np.maximum(l - A_full @ xs, 0))
        # acceptance threshold mirrors the framework's (MPCConfig.feas_tol):
        # near obstacle pinch-points the corridor can make the QP genuinely
        # (near-)infeasible — the reference replays old controls there too
        solved = bool(r_prim < 5e-3) and np.isfinite(xs).all()

        if solved:
            U = xs[3 * (N + 1):].reshape(N, 2)
            u_seq = U.copy()
            v, kappa = U[0]
            ic = 0
        else:
            ridx = min(ic + 1, N - 1)
            v, kappa = u_seq[ridx]
            ic += 1
        delta = math.atan(kappa * model.length)

        # plant (forward Euler) — reference order: drive uses e_y/e_psi/wp
        # set by this control step (SURVEY.md §3.3)
        kap_wp = path["kappa"][wp_id]
        x += v * math.cos(psi) * model.Ts
        y += v * math.sin(psi) * model.Ts
        psi += v / model.length * math.tan(delta) * model.Ts
        s_dot = v * math.cos(e_psi) / (1.0 - e_y * kap_wp)
        s += s_dot * model.Ts

        for k, val in (("x", x), ("y", y), ("psi", psi), ("v", v),
                       ("delta", delta), ("s", s), ("e_y", e_y),
                       ("solved", solved), ("ub", ub.copy()), ("lb", lb.copy())):
            logs[k].append(val)
        if s >= path["length"]:
            break
    pre = logs.pop("pre")
    out = {k: np.asarray(v) for k, v in logs.items()}
    out["pre"] = pre
    return out


def path_to_dict(path) -> dict:
    """PathData pytree -> float64 numpy dict for the oracle."""
    return dict(
        x=np.asarray(path.x, np.float64),
        y=np.asarray(path.y, np.float64),
        psi=np.asarray(path.psi, np.float64),
        kappa=np.asarray(path.kappa, np.float64),
        v_ref=np.asarray(path.v_ref, np.float64),
        seg_dist=np.asarray(path.seg_dist, np.float64),
        cum_len=np.asarray(path.cum_len, np.float64),
        border_ub=np.asarray(path.border_ub, np.float64),
        border_lb=np.asarray(path.border_lb, np.float64),
        length=float(path.length),
        circular=bool(path.circular),
    )
