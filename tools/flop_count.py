"""FLOP counts of the headline solver, from traced jaxprs (device-free).

The MPC stage math is 5x5-block fp32 work, so a roofline for the solver is
set by the fp32 (non-tensor-core) rate and memory bandwidth of the device;
this tool supplies the numerator: the FLOPs one production solve and one
ADMM iteration perform per lane, counted from the XLA reference solver's
jaxpr (the GPU kernel runs the same algorithm, stage for stage).

    python tools/flop_count.py      # one JSON line
"""

from __future__ import annotations

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAPS = os.path.join(REPO, "assets", "maps")
sys.path.insert(0, REPO)


# -- jaxpr FLOP counter ------------------------------------------------------
# 1 flop per element per arithmetic primitive, 2*b*m*n*k for dot_general,
# scan bodies multiplied by their static trip count.  Comparisons, selects
# and copies count zero: the number is a FLOP count, not an instruction
# count.

_EW1 = {"add", "sub", "mul", "div", "neg", "abs", "max", "min", "exp",
        "log", "sqrt", "rsqrt", "tanh", "logistic", "sign", "floor",
        "ceil", "round", "sin", "cos", "pow", "atan2", "rem", "square",
        "erf", "expm1", "log1p"}

_REDUCE = {"reduce_sum", "reduce_max", "reduce_min", "reduce_prod",
           "cumsum", "cumlogsumexp", "cummax", "cummin", "argmax", "argmin"}


def _aval_size(aval) -> float:
    return float(np.prod(aval.shape)) if aval.shape else 1.0


def _count_jaxpr(jaxpr) -> float:
    total = 0.0
    for eqn in jaxpr.eqns:
        p = eqn.primitive.name
        params = eqn.params
        if p in ("pjit", "closed_call", "custom_jvp_call", "custom_vjp_call",
                 "remat", "checkpoint", "custom_vjp_call_jaxpr"):
            inner = params.get("jaxpr") or params.get("call_jaxpr")
            if inner is None:
                continue
            total += _count_jaxpr(getattr(inner, "jaxpr", inner))
        elif p == "scan":
            total += params["length"] * _count_jaxpr(params["jaxpr"].jaxpr)
        elif p == "while":
            # no static trip count: count ONE pass (documented lower bound;
            # the solver bodies under measurement use scan/fori only)
            total += _count_jaxpr(params["body_jaxpr"].jaxpr)
        elif p == "cond":
            total += max(_count_jaxpr(b.jaxpr) for b in params["branches"])
        elif p in _EW1:
            total += _aval_size(eqn.outvars[0].aval)
        elif p == "clamp":
            total += 2.0 * _aval_size(eqn.outvars[0].aval)
        elif p == "integer_pow":
            total += max(params["y"] - 1, 1) * _aval_size(eqn.outvars[0].aval)
        elif p == "dot_general":
            (lc, rc), (lb, _rb) = params["dimension_numbers"]
            lhs = eqn.invars[0].aval
            rhs = eqn.invars[1].aval
            m = np.prod([lhs.shape[i] for i in range(lhs.ndim)
                         if i not in set(lc) | set(lb)] or [1.0])
            n = np.prod([rhs.shape[i] for i in range(rhs.ndim)
                         if i not in set(rc) | set(lb)] or [1.0])
            k = np.prod([lhs.shape[i] for i in lc] or [1.0])
            b = np.prod([lhs.shape[i] for i in lb] or [1.0])
            total += 2.0 * b * m * n * k
        elif p in _REDUCE:
            total += _aval_size(eqn.invars[0].aval)
    return total


def _scenario(batch: int):
    from multi_purpose_mpc_tpu.config import sim_track_preset
    from multi_purpose_mpc_tpu.models.bicycle import init_car_state
    from multi_purpose_mpc_tpu.mpc import mpc_corridor, mpc_locate, mpc_pre_solve
    from multi_purpose_mpc_tpu.ops.constraints import extract_all_segments
    from multi_purpose_mpc_tpu.ops.path import build_reference_path
    from multi_purpose_mpc_tpu.ops.speed_profile import compute_speed_profile
    from multi_purpose_mpc_tpu.utils.maps import add_obstacles_host, load_grid_map

    map_cfg, path_cfg, model_cfg, cfg, speed_cfg, obstacles = (
        sim_track_preset(asset_dir=MAPS))
    grid = load_grid_map(map_cfg)
    path = build_reference_path(grid, path_cfg)
    grid = add_obstacles_host(grid, map_cfg.origin, map_cfg.resolution,
                              obstacles)
    path = compute_speed_profile(path, speed_cfg)
    segs = extract_all_segments(grid, path, 2 * model_cfg.safety_margin,
                                n_samples=cfg.n_scan_samples,
                                max_segments=cfg.max_segments)
    rng = np.random.default_rng(3)
    e0 = jnp.asarray(rng.uniform(-0.02, 0.02, batch), jnp.float32)
    wp0 = jnp.asarray((np.arange(batch) * 7) % path.n_wp, jnp.int32)
    states = jax.vmap(lambda e, w: init_car_state(path, cfg.N, e_y=e, wp_id=w)
                      )(e0, wp0)
    located = jax.vmap(lambda s: mpc_locate(s, path))(states)
    cor = jax.vmap(lambda w: mpc_corridor(w, path, grid, cfg, model_cfg,
                                          segs))(located[0])
    qp, _ = jax.vmap(lambda s, loc, c: mpc_pre_solve(
        s, path, grid, cfg, model_cfg, segs, located=loc, corridor=c))(
        states, located, cor)
    return qp, states.solver, cfg


def count_iteration_flops():
    """Per-iteration FLOPs per lane of the production iteration body:
    ``ltv_qp.admm_iteration`` is the exact body the XLA solver loops over
    (and algorithmically what the GPU kernel runs)."""
    from multi_purpose_mpc_tpu.ops.ltv_qp import (_build_blocks, _factor,
                                                  admm_iteration)

    qp, warm, cfg = _scenario(1)
    qp = jax.tree.map(lambda a: a[0], qp)  # single lane
    base = cfg.solver
    sigma = jnp.float32(base.sigma)
    alpha = jnp.float32(base.alpha)
    rho = jnp.float32(base.rho)
    rho_eq = rho * base.rho_eq_scale
    is_eq_x = (qp.ux - qp.lx) < 1e-9
    is_eq_u = (qp.uu - qp.lu) < 1e-9
    rho_x = jnp.where(is_eq_x, rho_eq, rho)
    rho_u = jnp.where(is_eq_u, rho_eq, rho)
    D, C = _build_blocks(qp, rho_eq, rho_x, rho_u, sigma)
    Sinv = _factor(D, C)
    N = qp.N
    state = (jnp.zeros((N + 1, 3)), jnp.zeros((N, 2)),
             jnp.zeros((N + 1, 3)), jnp.zeros((N, 2)),
             jnp.zeros((N + 1, 3)), jnp.zeros((N + 1, 3)),
             jnp.zeros((N, 2)))

    jpr = jax.make_jaxpr(
        lambda st: admm_iteration(qp, Sinv, C, rho_eq, rho_x, rho_u,
                                  sigma, alpha, st))(state)
    return dict(iter_flops_per_lane=_count_jaxpr(jpr.jaxpr))


def count_solve_flops():
    """FLOPs per lane of one production solve (factorizations x rho rounds,
    every iteration, the polish and the residual passes) of the XLA
    reference solver, whose loops all have static trip counts."""
    from multi_purpose_mpc_tpu.ops.ltv_qp import solve_ltv_qp

    qp, warm, cfg = _scenario(1)
    qp = jax.tree.map(lambda a: a[0], qp)
    warm = jax.tree.map(lambda a: a[0], warm)
    jpr = jax.make_jaxpr(lambda q, w: solve_ltv_qp(q, cfg.solver, warm=w))(
        qp, warm)
    return dict(solve_flops_per_lane=_count_jaxpr(jpr.jaxpr))


def main():
    print(json.dumps({**count_solve_flops(), **count_iteration_flops()}))


if __name__ == "__main__":
    main()
