"""Spatial bicycle model as pure array functions (the
spatial_bicycle_models.py port).

The reference wraps mutable state objects with ``__iadd__`` Euler updates and
per-call Python branching (reference: spatial_bicycle_models.py:25-109,
155-244).  Here the complete per-lane simulator state is one flat
:class:`CarState` pytree and every model op is a pure function of
``(state, inputs) -> state`` that vmaps over a fleet axis and scans over time.

Model recap (reference: spatial_bicycle_models.py:322-417, README Lima et
al. formulation):

* temporal (world) state: pose ``(x, y, psi)``;
* spatial (Frenet-style) state relative to a path waypoint:
  ``(e_y, e_psi, t)`` — time is a *state*, which is what makes time-optimal
  driving a weight choice (SURVEY.md §2.1 row 5);
* plant input ``u = (v, delta)`` (speed, steering angle); the *QP* input is
  ``(v, kappa)`` (speed, curvature), converted via ``delta = atan(kappa L)``
  (reference: MPC.py:188-189).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from multi_purpose_mpc_tpu.ops.ltv_qp import SolverCarry, init_solver_carry
from multi_purpose_mpc_tpu.ops.path import PathData, gather_waypoint_index, wrap_angle
from multi_purpose_mpc_tpu.utils import pytree


@pytree.dataclass
class CarState:
    """Complete per-lane closed-loop state (fleet axis prepended under vmap).

    Covers everything the reference scatters across the model, MPC and driver
    objects: pose, path progress, cached spatial state, the cached control
    sequence used for infeasibility replay (reference: MPC.py:52-56), and the
    per-lane status flags that replace the reference's ``exit(1)`` calls
    (SURVEY.md §5 failure-detection note).
    """

    # Temporal (world) state — reference TemporalState (spatial_bicycle_models.py:25-46)
    x: jnp.ndarray
    y: jnp.ndarray
    psi: jnp.ndarray
    # Progress along the reference path
    s: jnp.ndarray
    wp_id: jnp.ndarray  # int32
    # Spatial state at the current waypoint — SimpleSpatialState (e_y, e_psi, t)
    e_y: jnp.ndarray
    e_psi: jnp.ndarray
    # Cached N-step control sequence (v_0, kappa_0, ..., v_{N-1}, kappa_{N-1})
    # for infeasibility replay (reference: MPC.py:56, 208-216).
    u_seq: jnp.ndarray  # (N * 2,)
    # Persistent ADMM iterate (primal/slack/dual/rho) — the warm start the
    # reference forfeits by re-setup-ing OSQP every step (MPC.py:157-159).
    solver: SolverCarry
    infeasibility_count: jnp.ndarray  # int32 consecutive failures
    done: jnp.ndarray  # bool: reached end of path
    failed: jnp.ndarray  # bool: N-1 consecutive infeasible solves (ref exit(1))


def init_car_state(path: PathData, N: int, e_y: float = 0.0, e_psi: float = 0.0,
                   wp_id: int = 0) -> CarState:
    """Initial state on the path (reference places the car at waypoint 0 with
    zero spatial error: spatial_bicycle_models.py:144-153, 338-345)."""
    wp = jnp.asarray(wp_id, jnp.int32)
    psi0 = path.psi[wp] + e_psi
    x0 = path.x[wp] - e_y * jnp.sin(path.psi[wp])
    y0 = path.y[wp] + e_y * jnp.cos(path.psi[wp])
    f32 = jnp.float32
    # Seed the replay cache with the local speed profile: a lane whose very
    # first QP is infeasible (Monte-Carlo starts can spawn at corridor
    # pinches) then replays gentle forward motion instead of freezing at
    # v = 0 and dying after N-1 failures.  The reference seeds zeros
    # (MPC.py:56) but only ever starts from the clean pose at waypoint 0.
    u_seed = jnp.zeros((N, 2), f32).at[:, 0].set(
        path.v_ref[gather_waypoint_index(path, wp, jnp.arange(N))])
    return CarState(
        x=jnp.asarray(x0, f32),
        y=jnp.asarray(y0, f32),
        psi=jnp.asarray(psi0, f32),
        s=jnp.asarray(path.cum_len[wp], f32),
        wp_id=wp,
        e_y=jnp.asarray(e_y, f32),
        e_psi=jnp.asarray(e_psi, f32),
        u_seq=u_seed.reshape(-1),
        solver=init_solver_carry(N),
        infeasibility_count=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False, bool),
        failed=jnp.asarray(False, bool),
    )


# ---------------------------------------------------------------------------
# Frame transforms (reference: spatial_bicycle_models.py:155-219)
# ---------------------------------------------------------------------------

def s2t(path: PathData, wp_id, e_y, e_psi):
    """Spatial -> temporal: world pose from path-relative error state
    (reference: spatial_bicycle_models.py:155-181)."""
    wx = path.x[wp_id]
    wy = path.y[wp_id]
    wpsi = path.psi[wp_id]
    x = wx - e_y * jnp.sin(wpsi)
    y = wy + e_y * jnp.cos(wpsi)
    psi = wpsi + e_psi
    return x, y, psi


def t2s(path: PathData, wp_id, x, y, psi):
    """Temporal -> spatial: path-relative error state from world pose, with
    e_psi wrapped to (-pi, pi] (reference: spatial_bicycle_models.py:183-219).
    The time state resets to 0 — it only spans the MPC horizon."""
    wx = path.x[wp_id]
    wy = path.y[wp_id]
    wpsi = path.psi[wp_id]
    e_y = jnp.cos(wpsi) * (y - wy) - jnp.sin(wpsi) * (x - wx)
    e_psi = wrap_angle(psi - wpsi)
    return e_y, e_psi


# ---------------------------------------------------------------------------
# Localization on the path (reference: spatial_bicycle_models.py:256-279)
# ---------------------------------------------------------------------------

def locate_waypoint(path: PathData, s):
    """Nearest waypoint by traveled distance: searchsorted over cumulative
    segment lengths, then pick the closer of the two enclosing waypoints
    (reference: spatial_bicycle_models.py:262-279).  Out-of-range ``s`` clamps
    instead of indexing out of bounds (SURVEY.md Q4); circular paths wrap."""
    n = path.n_wp
    if path.circular:
        s = jnp.mod(s, path.length)
    next_id = jnp.searchsorted(path.cum_len, s, side="right")
    next_id = jnp.clip(next_id, 1, n - 1)
    prev_id = next_id - 1
    d_next = jnp.abs(s - path.cum_len[next_id])
    d_prev = jnp.abs(s - path.cum_len[prev_id])
    return jnp.where(d_next < d_prev, next_id, prev_id).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Nonlinear plant (reference: spatial_bicycle_models.py:221-244, 347-366)
# ---------------------------------------------------------------------------

def drive(state: CarState, path: PathData, v, delta, length: float, Ts: float) -> CarState:
    """One forward-Euler step of the true nonlinear kinematic bicycle.

    World pose integrates xdot = v cos psi, ydot = v sin psi,
    psidot = v/L tan delta (reference: spatial_bicycle_models.py:231-237);
    path progress integrates sdot = v cos(e_psi) / (1 - e_y kappa)
    (reference: spatial_bicycle_models.py:240-244) using the *current*
    spatial state and waypoint, exactly like the reference (which reads the
    values set by the previous ``get_control``, SURVEY.md §3.3).
    """
    x = state.x + v * jnp.cos(state.psi) * Ts
    y = state.y + v * jnp.sin(state.psi) * Ts
    psi = state.psi + v / length * jnp.tan(delta) * Ts
    kappa = path.kappa[state.wp_id]
    s_dot = v * jnp.cos(state.e_psi) / (1.0 - state.e_y * kappa)
    s = state.s + s_dot * Ts
    return state.replace(x=x, y=y, psi=psi, s=s)


def spatial_derivatives(e_y, e_psi, v, delta, kappa, length: float):
    """Spatial-domain derivatives d(e_y, e_psi, t)/ds
    (reference: spatial_bicycle_models.py:368-389)."""
    s_dot = v * jnp.cos(e_psi) / (1.0 - e_y * kappa)
    psi_dot = v / length * jnp.tan(delta)
    return jnp.stack([
        v * jnp.sin(e_psi) / s_dot,
        psi_dot / s_dot - kappa,
        1.0 / s_dot,
    ])


# ---------------------------------------------------------------------------
# LTV linearization (reference: spatial_bicycle_models.py:391-417)
# ---------------------------------------------------------------------------

def linearize(v_ref, kappa_ref, delta_s):
    """Exact LTV triple (f, A, B) of the spatial model around the reference.

    Vectorizes over any leading shape (the MPC evaluates all N horizon steps
    at once).  Matches reference spatial_bicycle_models.py:404-417::

        A = [[1, ds, 0], [-k^2 ds, 1, 0], [-k/v ds, 0, 1]]
        B = [[0, 0], [0, ds], [-ds/v^2, 0]]
        f = [0, 0, ds/v]
    """
    v_ref = jnp.asarray(v_ref, jnp.float32)
    kappa_ref = jnp.asarray(kappa_ref, jnp.float32)
    delta_s = jnp.asarray(delta_s, jnp.float32)
    z = jnp.zeros_like(v_ref)
    o = jnp.ones_like(v_ref)

    A = jnp.stack([
        jnp.stack([o, delta_s, z], -1),
        jnp.stack([-(kappa_ref ** 2) * delta_s, o, z], -1),
        jnp.stack([-kappa_ref / v_ref * delta_s, z, o], -1),
    ], -2)
    B = jnp.stack([
        jnp.stack([z, z], -1),
        jnp.stack([z, delta_s], -1),
        jnp.stack([-delta_s / (v_ref ** 2), z], -1),
    ], -2)
    f = jnp.stack([z, z, delta_s / v_ref], -1)
    return f, A, B


def horizon_linearize(path: PathData, wp_id, N: int):
    """Gather waypoint data and linearize the whole N-step horizon at once.

    Replaces the reference's per-step Python loop over ``get_waypoint`` +
    ``linearize`` (reference: MPC.py:90-108).  Returns per-step
    ``(f, A, B, v_ref, kappa_ref, delta_s, idx)`` with leading axis N.
    """
    offs = jnp.arange(N)
    idx = gather_waypoint_index(path, wp_id, offs)  # (N,)
    v_ref = path.v_ref[idx]
    kappa_ref = path.kappa[idx]
    delta_s = path.seg_dist[idx]
    f, A, B = linearize(v_ref, kappa_ref, delta_s)
    return f, A, B, v_ref, kappa_ref, delta_s, idx
