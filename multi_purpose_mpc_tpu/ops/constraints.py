"""Dynamic drivable-corridor constraints (the reference_path.py:466-648 port).

Each control step the MPC needs, for every horizon waypoint, the upper/lower
e_y bounds of the drivable corridor, accounting for obstacles rasterized into
the occupancy grid.  The reference does this with Python loops over Bresenham
cell lists plus list-based segment bookkeeping; here it becomes two
shape-static stages (SURVEY.md §7 S5):

1. **Free-segment extraction** (:func:`free_segments`) — vmapped over the N
   horizon waypoints: sample K points along the scanline between the static
   border cells, find maximal free runs, return up to ``max_segments``
   candidates as world endpoints + valid mask (reference walks the cells and
   appends to a list: reference_path.py:466-520).

2. **Continuity selection** (:func:`select_corridor`) — a small ``lax.scan``
   over the horizon: step 0 takes the widest segment; step n projects the
   previously selected borders forward along the path and takes the candidate
   with the smallest mean endpoint offset; 0 candidates collapse the corridor
   to ub = lb = 0, signalling infeasibility to the QP
   (reference_path.py:535-648).

Deviation (documented, SURVEY.md Q2): the reference's forward-projection
applies cos(psi) to both coordinates of the upper border and sin(psi) to both
of the lower border (reference_path.py:559-562) — plainly a transcription
slip.  We implement the intended projection (delta_s * (cos psi, sin psi) for
both borders).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from multi_purpose_mpc_tpu.ops.grid import GridMap, m2w
from multi_purpose_mpc_tpu.ops.path import PathData, gather_waypoint_index, wrap_angle
from multi_purpose_mpc_tpu.ops.rays import sample_line


class SegmentCandidates(NamedTuple):
    ub_xy: jnp.ndarray  # (..., S, 2) world coords of upper (left) endpoints
    lb_xy: jnp.ndarray  # (..., S, 2) world coords of lower (right) endpoints
    valid: jnp.ndarray  # (..., S) bool


class Corridor(NamedTuple):
    ub: jnp.ndarray  # (..., N) upper e_y bound (safety margin applied)
    lb: jnp.ndarray  # (..., N) lower e_y bound
    border_ub: jnp.ndarray  # (..., N, 2) world border points (viz parity)
    border_lb: jnp.ndarray  # (..., N, 2)


def segments_from_samples(occ, cx, cy, min_width,
                          max_segments: int) -> SegmentCandidates:
    """Free segments from already-sampled scanline occupancy.

    ``occ`` (K,) occupancy at the samples (1=free, 0=occupied/OOB);
    ``cx``/``cy`` (K,) world coordinates of the sample cell centers.  Single
    scanline; vmap over horizon/path/fleet axes.  Endpoints follow the
    reference convention: the occupied (or border) cells *delimiting* a free
    run (reference_path.py:488-518), converted to world via cell centers.

    Shared by :func:`free_segments` (in-place gather) and the fleet-scale
    table-based extraction (:mod:`~multi_purpose_mpc_tpu.ops.corridor_extract`).

    Fully vectorized: run extraction and front-compaction use cumsum +
    one-hot reductions, not flatnonzero/gather — at fleet scale this runs
    B x N instances per step, where these (raw, K) masked reductions stay
    elementwise and fuse.
    """
    free = occ > 0.5  # (K,)
    K = occ.shape[-1]

    prev_free = jnp.concatenate([jnp.array([False]), free[:-1]])
    next_free = jnp.concatenate([free[1:], jnp.array([False])])
    starts = free & ~prev_free
    ends = free & ~next_free

    # Extract ALL runs first (a K-sample line has at most K//2 + 1 of them),
    # then width-filter and compact to max_segments — truncating raw runs
    # before filtering could drop passing segments behind narrow ones.
    raw = K // 2 + 1
    rs = jnp.cumsum(starts)  # run ordinal (1-based) at each start mark
    re_ = jnp.cumsum(ends)
    r_iota = jnp.arange(1, raw + 1)  # (raw,)
    k_iota = jnp.arange(K)
    sOH = starts[None, :] & (rs[None, :] == r_iota[:, None])  # (raw, K)
    eOH = ends[None, :] & (re_[None, :] == r_iota[:, None])
    start_idx = (sOH * k_iota[None, :]).sum(axis=1)
    end_idx = (eOH * k_iota[None, :]).sum(axis=1)
    valid = r_iota <= rs[-1]  # run exists

    # delimiting samples: one before the run start / one after the run end,
    # clamped at the scanline borders (matches the reference's init-at-border)
    ub_i = jnp.maximum(start_idx - 1, 0)
    lb_i = jnp.minimum(end_idx + 1, K - 1)

    uOH = ub_i[:, None] == k_iota[None, :]  # (raw, K)
    lOH = lb_i[:, None] == k_iota[None, :]
    ubx = (uOH * cx[None, :]).sum(axis=1)
    uby = (uOH * cy[None, :]).sum(axis=1)
    lbx = (lOH * cx[None, :]).sum(axis=1)
    lby = (lOH * cy[None, :]).sum(axis=1)

    width = jnp.hypot(ubx - lbx, uby - lby)
    valid = valid & (width > min_width)

    # Compact passing segments to the front, preserving order — the reference
    # appends only passing segments to its candidate list
    # (reference_path.py:509-512), and the selection logic indexes that list.
    pos = jnp.cumsum(valid) - 1  # output slot of each passing run
    s_iota = jnp.arange(max_segments)
    cOH = valid[None, :] & (pos[None, :] == s_iota[:, None])  # (S, raw)
    ub_xy = jnp.stack([(cOH * ubx[None, :]).sum(axis=1),
                       (cOH * uby[None, :]).sum(axis=1)], -1)
    lb_xy = jnp.stack([(cOH * lbx[None, :]).sum(axis=1),
                       (cOH * lby[None, :]).sum(axis=1)], -1)
    return SegmentCandidates(ub_xy=ub_xy, lb_xy=lb_xy, valid=cOH.any(axis=1))


def free_segments(grid: GridMap, p_ub, p_lb, min_width,
                  n_samples: int, max_segments: int) -> SegmentCandidates:
    """Free segments along the scanline from border point p_ub to p_lb.

    Single waypoint; vmap over a horizon/path axis.
    """
    s = sample_line(grid, p_ub[0], p_ub[1], p_lb[0], p_lb[1], n_samples)
    cx, cy = m2w(grid, s.px, s.py)
    return segments_from_samples(s.occ, cx, cy, min_width, max_segments)


def select_corridor(path: PathData, idx, segs: SegmentCandidates,
                    safety_margin) -> Corridor:
    """Continuity-based segment selection over the horizon (one lane).

    ``idx`` is the (N,) array of horizon waypoint indices;``segs`` the
    per-step candidates.  Returns per-step e_y bounds with the safety margin
    subtracted and the infeasibility collapse applied
    (reference_path.py:597-648).
    """
    wx = path.x[idx]
    wy = path.y[idx]
    wpsi = path.psi[idx]
    # distance from the previous horizon waypoint to this one, for projection
    prev_idx = jnp.concatenate([idx[:1], idx[:-1]])
    delta_s = path.seg_dist[prev_idx]
    prev_psi = path.psi[prev_idx]

    def step(carry, inp):
        ub_prev, lb_prev = carry  # previously selected border cells (world)
        n, ub_xy, lb_xy, valid, x, y, psi, ds, psi_prev = inp

        # --- candidate choice ---
        width = jnp.hypot(ub_xy[:, 0] - lb_xy[:, 0], ub_xy[:, 1] - lb_xy[:, 1])
        widest = jnp.argmax(jnp.where(valid, width, -jnp.inf))

        # intended forward projection of previous borders (SURVEY.md Q2)
        proj = ds * jnp.stack([jnp.cos(psi_prev), jnp.sin(psi_prev)])
        ub_pw = ub_prev + proj
        lb_pw = lb_prev + proj
        d_ub = jnp.hypot(ub_xy[:, 0] - ub_pw[0], ub_xy[:, 1] - ub_pw[1])
        d_lb = jnp.hypot(lb_xy[:, 0] - lb_pw[0], lb_xy[:, 1] - lb_pw[1])
        offset = (d_ub + d_lb) / 2.0
        closest = jnp.argmin(jnp.where(valid, offset, jnp.inf))

        sel = jnp.where(n == 0, widest, closest)
        any_valid = valid.any()
        ub_ls = jnp.where(any_valid, ub_xy[sel], jnp.stack([x, y]))
        lb_ls = jnp.where(any_valid, lb_xy[sel], jnp.stack([x, y]))

        # --- signed distances orthogonal to the path ---
        ang_ub = wrap_angle(jnp.arctan2(ub_ls[1] - y, ub_ls[0] - x) - psi)
        ang_lb = wrap_angle(jnp.arctan2(lb_ls[1] - y, lb_ls[0] - x) - psi)
        ub = jnp.sign(ang_ub) * jnp.hypot(ub_ls[0] - x, ub_ls[1] - y)
        lb = jnp.sign(ang_lb) * jnp.hypot(lb_ls[0] - x, lb_ls[1] - y)

        ub = ub - safety_margin
        lb = lb + safety_margin
        infeasible = ub < lb
        ub = jnp.where(infeasible, 0.0, ub)
        lb = jnp.where(infeasible, 0.0, lb)

        # border cells on the orthogonal line (reference_path.py:622-637):
        # *_sm carry the margin-reduced bounds (viz + QP), the carry cells
        # re-add the margin for the next step's projection
        a_ub = wrap_angle(psi + jnp.pi / 2.0)
        a_lb = wrap_angle(psi - jnp.pi / 2.0)
        dir_ub = jnp.stack([jnp.cos(a_ub), jnp.sin(a_ub)])
        dir_lb = jnp.stack([jnp.cos(a_lb), jnp.sin(a_lb)])
        cell_sm_ub = jnp.stack([x, y]) + ub * dir_ub
        cell_sm_lb = jnp.stack([x, y]) - lb * dir_lb
        cell_ub = jnp.stack([x, y]) + (ub + safety_margin) * dir_ub
        cell_lb = jnp.stack([x, y]) - (lb - safety_margin) * dir_lb

        return (cell_ub, cell_lb), (ub, lb, cell_sm_ub, cell_sm_lb)

    N = idx.shape[0]
    init = (jnp.zeros(2, wx.dtype), jnp.zeros(2, wx.dtype))
    xs = (jnp.arange(N), segs.ub_xy, segs.lb_xy, segs.valid, wx, wy, wpsi,
          delta_s, prev_psi)
    _, (ub, lb, cub, clb) = jax.lax.scan(step, init, xs)
    return Corridor(ub=ub, lb=lb, border_ub=cub, border_lb=clb)


def update_path_constraints(grid: GridMap, path: PathData, wp_id, N: int,
                            min_width, safety_margin,
                            n_samples: int = 128,
                            max_segments: int = 8) -> Corridor:
    """Full dynamic constraint update for one lane (reference MPC.py:116-118
    calls this with ``wp_id+1, N, 2*safety_margin, safety_margin``).

    Extracts free segments for the N horizon waypoints from the (possibly
    per-step-updated) grid, then runs the selection scan.  With a *static*
    grid prefer :func:`extract_all_segments` + :func:`corridor_from_segments`
    — extraction is lane- and time-independent there and can leave the hot
    loop entirely.
    """
    offs = jnp.arange(N)
    idx = gather_waypoint_index(path, wp_id, offs)

    p_ub = path.border_ub[idx]  # (N, 2)
    p_lb = path.border_lb[idx]

    segs = jax.vmap(
        lambda a, b: free_segments(grid, a, b, min_width, n_samples, max_segments)
    )(p_ub, p_lb)

    return select_corridor(path, idx, segs, safety_margin)


def extract_all_segments(grid: GridMap, path: PathData, min_width,
                         n_samples: int = 128,
                         max_segments: int = 8) -> SegmentCandidates:
    """Free segments for EVERY waypoint — the static-map precomputation.

    The per-waypoint extraction depends only on the grid and the static
    border cells, not on any lane state, so for a static map it runs once at
    setup (or once per map update) instead of N x B times per control step.
    Returns candidates with leading axis n_wp.
    """
    return jax.vmap(
        lambda a, b: free_segments(grid, a, b, min_width, n_samples, max_segments)
    )(path.border_ub, path.border_lb)


def corridor_from_segments(path: PathData, all_segs: SegmentCandidates,
                           wp_id, N: int, safety_margin) -> Corridor:
    """Hot-loop corridor update from precomputed candidates: gather the N
    horizon rows, then the continuity-selection scan (one lane; vmap for a
    fleet)."""
    offs = jnp.arange(N)
    idx = gather_waypoint_index(path, wp_id, offs)
    segs = SegmentCandidates(ub_xy=all_segs.ub_xy[idx],
                             lb_xy=all_segs.lb_xy[idx],
                             valid=all_segs.valid[idx])
    return select_corridor(path, idx, segs, safety_margin)
