"""Reference-path geometry as struct-of-arrays (the reference_path.py port).

The reference stores a Python list of ``Waypoint`` objects and loops over it
everywhere (reference_path.py:20-57, 99).  Here the whole path is one
:class:`PathData` pytree of ``(n_wp,)`` arrays, so horizon lookups become
gathers, width computation becomes a vmapped ray-march, and everything
downstream stays shape-static.

Construction from corner points runs once at setup.  The densify step has a
data-dependent waypoint count (reference_path.py:119-121), so construction is
host-side vectorized numpy; the result is uploaded once.  The occupancy-grid
width computation is a jitted jnp op (:func:`compute_static_width`).
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from multi_purpose_mpc_tpu.config import PathConfig
from multi_purpose_mpc_tpu.ops.grid import GridMap, m2w, w2m
from multi_purpose_mpc_tpu.ops.rays import first_occupied, sample_line
from multi_purpose_mpc_tpu.utils import pytree

EPS = 1e-12


def wrap_angle(a):
    """Wrap to (-pi, pi] — the reference's mod-based wrap (reference_path.py:187)."""
    return jnp.mod(a + jnp.pi, 2.0 * jnp.pi) - jnp.pi


def wrap_angle_np(a):
    return np.mod(a + np.pi, 2.0 * np.pi) - np.pi


@pytree.dataclass
class PathData:
    """Struct-of-arrays reference path (replaces Waypoint objects).

    All per-waypoint attributes of the reference's ``Waypoint``
    (reference_path.py:20-57) live here as ``(n_wp,)`` arrays; drivable-area
    border points are ``(n_wp, 2)`` world coordinates.
    """

    x: jnp.ndarray  # (n,) world x
    y: jnp.ndarray  # (n,) world y
    psi: jnp.ndarray  # (n,) heading
    kappa: jnp.ndarray  # (n,) curvature
    v_ref: jnp.ndarray  # (n,) speed profile reference velocity
    lb: jnp.ndarray  # (n,) static lower (right) drivable bound, <= 0
    ub: jnp.ndarray  # (n,) static upper (left) drivable bound, >= 0
    border_ub: jnp.ndarray  # (n, 2) world coords of left border point
    border_lb: jnp.ndarray  # (n, 2) world coords of right border point
    seg_len: jnp.ndarray  # (n,) [0, d(0,1), ..., d(n-2,n-1)]  (ref: reference_path.py:201)
    cum_len: jnp.ndarray  # (n,) cumulative seg_len
    seg_dist: jnp.ndarray  # (n,) d(i, i+1) with wrap/clamp — horizon delta_s gather
    length: jnp.ndarray  # () total center-line length
    circular: bool = pytree.field(static=True, default=False)

    @property
    def n_wp(self) -> int:
        return self.x.shape[0]


def densify_and_smooth(wp_x, wp_y, resolution: float, smoothing_distance: int):
    """Corner points -> dense smoothed center-line coordinates.

    Replicates the reference pipeline exactly (reference_path.py:110-146):
    per-segment ``linspace`` at ``resolution`` m/wp with ``endpoint=False``
    plus the final goal point, then a +/- ``smoothing_distance`` moving
    average that shortens the list by ``2 * smoothing_distance`` points.
    """
    wp_x = np.asarray(wp_x, np.float64)
    wp_y = np.asarray(wp_y, np.float64)
    seg_d = np.hypot(np.diff(wp_x), np.diff(wp_y))
    n_wp = (seg_d / resolution).astype(int)

    xs = [np.linspace(wp_x[i], wp_x[i + 1], n_wp[i], endpoint=False) for i in range(len(wp_x) - 1)]
    ys = [np.linspace(wp_y[i], wp_y[i + 1], n_wp[i], endpoint=False) for i in range(len(wp_y) - 1)]
    gx = np.concatenate(xs + [wp_x[-1:]])
    gy = np.concatenate(ys + [wp_y[-1:]])

    sd = smoothing_distance
    if sd > 0:
        win = 2 * sd + 1
        kernel = np.ones(win) / win
        gx = np.convolve(gx, kernel, mode="valid")
        gy = np.convolve(gy, kernel, mode="valid")
    return gx, gy


def headings_and_curvature(gx: np.ndarray, gy: np.ndarray):
    """Per-waypoint psi / kappa (reference: reference_path.py:148-193).

    The last densified point only serves as the look-ahead for the previous
    one and is dropped (reference_path.py:161); kappa of the first waypoint
    is pinned to 0 (reference_path.py:181-182).
    """
    dx = np.diff(gx)
    dy = np.diff(gy)
    psi = np.arctan2(dy, dx)  # (n-1,)
    dist_ahead = np.hypot(dx, dy)
    dpsi = wrap_angle_np(psi[1:] - psi[:-1])
    kappa = np.concatenate([[0.0], dpsi / (dist_ahead[1:] + EPS)])
    return gx[:-1], gy[:-1], psi, kappa


def path_lengths(x: np.ndarray, y: np.ndarray, circular: bool):
    """seg_len / cum_len / seg_dist / total length (reference_path.py:195-204).

    ``seg_dist[i]`` is the euclidean distance from waypoint i to its horizon
    successor — the ``delta_s`` the MPC gathers per horizon step
    (reference: MPC.py:95 via Waypoint.__sub__).  Circular paths wrap across
    the seam; non-circular paths repeat the final segment so clamped horizon
    lookups stay well-conditioned (the reference instead hard-exits at end of
    path, reference_path.py:366-369 — see SURVEY.md Q4).
    """
    d = np.hypot(np.diff(x), np.diff(y))
    seg_len = np.concatenate([[0.0], d])
    cum_len = np.cumsum(seg_len)
    if circular:
        seam = math.hypot(x[0] - x[-1], y[0] - y[-1])
        seg_dist = np.concatenate([d, [seam]])
    else:
        seg_dist = np.concatenate([d, [d[-1]]])
    return seg_len, cum_len, seg_dist, float(cum_len[-1])


def compute_static_width(grid: GridMap, x, y, psi, max_width: float,
                         n_ray_samples: int = 128):
    """Static drivable width left/right of the center-line via ray-march.

    Array reformulation of the reference's 9-target Bresenham walk
    (reference_path.py:206-287): for each waypoint and each side, march rays
    from the waypoint toward the point ``max_width`` along the orthogonal
    direction — one ray per 3x3 pixel-neighborhood target, matching the
    reference's discretization-robustness trick — and take the minimum
    distance from the waypoint to the first occupied cell's *center*.

    Returns ``(ub, lb, border_ub, border_lb)`` with the reference sign
    convention ``lb = -right_width`` (reference_path.py:237).
    """
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    psi = jnp.asarray(psi, jnp.float32)

    def side_width(wx, wy, wpsi, side_sign):
        angle = wrap_angle(wpsi + side_sign * (jnp.pi / 2.0))
        tx = wx + max_width * jnp.cos(angle)
        ty = wy + max_width * jnp.sin(angle)
        # 3x3 neighborhood of the target cell, as world points of cell centers
        tpx, tpy = w2m_pair(grid, tx, ty)
        offs = jnp.arange(-1, 2)
        ox, oy = jnp.meshgrid(offs, offs, indexing="ij")
        ntx, nty = m2w(grid, tpx + ox.reshape(-1), tpy + oy.reshape(-1))  # (9,)

        samples = sample_line(grid, wx, wy, ntx, nty, n_ray_samples)  # (9, K)
        hit, idx = first_occupied(samples)  # (9,)
        hx, hy = m2w(grid,
                     jnp.take_along_axis(samples.px, idx[:, None], axis=-1)[:, 0],
                     jnp.take_along_axis(samples.py, idx[:, None], axis=-1)[:, 0])
        d = jnp.hypot(wx - hx, wy - hy)
        d = jnp.where(hit, d, jnp.inf)
        best = jnp.argmin(d)
        width = jnp.minimum(d[best], max_width)
        any_hit = hit.any() & (d[best] < max_width)
        bx = jnp.where(any_hit, hx[best], tx)
        by = jnp.where(any_hit, hy[best], ty)
        return width, bx, by

    ub, ubx, uby = jax.vmap(lambda a, b, c: side_width(a, b, c, +1.0))(x, y, psi)
    rw, lbx, lby = jax.vmap(lambda a, b, c: side_width(a, b, c, -1.0))(x, y, psi)
    lb = -rw  # center-line convention (reference_path.py:237)
    return ub, lb, jnp.stack([ubx, uby], -1), jnp.stack([lbx, lby], -1)


def w2m_pair(grid: GridMap, x, y):
    px, py = w2m(grid, x, y)
    return px, py


compute_static_width_jit = jax.jit(compute_static_width, static_argnames=("max_width", "n_ray_samples"))


def build_reference_path(grid: GridMap, cfg: PathConfig) -> PathData:
    """Full setup pipeline: corner points -> PathData with static bounds.

    Mirrors ``ReferencePath.__init__`` (reference_path.py:99-108): densify,
    smooth, psi/kappa, lengths, then static drivable width on-device.
    ``v_ref`` is zero until :func:`...ops.speed_profile.compute_speed_profile`
    fills it (reference computes it separately too, simulation.py:119).
    """
    gx, gy = densify_and_smooth(cfg.wp_x, cfg.wp_y, cfg.resolution, cfg.smoothing_distance)
    px, py, psi, kappa = headings_and_curvature(gx, gy)
    seg_len, cum_len, seg_dist, length = path_lengths(px, py, cfg.circular)

    xj = jnp.asarray(px, jnp.float32)
    yj = jnp.asarray(py, jnp.float32)
    psij = jnp.asarray(psi, jnp.float32)

    ub, lb, border_ub, border_lb = compute_static_width_jit(
        grid, xj, yj, psij, max_width=cfg.max_width, n_ray_samples=cfg.n_ray_samples)

    return PathData(
        x=xj,
        y=yj,
        psi=psij,
        kappa=jnp.asarray(kappa, jnp.float32),
        v_ref=jnp.zeros_like(xj),
        lb=lb,
        ub=ub,
        border_ub=border_ub,
        border_lb=border_lb,
        seg_len=jnp.asarray(seg_len, jnp.float32),
        cum_len=jnp.asarray(cum_len, jnp.float32),
        seg_dist=jnp.asarray(seg_dist, jnp.float32),
        length=jnp.asarray(length, jnp.float32),
        circular=cfg.circular,
    )


def gather_waypoint_index(path: PathData, wp_id, offset):
    """Horizon index resolution: circular wrap or clamp (reference_path.py:356-371).

    The reference hard-exits past the end of a non-circular path
    (reference_path.py:366-369); lanes in a fleet can't, so indices clamp and
    the caller's done-mask takes over (SURVEY.md Q4).
    """
    idx = wp_id + offset
    n = path.n_wp
    if path.circular:
        return jnp.mod(idx, n)
    return jnp.clip(idx, 0, n - 1)
