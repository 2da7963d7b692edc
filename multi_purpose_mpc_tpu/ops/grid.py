"""Occupancy-grid map ops (the array equivalent of reference map.py).

The reference ``Map`` is a mutable object wrapping a numpy array that is
rasterized into with Python loops and fancy indexing (reference:
map.py:45-155).  Here the grid is an immutable device array inside a
:class:`GridMap` pytree and every op is a pure, shape-static jnp function —
coordinate transforms are vectorized over arbitrary point batches, and
obstacle / boundary rasterization build a *new* grid functionally so they can
run under ``jit`` (e.g. for online map updates from lidar).

Conventions (identical to the reference):
  * ``occ[y, x]`` indexing, row = y pixel, col = x pixel (map.py:110, 279)
  * 1 = free, 0 = occupied (map.py:109-110)
  * ``w2m``: world meters -> integer pixel via floor (map.py:77-88)
  * ``m2w``: pixel -> world coordinate of the *cell center* (map.py:90-101)
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from multi_purpose_mpc_tpu.utils import pytree


@pytree.dataclass
class GridMap:
    """Occupancy grid + metadata as a jit-able pytree.

    ``occ`` is float32 with 1.0 = free, 0.0 = occupied so that grid lookups
    stay elementwise float math without dtype churn; ``origin``/``resolution`` are
    device scalars so one compiled program serves any map of a given shape.
    """

    occ: jnp.ndarray  # (H, W) float32, 1=free 0=occupied
    origin: jnp.ndarray  # (2,) float32, world coords of pixel (0,0) corner
    resolution: jnp.ndarray  # () float32, m/px

    @property
    def height(self) -> int:
        return self.occ.shape[0]

    @property
    def width(self) -> int:
        return self.occ.shape[1]


def make_grid_map(occ, origin, resolution) -> GridMap:
    return GridMap(
        occ=jnp.asarray(occ, jnp.float32),
        origin=jnp.asarray(origin, jnp.float32),
        resolution=jnp.asarray(resolution, jnp.float32),
    )


def w2m(grid: GridMap, x, y) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """World -> map pixel indices, elementwise over any broadcastable shape.

    Matches the reference floor convention (map.py:85-86).  Returns int32.
    """
    dx = jnp.floor((jnp.asarray(x) - grid.origin[0]) / grid.resolution)
    dy = jnp.floor((jnp.asarray(y) - grid.origin[1]) / grid.resolution)
    return dx.astype(jnp.int32), dy.astype(jnp.int32)


def m2w(grid: GridMap, dx, dy) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Map pixel -> world coordinates of the cell center (map.py:98-99)."""
    x = (jnp.asarray(dx, jnp.float32) + 0.5) * grid.resolution + grid.origin[0]
    y = (jnp.asarray(dy, jnp.float32) + 0.5) * grid.resolution + grid.origin[1]
    return x, y


def lookup(grid: GridMap, px: jnp.ndarray, py: jnp.ndarray, oob_value: float = 0.0) -> jnp.ndarray:
    """Occupancy lookup at integer pixel coords with out-of-bounds handling.

    The reference indexes ``data[y, x]`` directly and relies on the track
    never leaving the image (reference_path.py:279); a fleet simulator cannot,
    so out-of-bounds reads return ``oob_value`` (default: occupied).
    """
    h, w = grid.occ.shape
    inb = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    pxc = jnp.clip(px, 0, w - 1)
    pyc = jnp.clip(py, 0, h - 1)
    vals = grid.occ[pyc, pxc]
    return jnp.where(inb, vals, oob_value)


def lookup_world(grid: GridMap, x, y, oob_value: float = 0.0) -> jnp.ndarray:
    """Occupancy lookup at world coordinates."""
    px, py = w2m(grid, x, y)
    return lookup(grid, px, py, oob_value)


def rasterize_disks_px(grid: GridMap, px, py, r_px, active=None) -> GridMap:
    """Rasterize pixel-space disks into a new grid (reference: map.py:129-137).

    Fully vectorized over both the grid and the disk list: computes, per
    cell, whether any active disk covers it.  The disk test replicates the
    reference's integer-pixel convention: the disk is centered on the cell
    index with the ``ogrid``-style offset window (offsets in ``[-r, r-1]``)
    and circle test ``offx^2 + offy^2 <= r^2``, so masks match the reference
    raster bit-for-bit given the same center pixels.

    ``active`` optionally masks disks on/off (shape-static dynamic obstacle
    sets for on-device scenario randomization).
    """
    px = jnp.atleast_1d(jnp.asarray(px, jnp.int32))
    py = jnp.atleast_1d(jnp.asarray(py, jnp.int32))
    r_px = jnp.atleast_1d(jnp.asarray(r_px, jnp.int32))
    if active is None:
        active = jnp.ones(px.shape, bool)
    active = jnp.atleast_1d(active)

    h, w = grid.occ.shape
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)

    def one(px_k, py_k, r_k, on_k):
        offx = xs - px_k
        offy = ys - py_k
        in_window = (offx >= -r_k) & (offx < r_k) & (offy >= -r_k) & (offy < r_k)
        in_disk = (offx * offx + offy * offy) <= r_k * r_k
        return in_window & in_disk & on_k

    covered = jax.vmap(one)(px, py, r_px, active).any(axis=0)
    return grid.replace(occ=jnp.where(covered, 0.0, grid.occ))


def add_obstacles(grid: GridMap, cx, cy, radius, active=None) -> GridMap:
    """Rasterize circular world-space obstacles (reference: map.py:116-137).

    Jit-able path for *on-device* obstacle injection.  Caveat: ``w2m`` here
    runs in float32, and scenario coordinates that land exactly on cell
    boundaries (common — configs use multiples of the resolution) can round
    to the neighboring cell relative to the reference's float64 numpy.  For
    bit-exact setup-time parity, compute center pixels on the host in float64
    and call :func:`rasterize_disks_px` directly (the API layer does this).
    """
    cx = jnp.atleast_1d(jnp.asarray(cx, jnp.float32))
    cy = jnp.atleast_1d(jnp.asarray(cy, jnp.float32))
    radius = jnp.atleast_1d(jnp.asarray(radius, jnp.float32))
    r_px = jnp.ceil(radius / grid.resolution).astype(jnp.int32)
    px, py = w2m(grid, cx, cy)
    return rasterize_disks_px(grid, px, py, r_px, active)


def add_boundary(grid: GridMap, start_xy, end_xy, n_samples: int = 1024) -> GridMap:
    """Rasterize line boundaries into a new grid (reference: map.py:139-155).

    The reference marks every ``line_aa`` cell between the endpoints as
    occupied; here each segment is sampled at ``n_samples`` evenly spaced
    points (shape-static) and the hit cells are scattered to 0.  With
    ``n_samples`` >= the pixel length of the longest segment every cell on
    the line is covered.
    """
    start_xy = jnp.atleast_2d(jnp.asarray(start_xy, jnp.float32))  # (K, 2)
    end_xy = jnp.atleast_2d(jnp.asarray(end_xy, jnp.float32))
    sx, sy = w2m(grid, start_xy[:, 0], start_xy[:, 1])
    ex, ey = w2m(grid, end_xy[:, 0], end_xy[:, 1])

    t = jnp.linspace(0.0, 1.0, n_samples)  # (S,)
    # Interpolate in pixel space between cell indices, rounding to nearest —
    # a superset-free approximation of the Bresenham cell list.
    px = jnp.round(sx[:, None] + (ex - sx)[:, None] * t[None, :]).astype(jnp.int32)
    py = jnp.round(sy[:, None] + (ey - sy)[:, None] * t[None, :]).astype(jnp.int32)

    h, w = grid.occ.shape
    pxf = jnp.clip(px.reshape(-1), 0, w - 1)
    pyf = jnp.clip(py.reshape(-1), 0, h - 1)
    occ = grid.occ.at[pyf, pxf].set(0.0)
    return grid.replace(occ=occ)
