"""Host-side occupancy-map loading and preprocessing.

Image decode and speckle cleanup are one-time setup work on static assets, so
they stay on the host (numpy + a standard-library PNG decoder +
scipy.ndimage); the result is uploaded once as a device-resident
:class:`~multi_purpose_mpc_tpu.ops.grid.GridMap`.
This replaces the reference's in-object pipeline (reference: map.py:58-114)
which used PIL + ``skimage.morphology.remove_small_holes``.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from multi_purpose_mpc_tpu.config import MapConfig
from multi_purpose_mpc_tpu.ops.grid import GridMap, make_grid_map
from multi_purpose_mpc_tpu.utils.png import read_png


def binarize(img: np.ndarray, threshold_occupied: int = 100) -> np.ndarray:
    """Binarize the red channel: 1 = free, 0 = occupied (reference: map.py:110)."""
    return np.where(img >= threshold_occupied, 1, 0).astype(np.int8)


def remove_small_holes(binary: np.ndarray, area_threshold: int = 5) -> np.ndarray:
    """Fill small occupied speckles (<= area_threshold px, 8-connectivity).

    Equivalent of ``skimage.morphology.remove_small_holes(data, 5, 8)`` on a
    1=free/0=occupied grid (reference: map.py:113-114): background (0)
    components with area < area_threshold become free.  skimage fills holes
    with area strictly smaller than the threshold; we match that.
    """
    holes = binary == 0
    structure = np.ones((3, 3), dtype=bool)  # 8-connectivity
    labels, n = ndimage.label(holes, structure=structure)
    if n == 0:
        return binary
    sizes = ndimage.sum_labels(np.ones_like(labels), labels, index=np.arange(1, n + 1))
    small = np.concatenate([[False], sizes < area_threshold])  # label 0 = not a hole
    out = binary.copy()
    out[small[labels]] = 1
    return out


def load_map_image(file_path: str, threshold_occupied: int = 100,
                   hole_area_threshold: int = 5,
                   use_native: bool = True) -> np.ndarray:
    """PNG -> clean binary occupancy array (1=free, 0=occupied).

    Red channel -> binarize -> speckle removal, matching reference
    map.py:61, 103-114.  The post-decode stage runs through the native C
    pipeline (native/mapops.c) when available — the framework's own
    equivalent of the reference's PIL/skimage native path — with the
    scipy.ndimage implementation as fallback.
    """
    raw = read_png(file_path)
    if raw.ndim == 3:
        raw = raw[:, :, 0]
    if use_native:
        from multi_purpose_mpc_tpu.utils import native

        if native.available():
            return native.preprocess_map(raw.astype(np.uint8),
                                         threshold_occupied,
                                         hole_area_threshold)
    binary = binarize(raw, threshold_occupied)
    return remove_small_holes(binary, hole_area_threshold)


def obstacle_pixels(origin, resolution: float, cx, cy, radius):
    """Float64 world->pixel conversion for obstacle rasterization.

    Matches the reference's numpy float64 ``w2m`` + ``ceil`` exactly
    (map.py:85-86, 129) — scenario coordinates often land exactly on cell
    boundaries, where float32 rounds to the neighboring cell.
    """
    cx = np.asarray(cx, np.float64)
    cy = np.asarray(cy, np.float64)
    radius = np.asarray(radius, np.float64)
    px = np.floor((cx - origin[0]) / resolution).astype(np.int32)
    py = np.floor((cy - origin[1]) / resolution).astype(np.int32)
    r_px = np.ceil(radius / resolution).astype(np.int32)
    return px, py, r_px


def add_obstacles_host(grid: GridMap, origin, resolution: float,
                       obstacles) -> GridMap:
    """Rasterize a list of ``(cx, cy, radius)`` obstacles with float64 pixel
    math (bit-exact vs the reference's setup-time rasterization)."""
    from multi_purpose_mpc_tpu.ops.grid import rasterize_disks_px

    obs = np.asarray(obstacles, np.float64).reshape(-1, 3)
    px, py, r_px = obstacle_pixels(origin, resolution, obs[:, 0], obs[:, 1], obs[:, 2])
    return rasterize_disks_px(grid, px, py, r_px)


def load_grid_map(cfg: MapConfig) -> GridMap:
    """Load a :class:`GridMap` from a :class:`MapConfig` (device upload included)."""
    data = load_map_image(cfg.file_path, cfg.threshold_occupied, cfg.hole_area_threshold)
    return make_grid_map(data.astype(np.float32), cfg.origin, cfg.resolution)
