"""Shared fixed-length ray primitive over occupancy grids.

The reference uses three different Cython/Python cell-walking loops —
``line_aa`` ray-marching for path width (reference_path.py:243-287), the
border-to-border scanline for free segments (reference_path.py:466-520), and
the per-cell lidar sweep (lidar_model.py:37-112).  All three reduce to one
data-parallel primitive: sample K evenly spaced points along a world-space
segment, look up occupancy per sample.  K is static, so the op vmaps over
arbitrary ray batches and compiles once.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from multi_purpose_mpc_tpu.ops.grid import GridMap, lookup, w2m


class LineSamples(NamedTuple):
    occ: jnp.ndarray  # (..., K) occupancy at each sample (1=free, 0=occupied/OOB)
    px: jnp.ndarray  # (..., K) int32 pixel x
    py: jnp.ndarray  # (..., K) int32 pixel y
    x: jnp.ndarray  # (..., K) world x of each sample point
    y: jnp.ndarray  # (..., K) world y of each sample point


def sample_line(grid: GridMap, x0, y0, x1, y1, n_samples: int) -> LineSamples:
    """Sample ``n_samples`` points from (x0, y0) to (x1, y1) inclusive.

    Inputs broadcast; a trailing K axis is appended.  Out-of-bounds samples
    read as occupied — the shape-static analogue of the reference's implicit
    assumption that rays stay inside the image.
    """
    t = jnp.linspace(0.0, 1.0, n_samples, dtype=jnp.float32)
    x = jnp.asarray(x0, jnp.float32)[..., None] + (jnp.asarray(x1, jnp.float32) - jnp.asarray(x0, jnp.float32))[..., None] * t
    y = jnp.asarray(y0, jnp.float32)[..., None] + (jnp.asarray(y1, jnp.float32) - jnp.asarray(y0, jnp.float32))[..., None] * t
    px, py = w2m(grid, x, y)
    occ = lookup(grid, px, py, oob_value=0.0)
    return LineSamples(occ=occ, px=px, py=py, x=x, y=y)


def first_occupied(samples: LineSamples):
    """Index of the first occupied sample along the last axis.

    Returns ``(hit, idx)`` where ``hit`` is a bool mask (any occupied sample)
    and ``idx`` the first occupied index (K-1 when no hit).
    """
    occupied = samples.occ < 0.5
    k = samples.occ.shape[-1]
    idx = jnp.argmax(occupied, axis=-1)  # first True, 0 if none
    hit = occupied.any(axis=-1)
    return hit, jnp.where(hit, idx, k - 1)
