"""Fleet-scale scanline occupancy extraction for dynamic grids.

The LiDAR-in-the-loop fleet needs, every step, the occupancy values along
each lane's N horizon scanlines (reference walks Bresenham cell lists per
waypoint: reference_path.py:466-520).  At batch 256 that is ~1M grid reads
per step.  The scanline sample *coordinates* are static per waypoint (the
border points are path data), so they live in a precomputed
:class:`ScanlineTable` and the per-step work is only "read occupancy at K
static pixels for the N horizon waypoints of each lane", by one of two
backends that agree exactly:

* ``gather`` — the plain indexed read (the semantic reference for tests);
* ``onehot`` — the read as a one-hot matmul,
  ``val[s] = sum_j rowOH[s,i] * occ[i,j] * colOH[s,j]``, contracted as a
  bf16 einsum (0/1 values are exact in bf16).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from multi_purpose_mpc_tpu.ops.grid import GridMap, m2w
from multi_purpose_mpc_tpu.ops.path import PathData
from multi_purpose_mpc_tpu.ops.rays import sample_line
from multi_purpose_mpc_tpu.utils import pytree


@pytree.dataclass
class ScanlineTable:
    """Static per-waypoint scanline sample data (all shapes (n_wp, K)).

    ``px``/``py`` are clipped in-bounds pixel coords; ``inb`` marks samples
    that were genuinely inside the grid (out-of-bounds samples read as
    occupied, matching :func:`~..ops.grid.lookup`); ``cx``/``cy`` are the
    world coordinates of the sample *cell centers* (the endpoint convention
    of reference_path.py:488-518).
    """

    px: jnp.ndarray  # (n_wp, K) int32, clipped
    py: jnp.ndarray  # (n_wp, K) int32, clipped
    inb: jnp.ndarray  # (n_wp, K) bool
    cx: jnp.ndarray  # (n_wp, K) f32 world x of cell center
    cy: jnp.ndarray  # (n_wp, K) f32 world y of cell center


def build_scanline_table(grid: GridMap, path: PathData,
                         n_samples: int) -> ScanlineTable:
    """Precompute scanline sample coordinates for every waypoint (static:
    depends only on the grid geometry and the static border points)."""
    s = jax.vmap(lambda a, b: sample_line(grid, a[0], a[1], b[0], b[1],
                                          n_samples))(path.border_ub,
                                                      path.border_lb)
    h, w = grid.occ.shape
    inb = (s.px >= 0) & (s.px < w) & (s.py >= 0) & (s.py < h)
    # world cell centers from the RAW pixel coords (identical to
    # free_segments' m2w, even for out-of-bounds samples); clipped coords
    # are only for the occupancy read, where `inb` forces OOB to occupied
    cx, cy = m2w(grid, s.px, s.py)
    px = jnp.clip(s.px, 0, w - 1)
    py = jnp.clip(s.py, 0, h - 1)
    return ScanlineTable(px=px, py=py, inb=inb, cx=cx, cy=cy)


def horizon_tables(table: ScanlineTable, idx: jnp.ndarray):
    """Gather the (B, N) horizon rows out of the static table — contiguous
    row gathers, cheap.  Returns px, py, inb, cx, cy with leading (B, N)."""
    return (table.px[idx], table.py[idx], table.inb[idx], table.cx[idx],
            table.cy[idx])


# ---------------------------------------------------------------------------
# Backend 1: plain gather (the semantic reference)
# ---------------------------------------------------------------------------


def extract_occ_gather(occ: jnp.ndarray, px: jnp.ndarray,
                       py: jnp.ndarray) -> jnp.ndarray:
    """occ (B, H, W) or (H, W) shared; px/py (B, N, K) clipped."""
    if occ.ndim == 2:
        return occ[py, px]
    B = occ.shape[0]
    return jax.vmap(lambda o, x, y: o[y, x])(occ, px, py)


# ---------------------------------------------------------------------------
# Backend 2: one-hot matmul
# ---------------------------------------------------------------------------


def extract_occ_onehot(occ: jnp.ndarray, px: jnp.ndarray, py: jnp.ndarray,
                       chunk: int = 6) -> jnp.ndarray:
    """One-hot einsum formulation: the gather becomes a bf16 matmul over the
    grid width plus a row-mask reduction (exact: all values are 0/1).

    Chunked over the horizon axis to bound the (B, chunk, K, H) intermediate.
    """
    B, N, K = px.shape
    shared = occ.ndim == 2
    H, W = occ.shape[-2:]
    occb = occ.astype(jnp.bfloat16)
    iw = jnp.arange(W, dtype=px.dtype)
    ih = jnp.arange(H, dtype=py.dtype)

    chunk = min(chunk, N)  # short horizons: px[:, :n_pad] needs n_pad <= N
    n_pad = (-N) % chunk
    if n_pad:
        px = jnp.concatenate([px, px[:, :n_pad]], axis=1)
        py = jnp.concatenate([py, py[:, :n_pad]], axis=1)
    n_ch = (N + n_pad) // chunk

    def one_chunk(c):
        pxc, pyc = c  # (B, chunk, K)
        colOH = (pxc[..., None] == iw).astype(jnp.bfloat16)  # (B, c, K, W)
        if shared:
            colsel = jnp.einsum("bnkw,hw->bnkh", colOH, occb,
                                preferred_element_type=jnp.float32)
        else:
            colsel = jnp.einsum("bnkw,bhw->bnkh", colOH, occb,
                                preferred_element_type=jnp.float32)
        rowOH = pyc[..., None] == ih
        return jnp.where(rowOH, colsel, 0.0).sum(-1)  # (B, c, K)

    pxr = jnp.moveaxis(px.reshape(B, n_ch, chunk, K), 1, 0)
    pyr = jnp.moveaxis(py.reshape(B, n_ch, chunk, K), 1, 0)
    vals = jax.lax.map(one_chunk, (pxr, pyr))  # (n_ch, B, chunk, K)
    return jnp.moveaxis(vals, 0, 1).reshape(B, N + n_pad, K)[:, :N]


def extract_occ(occ: jnp.ndarray, px: jnp.ndarray, py: jnp.ndarray,
                backend: str = "gather") -> jnp.ndarray:
    """Occupancy values at the horizon scanline samples.

    backend: "gather" | "onehot" (they agree exactly: 0/1 values; tests pin
    it).
    """
    if backend == "gather":
        return extract_occ_gather(occ, px, py)
    if backend == "onehot":
        return extract_occ_onehot(occ, px, py)
    raise ValueError(f"unknown extraction backend {backend!r}")


def fleet_dynamic_segments(occ: jnp.ndarray, table: ScanlineTable,
                           idx: jnp.ndarray, min_width, max_segments: int,
                           backend: str = "gather"):
    """Per-lane free-segment candidates from per-lane (B, H, W) or shared
    (H, W) dynamic grids — the fleet-scale replacement for vmapping
    :func:`~..ops.constraints.free_segments` over lanes and horizon steps.

    ``idx`` (B, N): horizon waypoint indices per lane.  Returns
    SegmentCandidates with leading (B, N).
    """
    from multi_purpose_mpc_tpu.ops.constraints import segments_from_samples

    pxh, pyh, inbh, cxh, cyh = horizon_tables(table, idx)
    vals = extract_occ(occ, pxh, pyh, backend)
    vals = jnp.where(inbh, vals, 0.0)  # OOB samples read as occupied
    seg1 = lambda v, a, b: segments_from_samples(v, a, b, min_width,
                                                 max_segments)
    return jax.vmap(jax.vmap(seg1))(vals, cxh, cyh)
