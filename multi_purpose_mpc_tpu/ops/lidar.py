"""LiDAR sensor model as a vmapped beam ray-march (the lidar_model.py port).

The reference scans by brute force: an O((2 range_px)^2) Python double loop
over every grid cell in range, computing per occupied cell the angular span
of its 9 corner points and min-updating every beam inside the span
(reference: lidar_model.py:37-112) — the single most data-parallel component
to redesign (SURVEY.md §3.5).  Here each *beam* marches a fixed number of
samples along its ray and takes the first occupied cell: ``n_beams x K``
grid lookups, fully data-parallel, thousands of scans per chip under vmap.

Semantics kept from the reference:
  * beam angles span ``[-FoV/2, +FoV/2]`` degrees around the car's yaw
    (lidar_model.py:31-33);
  * the sensor sits at the *center of the car's cell* (lidar_model.py:54-56);
  * a hit range is the distance to the hit cell's center, in meters
    (lidar_model.py:91-108); misses keep the max range.

``update_grid_from_scan`` closes the loop the reference left to its ROS node
(README.md:76): write hit endpoints back into a (dynamic copy of the) grid —
the LiDAR-in-the-loop config of BASELINE.json.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from multi_purpose_mpc_tpu.config import LidarConfig
from multi_purpose_mpc_tpu.ops.grid import GridMap, lookup, m2w, w2m
from multi_purpose_mpc_tpu.ops.rays import first_occupied, sample_line


class LidarScan(NamedTuple):
    angles: jnp.ndarray  # (n_beams,) beam angles relative to car yaw [rad]
    ranges: jnp.ndarray  # (n_beams,) measured range [m] (max range if miss)
    hit: jnp.ndarray  # (n_beams,) bool — beam hit an obstacle
    hit_xy: jnp.ndarray  # (n_beams, 2) world coords of hit cell centers


def beam_angles(cfg: LidarConfig) -> jnp.ndarray:
    """Relative beam angles (reference: lidar_model.py:31-33)."""
    half = jnp.pi / 360.0 * cfg.FoV
    return jnp.linspace(-half, half, cfg.n_beams, dtype=jnp.float32)


def scan(grid: GridMap, x, y, psi, cfg: LidarConfig,
         conservative: bool = False) -> LidarScan:
    """One scan from pose (x, y, psi); vmap over a fleet for batched scans.

    ``conservative=False`` (default, fast): first occupied cell among K point
    samples along each ray — 1 grid lookup per sample.

    ``conservative=True``: exact reference corner-span semantics.  The
    reference updates beam b with occupied cell c iff b's angle lies in the
    angular span of c's 9 corner/edge/center points (lidar_model.py:75-103);
    for a convex cell square not containing the sensor, that span is exactly
    the set of ray directions intersecting the square, so the test reduces
    to  perp_dist(cell_center, ray) <= (|n_x| + |n_y|)/2 * resolution  with
    n the ray normal (the square's support function).  We evaluate it over
    the 3x3 neighborhood of every ray sample (sample spacing < 1 px covers
    every intersected cell) and min-update with the distance to the cell
    center, matching the reference's measurement (:91-108) including
    corner-grazing hits the point-sampled march can miss.  9 lookups per
    sample; use for fidelity-critical scans.  Exactness requires sample
    spacing < 1 cell — ``cfg.validate_for_grid(resolution)`` checks it at
    setup (here the grid resolution is usually a tracer, so the check is
    best-effort on concrete inputs only).
    """
    if conservative:
        try:
            cfg.validate_for_grid(float(grid.resolution))
        except (jax.errors.TracerArrayConversionError, TypeError,
                jax.errors.ConcretizationTypeError):
            pass  # under jit: caller should validate at setup time
    angles = beam_angles(cfg)
    # sensor at the car cell's center (lidar_model.py:54-56)
    px, py = w2m(grid, x, y)
    cx, cy = m2w(grid, px, py)

    world_ang = angles + psi
    ux = jnp.cos(world_ang)
    uy = jnp.sin(world_ang)
    ex = cx + cfg.range * ux
    ey = cy + cfg.range * uy

    samples = sample_line(grid, jnp.broadcast_to(cx, world_ang.shape),
                          jnp.broadcast_to(cy, world_ang.shape),
                          ex, ey, cfg.n_ray_samples)

    if not conservative:
        hit, idx = first_occupied(samples)
        hpx = jnp.take_along_axis(samples.px, idx[:, None], axis=-1)[:, 0]
        hpy = jnp.take_along_axis(samples.py, idx[:, None], axis=-1)[:, 0]
        hx, hy = m2w(grid, hpx, hpy)
        dist = jnp.hypot(hx - cx, hy - cy)
        ranges = jnp.where(hit, jnp.minimum(dist, cfg.range), cfg.range)
        return LidarScan(angles=angles, ranges=ranges, hit=hit,
                         hit_xy=jnp.stack([hx, hy], -1))

    res = grid.resolution
    support = (jnp.abs(ux) + jnp.abs(uy))[:, None] * 0.5 * res  # (nb, 1)
    best = jnp.full(world_ang.shape, jnp.inf, jnp.float32)
    best_px = jnp.zeros(world_ang.shape, jnp.int32)
    best_py = jnp.zeros(world_ang.shape, jnp.int32)
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            qx = samples.px + ox
            qy = samples.py + oy
            # OOB reads as free: the reference never updates from
            # out-of-image cells (lidar_model.py:63-65)
            occv = lookup(grid, qx, qy, oob_value=1.0)
            wx, wy = m2w(grid, qx, qy)
            rx = wx - cx
            ry = wy - cy
            along = rx * ux[:, None] + ry * uy[:, None]
            perp = jnp.abs(ry * ux[:, None] - rx * uy[:, None])
            d = jnp.hypot(rx, ry)
            cand = ((occv < 0.5) & (along > 0.0) & (perp <= support)
                    & (d < cfg.range))
            dd = jnp.where(cand, d, jnp.inf)
            k = jnp.argmin(dd, axis=-1)
            dk = jnp.take_along_axis(dd, k[:, None], axis=-1)[:, 0]
            better = dk < best
            best = jnp.where(better, dk, best)
            best_px = jnp.where(better,
                                jnp.take_along_axis(qx, k[:, None], -1)[:, 0],
                                best_px)
            best_py = jnp.where(better,
                                jnp.take_along_axis(qy, k[:, None], -1)[:, 0],
                                best_py)
    hit = jnp.isfinite(best)
    hx, hy = m2w(grid, best_px, best_py)
    hx = jnp.where(hit, hx, cx + cfg.range * ux)
    hy = jnp.where(hit, hy, cy + cfg.range * uy)
    ranges = jnp.where(hit, best, cfg.range)
    return LidarScan(angles=angles, ranges=ranges, hit=hit,
                     hit_xy=jnp.stack([hx, hy], -1))


def occupied_cell_table(occ, pad_multiple: int = 1024):
    """Static setup for :func:`scan_fleet`'s "cells" backend: pixel coords of
    every occupied BOUNDARY cell of a STATIC true grid, host-side (numpy),
    padded with out-of-world dummies to a static multiple.  Returns (M, 2)
    int32 with dummies at (-10**6, -10**6).

    Boundary-only is exact (not an approximation) whenever the sensor sits
    in FREE space: the ray's intersected-cell chain starts at the (free)
    sensor cell, so the nearest occupied chain cell has a free, 8-adjacent
    chain predecessor (edge entry -> 4-adjacent, corner entry -> diagonal).
    Interior occupied cells can never win the min.  A sensor *inside* an
    obstacle (a crashed lane) sees only the obstacle's shell — physically
    moot, and such lanes are failed/masked anyway.  Out-of-image counts as
    free here (the reference never updates from out-of-image cells,
    lidar_model.py:63-65), keeping image-edge walls.  On track maps this
    prunes the table ~20x (solid out-of-track fill)."""
    import numpy as np

    occ_np = np.asarray(occ)
    occupied = occ_np < 0.5
    free_p = np.pad(~occupied, 1, constant_values=True)
    near_free = np.zeros_like(occupied)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy == 1 and dx == 1:
                continue
            near_free |= free_p[dy:dy + occ_np.shape[0],
                                dx:dx + occ_np.shape[1]]
    ys, xs = np.nonzero(occupied & near_free)
    n = xs.shape[0]
    M = max(((n + pad_multiple - 1) // pad_multiple) * pad_multiple,
            pad_multiple)
    px = np.full(M, -10**6, np.int32)
    py = np.full(M, -10**6, np.int32)
    px[:n] = xs
    py[:n] = ys
    return jnp.asarray(np.stack([px, py], axis=1))


def waypoint_cell_table(cells, grid: GridMap, path, radius_m: float,
                        pad_multiple: int = 512):
    """Static per-waypoint candidate-cell pruning for :func:`scan_fleet`'s
    "cells" backend: for each waypoint, the subset of the global occupied
    boundary-cell table (``cells`` from :func:`occupied_cell_table`) within
    ``radius_m`` of the waypoint, host-side numpy at setup.  Returns
    (n_wp, K, 2) int32 pixel coords, dummy-padded with (-10**6, -10**6).

    Exactness: a scan from any pose within ``radius_m - cfg.range`` of its
    waypoint sees only cells inside ``radius_m`` of the waypoint, so the
    pruned sweep equals the full-table sweep (pure geometry, no
    approximation).  Use ``radius_m = cfg.range + slack`` with ``slack`` >=
    the max pose-to-waypoint distance — :func:`waypoint_slack` computes a
    safe bound from the path's static borders.  The win: the per-step pair
    sweep is O(B x K x n_beams) instead of O(B x M x n_beams); on maps
    large relative to the lidar range (e.g. Real_Track) K << M.
    """
    import numpy as np

    cells_np = np.asarray(cells)
    real = cells_np[:, 0] > -(10**5)
    px = cells_np[real, 0]
    py = cells_np[real, 1]
    ccx, ccy = (np.asarray(a) for a in m2w(grid, jnp.asarray(px),
                                           jnp.asarray(py)))
    wx = np.asarray(path.x)
    wy = np.asarray(path.y)
    r2 = float(radius_m) ** 2
    masks = [(ccx - a) ** 2 + (ccy - b) ** 2 < r2 for a, b in zip(wx, wy)]
    kmax = max(int(m.sum()) for m in masks)
    K = max(((kmax + pad_multiple - 1) // pad_multiple) * pad_multiple,
            pad_multiple)
    out = np.full((len(wx), K, 2), -(10**6), np.int32)
    for n, m in enumerate(masks):
        k = int(m.sum())
        out[n, :k, 0] = px[m]
        out[n, :k, 1] = py[m]
    return jnp.asarray(out)


def waypoint_slack(path) -> float:
    """Safe pose-to-waypoint distance bound for :func:`waypoint_cell_table`:
    any on-track pose localized to waypoint ``n`` lies within the drivable
    border of some nearby waypoint, so (max waypoint-to-border distance) +
    (2 max waypoint spacing) bounds it with margin for one step of motion
    between localizations."""
    import numpy as np

    wx = np.asarray(path.x)[:, None]
    wy = np.asarray(path.y)[:, None]
    b = np.concatenate([np.asarray(path.border_ub),
                        np.asarray(path.border_lb)], axis=1).reshape(
                            wx.shape[0], -1, 2)
    d = np.hypot(b[..., 0] - wx, b[..., 1] - wy).max()
    spacing = np.asarray(path.seg_dist).max()
    return float(d + 2.0 * spacing)


def scan_fleet(grid: GridMap, x, y, psi, cfg: LidarConfig,
               cells: jnp.ndarray | None = None, backend: str = "march",
               chunk: int = 2048, wp_id: jnp.ndarray | None = None
               ) -> LidarScan:
    """Batched scans for a fleet of poses (x, y, psi each (B,)).

    backends:
      * ``march`` — vmapped :func:`scan` (first occupied point-sample per
        beam): B x n_beams x K random grid gathers per call.
      * ``cells`` — gather-free reformulation of the reference's per-cell
        sweep (lidar_model.py:62-108): iterate the STATIC true grid's
        occupied-cell list (``cells``, precomputed once at setup by
        :func:`occupied_cell_table`) and test every (lane, cell, beam)
        triple with the same ray-square-intersection reduction as
        ``scan(conservative=True)`` — dense elementwise math, zero gathers.
        Semantics are therefore the reference's EXACT corner-span scan.
        ``cells`` may instead be a per-waypoint pruned table
        (:func:`waypoint_cell_table`, shape (n_wp, K, 2)); then ``wp_id``
        (B,) selects each lane's candidate row — same results, K << M
        pair tests on large maps.

    Tie-breaking between equidistant hit cells is deterministic (smaller
    pixel-y, then pixel-x) but may differ from ``scan(conservative)``'s
    sample-order argmin on exact ties; measured ranges are identical.
    """
    if backend == "march":
        return jax.vmap(lambda a, b, c: scan(grid, a, b, c, cfg))(x, y, psi)
    if backend != "cells":
        raise ValueError(f"unknown scan backend {backend!r}")
    if cells is None:
        raise ValueError("cells backend needs occupied_cell_table(true_occ)")

    B = x.shape[0]
    nb = cfg.n_beams
    nbp = max(((nb + 127) // 128) * 128, 128)
    res = grid.resolution

    # sensor at the car cell's center (lidar_model.py:54-56)
    spx, spy = w2m(grid, x, y)
    cx, cy = m2w(grid, spx, spy)  # (B,)

    rel = beam_angles(cfg)  # (nb,)
    rel_p = jnp.concatenate([rel, jnp.zeros(nbp - nb, rel.dtype)])
    wang = rel_p[None, :] + psi[:, None]  # (B, nbp)
    ux = jnp.cos(wang)
    uy = jnp.sin(wang)
    support = (jnp.abs(ux) + jnp.abs(uy)) * 0.5 * res  # (B, nbp)

    if cells.ndim == 3:  # per-waypoint pruned candidates
        if wp_id is None:
            raise ValueError("per-waypoint cell table needs wp_id")
        cells_b = jnp.take(cells, wp_id, axis=0)  # (B, K, 2) row gather
    else:
        cells_b = cells[None]  # (1, M, 2) broadcast over lanes
    M = cells_b.shape[1]
    chunk = min(chunk, M)
    while M % chunk:  # cell tables are padded to static multiples
        chunk //= 2
    n_ch = M // chunk

    BIG = jnp.float32(1e9)
    H, W = grid.occ.shape
    # packed win-cell id py*W + px: exact in f32 for grids < 2^24 cells
    # (cuts one full (B, C, nbp) select+reduce chain vs separate px/py mins)
    assert H * W < (1 << 24), "pid packing needs H*W < 2^24"

    def body(carry, cell_chunk):
        acc_d, acc_pid = carry  # (B, nbp) each
        gpx, gpy = cell_chunk  # (Bc, C) pixel coords, Bc in {1, B}
        gx, gy = m2w(grid, gpx, gpy)  # world cell centers
        pid = (gpy * W + gpx).astype(jnp.float32)  # (Bc, C)
        dx = gx - cx[:, None]  # (B, C)
        dy = gy - cy[:, None]
        d = jnp.sqrt(dx * dx + dy * dy)
        in_range = (d < cfg.range) & (d > 0.0)
        # (B, C, nbp) pair tests — the corner-span reduction
        along = dx[:, :, None] * ux[:, None, :] + dy[:, :, None] * uy[:, None, :]
        perp = jnp.abs(dy[:, :, None] * ux[:, None, :]
                       - dx[:, :, None] * uy[:, None, :])
        hit = (along > 0.0) & (perp <= support[:, None, :]) & in_range[:, :, None]
        dt = jnp.where(hit, d[:, :, None], BIG)  # (B, C, nbp)
        c_d = dt.min(axis=1)  # (B, nbp)
        # winning cell: min packed id over tied minima
        is_min = (dt <= c_d[:, None, :]) & (c_d[:, None, :] < BIG)
        c_pid = jnp.where(is_min, pid[:, :, None], BIG).min(axis=1)
        better = c_d < acc_d
        return (jnp.where(better, c_d, acc_d),
                jnp.where(better, c_pid, acc_pid)), None

    init = (jnp.full((B, nbp), BIG), jnp.full((B, nbp), BIG))
    nc = cells_b.shape[0]
    chunks = (jnp.moveaxis(cells_b[..., 0].reshape(nc, n_ch, chunk), 1, 0),
              jnp.moveaxis(cells_b[..., 1].reshape(nc, n_ch, chunk), 1, 0))
    (dmin, pid), _ = jax.lax.scan(body, init, chunks)

    dmin = dmin[:, :nb]
    hit = dmin < cfg.range
    pid_i = jnp.where(hit, pid[:, :nb], 0.0).astype(jnp.int32)
    ppx = pid_i % W
    ppy = pid_i // W
    hx, hy = m2w(grid, ppx, ppy)
    hx = jnp.where(hit, hx, cx[:, None] + cfg.range * ux[:, :nb])
    hy = jnp.where(hit, hy, cy[:, None] + cfg.range * uy[:, :nb])
    ranges = jnp.where(hit, dmin, cfg.range)
    return LidarScan(angles=jnp.broadcast_to(rel, (B, nb)), ranges=ranges,
                     hit=hit, hit_xy=jnp.stack([hx, hy], -1))


def measurements(scan_out: LidarScan) -> jnp.ndarray:
    """(2, n_beams) stacked (angle, range) container — the reference's
    ``self.measurements`` layout (lidar_model.py:31-35)."""
    return jnp.stack([scan_out.angles, scan_out.ranges], axis=0)


def _pair_mask(py, px, valid, H: int, W: int):
    """Dense (..., H, W) mask of the (py, px) points via a one-hot matmul —
    the matmul replacement for a scatter.
    ``py``/``px`` (..., S) clipped int32; ``valid`` (..., S) bool."""
    ih = jnp.arange(H, dtype=py.dtype)
    iw = jnp.arange(W, dtype=px.dtype)
    rowOH = ((py[..., None, :] == ih[:, None]) & valid[..., None, :]
             ).astype(jnp.bfloat16)  # (..., H, S)
    colOH = (px[..., None] == iw).astype(jnp.bfloat16)  # (..., S, W)
    counts = jnp.matmul(rowOH, colOH,
                        preferred_element_type=jnp.float32)  # (..., H, W)
    return counts > 0.5


def _pair_mask_pooled(py, px, valid, h: int, w: int,
                      chunk_elems: int = 1 << 17):
    """One pooled (h, w) mask from FLAT (S,) point lists — ``_pair_mask``
    chunked over the sample axis so the (h, S_chunk) one-hot intermediates
    stay bounded (~128 MB bf16 at the default chunk) at any fleet scale;
    chunk masks combine with ``any`` (or is monotone)."""
    S = py.shape[0]
    pad = (-S) % chunk_elems
    if pad and S > chunk_elems:
        py = jnp.concatenate([py, jnp.zeros(pad, py.dtype)])
        px = jnp.concatenate([px, jnp.zeros(pad, px.dtype)])
        valid = jnp.concatenate([valid, jnp.zeros(pad, bool)])
    if S <= chunk_elems:
        return _pair_mask(py[None], px[None], valid[None], h, w)[0]
    nch = (S + pad) // chunk_elems
    m = jax.lax.map(
        lambda t: _pair_mask(t[0][None], t[1][None], t[2][None], h, w)[0],
        (py.reshape(nch, -1), px.reshape(nch, -1), valid.reshape(nch, -1)))
    return m.any(axis=0)


def fleet_observation_masks(grid: GridMap, h: int, w: int, x, y, psi,
                            scans: LidarScan, cfg: LidarConfig,
                            clear_free: bool = False, shared: bool = False,
                            free_samples: int = 64, lane_chunk: int = 16):
    """Dense hit / observed-free cell masks for a batch of scans, built with
    one-hot matmuls (no scatters).  Returns ``(hitmask, freemask)`` with
    ``freemask`` None unless ``clear_free``; shapes (H, W) pooled over all
    lanes when ``shared`` else per-lane (B, H, W).

    Exposed separately from :func:`fleet_writeback` so multi-device shared
    mapping can pool the masks ACROSS devices (max = logical-or is
    commutative) before the single elementwise grid update — see
    ``parallel.fleet.simulate_lidar_fleet_sharded``.
    """
    B = scans.ranges.shape[0]

    hpx, hpy = w2m(grid, scans.hit_xy[..., 0], scans.hit_xy[..., 1])  # (B, nb)
    hpx = jnp.clip(hpx, 0, w - 1)
    hpy = jnp.clip(hpy, 0, h - 1)

    freemask = None
    if clear_free:
        fpx, fpy = jax.vmap(
            lambda a, b, c, s: free_space_pixels(grid, a, b, c, s,
                                                 free_samples)
        )(x, y, psi, scans)  # (B, nb * F)
        fvalid = jnp.ones(fpx.shape, bool)
        if shared:
            freemask = _pair_mask_pooled(fpy.reshape(-1), fpx.reshape(-1),
                                         fvalid.reshape(-1), h, w)
        else:
            # lane-chunked: the (B, H, nb*F) one-hot is too big in one piece
            nch = max(B // lane_chunk, 1)
            while B % nch:
                nch -= 1
            fm = jax.lax.map(
                lambda t: _pair_mask(t[0], t[1], t[2], h, w),
                (fpy.reshape(nch, -1, fpx.shape[-1]),
                 fpx.reshape(nch, -1, fpx.shape[-1]),
                 fvalid.reshape(nch, -1, fpx.shape[-1])))
            freemask = fm.reshape(B, h, w)

    if shared:
        hitmask = _pair_mask_pooled(hpy.reshape(-1), hpx.reshape(-1),
                                    scans.hit.reshape(-1), h, w)
    else:
        hitmask = _pair_mask(hpy, hpx, scans.hit, h, w)  # (B, H, W)
    return hitmask, freemask


def apply_observation_masks(occ: jnp.ndarray, hitmask: jnp.ndarray,
                            freemask: jnp.ndarray | None) -> jnp.ndarray:
    """Elementwise grid update from observation masks: free-space clearing
    first, hits after, so an observed obstacle always wins (the scatter
    path's order, order-independent per class)."""
    if freemask is not None:
        occ = jnp.where(freemask, 1.0, occ)
    return jnp.where(hitmask, 0.0, occ)


def fleet_writeback(grid: GridMap, occ: jnp.ndarray, x, y, psi,
                    scans: LidarScan, cfg: LidarConfig,
                    clear_free: bool = False, shared: bool = False,
                    free_samples: int = 64,
                    lane_chunk: int = 16) -> jnp.ndarray:
    """Batched online map update with NO scatters: hit (and observed-free)
    cells become dense masks via one-hot matmuls, then one elementwise grid
    update — the matmul alternative to per-lane ``update_grid_from_scan``
    scatter-writes in the fleet hot loop.

    ``occ`` (B, H, W) per-lane (``shared=False``) or (H, W) (``shared=True``,
    all lanes pooled into one map); ``scans`` carries a leading B axis.
    Semantics match the scatter path: free-space clearing first, hits after,
    so an observed obstacle always wins (order-independent per class).
    """
    h, w = occ.shape[-2:]
    hitmask, freemask = fleet_observation_masks(
        grid, h, w, x, y, psi, scans, cfg, clear_free=clear_free,
        shared=shared, free_samples=free_samples, lane_chunk=lane_chunk)
    return apply_observation_masks(occ, hitmask, freemask)


def free_space_pixels(grid: GridMap, x, y, psi, scan_out: LidarScan,
                      free_samples: int = 64):
    """Pixel coords of cells along each beam up to 95% of the measured range
    — the cells a scan observed as free.  Returns flattened, clipped
    ``(fpx, fpy)`` int32 arrays of length ``n_beams * free_samples``.
    Shared by the per-lane and pooled (shared-grid) clear-free updates."""
    h, w = grid.occ.shape
    px, py = w2m(grid, x, y)
    cx, cy = m2w(grid, px, py)
    world_ang = scan_out.angles + psi
    t = jnp.linspace(0.0, 0.95, free_samples)  # (F,)
    rx = cx + (scan_out.ranges[:, None] * t[None, :]) * jnp.cos(world_ang)[:, None]
    ry = cy + (scan_out.ranges[:, None] * t[None, :]) * jnp.sin(world_ang)[:, None]
    fpx, fpy = w2m(grid, rx, ry)
    fpx = jnp.clip(fpx.reshape(-1), 0, w - 1)
    fpy = jnp.clip(fpy.reshape(-1), 0, h - 1)
    return fpx, fpy


def update_grid_from_scan(grid: GridMap, x, y, psi, scan_out: LidarScan,
                          cfg: LidarConfig, clear_free: bool = False,
                          free_samples: int = 64) -> GridMap:
    """Write scan hits into a new grid (online map update, BASELINE.json
    config 4).  Pure function of the grid — usable inside the jitted control
    loop for LiDAR-in-the-loop simulation.

    ``clear_free=True`` additionally marks cells along each beam up to 95% of
    the measured range as free — a measurement-refresh mode for dynamic
    scenes (our extension; the reference's in-repo map never updates, its ROS
    node did: README.md:76).
    """
    occ = grid.occ
    h, w = occ.shape

    if clear_free:
        fpx, fpy = free_space_pixels(grid, x, y, psi, scan_out, free_samples)
        occ = occ.at[fpy, fpx].max(1.0)

    hpx, hpy = w2m(grid, scan_out.hit_xy[:, 0], scan_out.hit_xy[:, 1])
    hpx = jnp.clip(hpx, 0, w - 1)
    hpy = jnp.clip(hpy, 0, h - 1)
    occ = occ.at[hpy, hpx].min(jnp.where(scan_out.hit, 0.0, 1.0))
    return grid.replace(occ=occ)
