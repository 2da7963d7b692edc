"""Closed-loop simulation drivers (the simulation.py port).

The reference's ``while car.s < reference_path.length`` loop with inline
matplotlib rendering (reference: simulation.py:134-163) becomes a fixed-length
``lax.scan`` with a per-lane done mask; trajectories and solver statuses come
back as device buffers for post-hoc rendering (SURVEY.md §7 shift #5 —
rendering leaves the hot loop).

``simulate_closed_loop`` runs one lane; ``simulate_fleet`` vmaps the same
step over a fleet axis — thousands of cars per chip, zero host round-trips.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from multi_purpose_mpc_tpu.backends import select_backends
from multi_purpose_mpc_tpu.config import MPCConfig, ModelConfig, SimConfig
from multi_purpose_mpc_tpu.models.bicycle import CarState, drive, init_car_state
from multi_purpose_mpc_tpu.mpc import mpc_step
from multi_purpose_mpc_tpu.ops.grid import GridMap
from multi_purpose_mpc_tpu.ops.path import PathData


class SimLog(NamedTuple):
    """Per-step device-side logs (leading time axis; fleet axis after vmap).

    Replaces the reference's Python lists + live plots
    (simulation.py:129-131, 143-145).
    """

    x: jnp.ndarray
    y: jnp.ndarray
    psi: jnp.ndarray
    v: jnp.ndarray
    delta: jnp.ndarray
    s: jnp.ndarray
    e_y: jnp.ndarray
    status: jnp.ndarray  # raw solver status (SOLVED/MAX_ITER/DIVERGED)
    ok: jnp.ndarray  # control accepted (reference-semantics acceptance)
    r_prim: jnp.ndarray  # QP primal residual per step
    floor: jnp.ndarray  # certified violation floor (> 0: QP structurally
    # infeasible from the measured state — mpc.violation_floor; a rejected
    # step with floor == 0 is a true solver failure)
    active: jnp.ndarray


class SimResult(NamedTuple):
    final_state: CarState
    log: SimLog


def _post_control(out, path: PathData, model: ModelConfig):
    """Shared plant-step + logging after a control step (single lane)."""
    st = out.state
    active = ~(st.done | st.failed)
    v = jnp.where(active, out.v, 0.0)
    delta = jnp.where(active, out.delta, 0.0)
    st = drive(st, path, v, delta, model.length, model.Ts)
    # end-of-lap: the reference's loop condition (simulation.py:134)
    done = st.done | (st.s >= path.length)
    st = st.replace(done=done)
    log = SimLog(x=st.x, y=st.y, psi=st.psi, v=v, delta=delta, s=st.s,
                 e_y=st.e_y, status=out.status, ok=out.ok, r_prim=out.r_prim,
                 floor=out.floor, active=active)
    return st, log


def _sim_step(state: CarState, path: PathData, grid: GridMap,
              cfg: MPCConfig, model: ModelConfig, segments=None):
    out = mpc_step(state, path, grid, cfg, model, segments)
    return _post_control(out, path, model)


def _sim_step_batched(state: CarState, path: PathData, grid: GridMap,
                      cfg: MPCConfig, model: ModelConfig, segments=None,
                      weights=None):
    """Fleet step: batched QP solve (the ADMM kernel on a GPU), vmapped
    rest."""
    from multi_purpose_mpc_tpu.mpc import mpc_step_batched

    out = mpc_step_batched(state, path, grid, cfg, model, segments,
                           weights=weights)
    return jax.vmap(lambda o: _post_control(o, path, model))(out)


def _maybe_segments(grid: GridMap, path: PathData, cfg: MPCConfig,
                    model: ModelConfig, sim: SimConfig):
    """Static-grid fast path: free segments for all waypoints, computed once
    per rollout instead of N x B times per step (identical corridor values)."""
    if not sim.static_grid:
        return None
    from multi_purpose_mpc_tpu.ops.constraints import extract_all_segments

    return extract_all_segments(grid, path, 2.0 * model.safety_margin,
                                n_samples=cfg.n_scan_samples,
                                max_segments=cfg.max_segments)


def simulate_closed_loop(grid: GridMap, path: PathData, cfg: MPCConfig,
                         model: ModelConfig, sim: SimConfig,
                         state0: Optional[CarState] = None,
                         table=None) -> SimResult:
    """Single-lane closed-loop rollout as one compiled scan.

    Internally runs the fleet step with batch 1: one code path (and the
    same solver backend) for a single car and a fleet."""
    if state0 is None:
        state0 = init_car_state(path, cfg.N)
    state_b = jax.tree.map(lambda a: a[None], state0)
    res = simulate_fleet(grid, path, cfg, model, sim, state_b, table=table)
    squeeze = lambda t: jax.tree.map(lambda a: jnp.squeeze(a, axis=1), t)
    return SimResult(
        final_state=jax.tree.map(lambda a: jnp.squeeze(a, 0),
                                 res.final_state),
        log=squeeze(res.log))


def simulate_fleet(grid: GridMap, path: PathData, cfg: MPCConfig,
                   model: ModelConfig, sim: SimConfig, state0: CarState,
                   table=None, weights=None) -> SimResult:
    """Fleet closed-loop rollout: ``state0`` carries a leading batch axis;
    one scan over time, vmapped step over the fleet (SURVEY.md §2.3).

    ``sim.static_grid=True`` precomputes free segments once per rollout;
    ``False`` re-extracts every step (the semantics a changing grid needs)
    through the scanline-table backends — same machinery as the
    LiDAR-in-the-loop fleet, shared-grid flavor.

    ``weights``: optional per-lane :class:`~multi_purpose_mpc_tpu.mpc.WeightSet`
    (leaves with leading batch axis) — a controller-tuning sweep: every lane
    runs a differently-weighted MPC on the same track in one program (the
    reference's "multi-purpose via weight tuning", README.md:17-19, batched).
    """
    _validate_weights(weights, state0)
    if sim.static_grid:
        return _simulate_fleet_static(grid, path, cfg, model, sim, state0,
                                      weights)
    if table is None:
        from multi_purpose_mpc_tpu.ops.corridor_extract import build_scanline_table

        table = build_scanline_table(grid, path, cfg.n_scan_samples)
    return _simulate_fleet_dynamic(grid, path, cfg, model, sim, state0, table,
                                   weights)


def _validate_weights(weights, state0: CarState) -> None:
    """Fail fast on a mis-batched WeightSet: every non-None leaf needs a
    leading fleet axis matching the state batch (a wrong shape otherwise
    surfaces as an opaque vmap/scan trace error deep inside the rollout)."""
    if weights is None:
        return
    B = state0.x.shape[0]
    for name, leaf, width in (("Q", weights.Q, 3), ("R", weights.R, 2),
                              ("QN", weights.QN, 3)):
        if leaf is None:
            continue
        if leaf.ndim != 2 or leaf.shape[0] != B or leaf.shape[1] != width:
            raise ValueError(
                f"WeightSet.{name} must have shape ({B}, {width}) to match "
                f"the fleet batch; got {tuple(leaf.shape)}")


@functools.partial(jax.jit, static_argnames=("cfg", "model", "sim"))
def _simulate_fleet_static(grid: GridMap, path: PathData, cfg: MPCConfig,
                           model: ModelConfig, sim: SimConfig,
                           state0: CarState, weights=None) -> SimResult:
    segs = _maybe_segments(grid, path, cfg, model, sim)

    def step_fn(state, _):
        return _sim_step_batched(state, path, grid, cfg, model, segs, weights)

    final, log = jax.lax.scan(step_fn, state0, None, length=sim.max_steps)
    # logs come out (T, B, ...); keep that layout (time-major)
    return SimResult(final_state=final, log=log)


@functools.partial(jax.jit, static_argnames=("cfg", "model", "sim"))
def _simulate_fleet_dynamic(grid: GridMap, path: PathData, cfg: MPCConfig,
                            model: ModelConfig, sim: SimConfig,
                            state0: CarState, table,
                            weights=None) -> SimResult:
    def step_fn(state, _):
        st, log = _sim_step_batched_gridded(state, path, grid, grid.occ,
                                            cfg, model, table,
                                            weights=weights)
        return st, log

    final, log = jax.lax.scan(step_fn, state0, None, length=sim.max_steps)
    return SimResult(final_state=final, log=log)


def simulate_lidar_loop(true_grid: GridMap, known_grid: GridMap,
                        path: PathData, cfg: MPCConfig, model: ModelConfig,
                        sim: SimConfig, lidar,
                        state0: Optional[CarState] = None,
                        clear_free: bool = False, table=None,
                        scan_backend: str = "auto",
                        writeback_backend: str = "auto"):
    """LiDAR-in-the-loop closed loop (BASELINE.json config 4).

    The controller never sees ``true_grid``: each step the sensor ray-marches
    the true world (:func:`~..ops.lidar.scan`), the hits are written into the
    carried ``known_grid`` (:func:`~..ops.lidar.update_grid_from_scan`), and
    the MPC's corridor extraction runs against that updated map — the
    reference's out-of-repo ROS pipeline (README.md:76) as one on-device
    scan.  Corridor extraction stays in-loop (the grid changes every step).

    Runs the fleet implementation at batch 1 — ONE code path (scanline
    tables, extraction/selection backends, batched solver) regardless of
    fleet size, so single-lane and fleet lane-0 results coincide.

    Returns ``(SimResult, final_known_grid)``.
    """
    if state0 is None:
        state0 = init_car_state(path, cfg.N)
    state0_b = jax.tree.map(lambda a: a[None], state0)
    res, occ = simulate_lidar_fleet(true_grid, known_grid, path, cfg, model,
                                    sim, lidar, state0_b,
                                    clear_free=clear_free, table=table,
                                    scan_backend=scan_backend,
                                    writeback_backend=writeback_backend)
    squeeze = lambda t: jax.tree.map(lambda a: jnp.squeeze(a, axis=1), t)
    return (SimResult(
        final_state=jax.tree.map(lambda a: jnp.squeeze(a, 0),
                                 res.final_state),
        log=squeeze(res.log)),
        known_grid.replace(occ=jnp.squeeze(occ, 0)))


def resolve_lidar_backends(shared_grid: bool, scan_backend: str,
                           writeback_backend: str,
                           multi_device: bool = False, platform=None):
    """Resolve ``"auto"`` scan/write-back backends
    (:func:`~.backends.select_backends`) and validate the combination — ONE
    policy shared by :func:`simulate_lidar_fleet` and the sharded wrapper
    (`parallel.fleet.simulate_lidar_fleet_sharded`), so the two entry points
    cannot drift.

    ``multi_device=True`` with a shared grid forces the ``dense`` write-back:
    cross-device pooling rides observation masks.
    """
    if multi_device and shared_grid and writeback_backend == "auto":
        writeback_backend = "dense"
    b = select_backends(platform or jax.default_backend(), scan=scan_backend,
                        writeback=writeback_backend)
    if multi_device and shared_grid and b.writeback != "dense":
        raise ValueError("multi-device shared-grid mapping pools observation "
                         "masks across devices; writeback_backend must be "
                         "'dense'")
    return b.scan, b.writeback


def resolve_cell_table(true_grid: GridMap, path: PathData, lidar,
                       cells, scan_backend: str, prune: bool = True):
    """Build (or upgrade) the "cells" scan backend's static cell table —
    shared by :func:`simulate_lidar_fleet` and the sharded wrapper.

    Given no table, builds the global boundary-cell table; with ``prune``
    (default), upgrades a global (M, 2) table to the per-waypoint pruned
    (n_wp, K, 2) form (:func:`~..ops.lidar.waypoint_cell_table`) whenever
    the pruning actually pays (K < 3/4 M) — exact for on-track poses (the
    radius covers the drivable border plus a localization-lag margin,
    :func:`~..ops.lidar.waypoint_slack`)."""
    if scan_backend != "cells":
        return None
    from multi_purpose_mpc_tpu.ops.lidar import (occupied_cell_table,
                                                 waypoint_cell_table,
                                                 waypoint_slack)

    if cells is None:
        cells = occupied_cell_table(true_grid.occ)
    if prune and cells.ndim == 2:
        wpc = waypoint_cell_table(cells, true_grid, path,
                                  lidar.range + waypoint_slack(path))
        if wpc.shape[1] < 0.75 * cells.shape[0]:
            cells = wpc
    return cells


def simulate_lidar_fleet(true_grid: GridMap, known_grid: GridMap,
                         path: PathData, cfg: MPCConfig, model: ModelConfig,
                         sim: SimConfig, lidar, state0: CarState,
                         clear_free: bool = False,
                         shared_grid: bool = False, table=None,
                         cells=None, scan_backend: str = "auto",
                         writeback_backend: str = "auto",
                         prune_cells: bool = True, weights=None):
    """Fleet-scale LiDAR-in-the-loop rollout (BASELINE.json config 4 at
    batch scale): every lane scans the true world each step, writes hits
    into its working map, and runs MPC corridor extraction against that
    updated map — the reference's out-of-repo ROS pipeline (README.md:76)
    vmapped over thousands of cars.

    Grid semantics (two supported modes):
      * ``shared_grid=False`` (default): per-lane known grids — independent
        Monte-Carlo mapping runs.  ``known_grid.occ`` may be (H, W) (tiled
        to every lane) or already (B, H, W).  Device memory: B x H x W x 4 bytes
        (Sim_Track at B=256: 256 MB).
      * ``shared_grid=True``: ONE known grid cooperatively updated by all
        lanes each step (a mapping fleet pooling observations).  Lane
        writes commute (free-space clearing pools via max, hits via min,
        hits applied after clears so an observed obstacle always wins), so
        the update is order-independent and deterministic.

    ``clear_free=True`` works in both modes: per-lane it refreshes each
    lane's own map; shared it pools every lane's observed-free cells before
    the pooled hit write.

    Corridor extraction against the per-step-updated grids is the hot spot
    (~1M scanline reads per step at batch 256); it runs through the
    :mod:`~multi_purpose_mpc_tpu.ops.corridor_extract` backends
    (``cfg.extract_backend``) over a precomputed :class:`ScanlineTable`
    (``table``; built here — outside jit — when not supplied).

    ``weights``: optional per-lane :class:`~multi_purpose_mpc_tpu.mpc.WeightSet`
    — a controller-tuning sweep over a mapping fleet (each lane a
    differently-weighted MPC driving on its own sensed map).

    Returns ``(SimResult, final_known_occ)``.
    """
    _validate_weights(weights, state0)
    if table is None:
        from multi_purpose_mpc_tpu.ops.corridor_extract import build_scanline_table

        # the table is pure geometry — when resuming with a per-lane
        # (B, H, W) map stack, build it from the (identical) 2-D grid frame
        tgrid = known_grid
        if tgrid.occ.ndim == 3:
            tgrid = tgrid.replace(occ=tgrid.occ[0])
        table = build_scanline_table(tgrid, path, cfg.n_scan_samples)
    scan_backend, writeback_backend = resolve_lidar_backends(
        shared_grid, scan_backend, writeback_backend)
    cells = resolve_cell_table(true_grid, path, lidar, cells, scan_backend,
                               prune=prune_cells)
    return _simulate_lidar_fleet(true_grid, known_grid, path, cfg, model,
                                 sim, lidar, state0, table, cells,
                                 clear_free=clear_free,
                                 shared_grid=shared_grid,
                                 scan_backend=scan_backend,
                                 writeback_backend=writeback_backend,
                                 weights=weights)


@functools.partial(jax.jit, static_argnames=(
    "cfg", "model", "sim", "lidar", "clear_free", "shared_grid",
    "scan_backend", "writeback_backend", "axis_name"))
def _simulate_lidar_fleet(true_grid: GridMap, known_grid: GridMap,
                          path: PathData, cfg: MPCConfig, model: ModelConfig,
                          sim: SimConfig, lidar, state0: CarState, table,
                          cells, clear_free: bool = False,
                          shared_grid: bool = False,
                          scan_backend: str = "march",
                          writeback_backend: str = "scatter",
                          axis_name: str | None = None, weights=None):
    from multi_purpose_mpc_tpu.ops.lidar import (apply_observation_masks,
                                                 fleet_observation_masks,
                                                 fleet_writeback, scan_fleet,
                                                 update_grid_from_scan)

    if axis_name is not None and shared_grid and writeback_backend != "dense":
        raise ValueError("multi-device shared-grid pooling needs the 'dense' "
                         "write-back (observation masks)")

    B = state0.x.shape[0]
    occ0 = known_grid.occ
    if not shared_grid and occ0.ndim == 2:
        occ0 = jnp.broadcast_to(occ0, (B,) + occ0.shape)

    def step_fn(carry, _):
        state, occ = carry
        scans = scan_fleet(true_grid, state.x, state.y, state.psi, lidar,
                           cells=cells, backend=scan_backend,
                           wp_id=state.wp_id)
        if shared_grid:
            kgrid = known_grid.replace(occ=occ)
            if writeback_backend == "dense":
                h, w = occ.shape[-2:]
                hitmask, freemask = fleet_observation_masks(
                    kgrid, h, w, state.x, state.y, state.psi, scans, lidar,
                    clear_free=clear_free, shared=True)
                if axis_name is not None:
                    # cooperative mapping across devices: pooling masks is a
                    # max (= logical-or), so one pmax per mask keeps every
                    # device's replicated grid carry identical — the only
                    # hot-loop collectives in the framework
                    hitmask = jax.lax.pmax(hitmask.astype(jnp.float32),
                                           axis_name) > 0.5
                    if freemask is not None:
                        freemask = jax.lax.pmax(freemask.astype(jnp.float32),
                                                axis_name) > 0.5
                new_occ = apply_observation_masks(occ, hitmask, freemask)
            else:
                new_occ = kgrid.occ
                if clear_free:
                    # pooled free-space clearing: every lane's observed-free
                    # cells, scatter-max (commutative) before the hit write
                    from multi_purpose_mpc_tpu.ops.lidar import free_space_pixels

                    fpx, fpy = jax.vmap(
                        lambda x, y, p, s: free_space_pixels(kgrid, x, y, p, s)
                    )(state.x, state.y, state.psi, scans)
                    new_occ = new_occ.at[fpy.reshape(-1),
                                         fpx.reshape(-1)].max(1.0)
                # pooled update: flatten all lanes' hits into one write batch
                hit_xy = scans.hit_xy.reshape(-1, 2)
                from multi_purpose_mpc_tpu.ops.grid import w2m

                hpx, hpy = w2m(kgrid, hit_xy[:, 0], hit_xy[:, 1])
                h, w = kgrid.occ.shape
                hpx = jnp.clip(hpx, 0, w - 1)
                hpy = jnp.clip(hpy, 0, h - 1)
                val = jnp.where(scans.hit.reshape(-1), 0.0, 1.0)
                new_occ = new_occ.at[hpy, hpx].min(val)
            st, log = _sim_step_batched_gridded(state, path, known_grid,
                                                new_occ, cfg, model, table,
                                                weights=weights)
            return (st, new_occ), log
        # per-lane grids
        if writeback_backend == "dense":
            new_occ = fleet_writeback(known_grid, occ, state.x, state.y,
                                      state.psi, scans, lidar,
                                      clear_free=clear_free, shared=False)
        else:
            new_occ = jax.vmap(
                lambda o, x, y, p, s: update_grid_from_scan(
                    known_grid.replace(occ=o), x, y, p, s, lidar,
                    clear_free=clear_free).occ,
                in_axes=(0, 0, 0, 0, 0))(occ, state.x, state.y, state.psi,
                                         scans)
        st, log = _sim_step_batched_gridded(state, path, known_grid, new_occ,
                                            cfg, model, table,
                                            weights=weights)
        return (st, new_occ), log

    (final, occ), log = jax.lax.scan(step_fn, (state0, occ0), None,
                                     length=sim.max_steps)
    return SimResult(final_state=final, log=log), occ


def _locate_horizon(state: CarState, path: PathData, cfg: MPCConfig):
    """Fleet localization + horizon waypoint indices (starts at wp_id + 1,
    like the reference, MPC.py:116)."""
    from multi_purpose_mpc_tpu.mpc import mpc_locate
    from multi_purpose_mpc_tpu.ops.path import gather_waypoint_index

    located = jax.vmap(lambda s: mpc_locate(s, path))(state)
    offs = jnp.arange(cfg.N)
    idx = jax.vmap(lambda w: gather_waypoint_index(path, w + 1, offs))(
        located[0])
    return located, idx


def _dynamic_corridor_batched(state: CarState, path: PathData,
                              occ: jnp.ndarray, table, cfg: MPCConfig,
                              model: ModelConfig):
    """Fleet localization + dynamic-grid corridor; ``occ`` is per-lane
    (B, H, W) or shared (H, W).  Extraction runs the configured
    :func:`~..ops.corridor_extract.extract_occ` backend over the static
    scanline table."""
    from multi_purpose_mpc_tpu.ops.corridor_extract import fleet_dynamic_segments

    located, idx = _locate_horizon(state, path, cfg)
    sm = model.safety_margin
    backend = select_backends(jax.default_backend(),
                              extract=cfg.extract_backend).extract
    segs = fleet_dynamic_segments(occ, table, idx, 2.0 * sm,
                                  cfg.max_segments, backend=backend)
    corridor = _select_corridor_batched(path, segs, idx, cfg, sm)
    return located, corridor


def _select_corridor_batched(path: PathData, segs, idx, cfg: MPCConfig, sm):
    """Corridor selection from per-lane segment candidates (one selection
    scan per lane)."""
    from multi_purpose_mpc_tpu.ops.constraints import (SegmentCandidates,
                                                       select_corridor)

    return jax.vmap(
        lambda i, u, l, v: select_corridor(
            path, i, SegmentCandidates(ub_xy=u, lb_xy=l, valid=v), sm)
    )(idx, segs.ub_xy, segs.lb_xy, segs.valid)


def _sim_step_batched_gridded(state: CarState, path: PathData,
                              base_grid: GridMap, occ_b: jnp.ndarray,
                              cfg: MPCConfig, model: ModelConfig, table,
                              weights=None):
    """Fleet step where lanes drive on a per-step-updated occupancy grid —
    per-lane ``occ_b`` (B, H, W) or one shared (H, W) map — the dynamic-map
    variant of :func:`_sim_step_batched`.  The QP solve still runs the
    batched backend.  ``weights``: per-lane
    :class:`~multi_purpose_mpc_tpu.mpc.WeightSet` for tuning sweeps."""
    from multi_purpose_mpc_tpu.mpc import mpc_step_batched_with_corridor

    located, corridor = _dynamic_corridor_batched(state, path, occ_b, table,
                                                  cfg, model)
    out = mpc_step_batched_with_corridor(state, path, cfg, model, located,
                                         corridor, weights=weights)
    return jax.vmap(lambda o: _post_control(o, path, model))(out)


def feasible_starts(grid: GridMap, path: PathData, cfg: MPCConfig,
                    model: ModelConfig, batch: int, rng,
                    e_y_scale: float = 0.03, margin: float = 2e-3,
                    max_rounds: int = 8):
    """Draw ``batch`` Monte-Carlo start states (wp_id0, e_y0) whose first QP
    is CERTIFIED feasible.

    A raw random (waypoint, e_y) spawn can be structurally infeasible from
    step 0 — inside an obstacle's safety zone, or at a pinch-point whose
    corridor moves laterally faster than the horizon dynamics can follow
    (measured ~4% of uniform Sim_Track spawns).  Such a lane replays its
    (zero) initial controls forever; the reference would exit(1) there
    (MPC.py:218-220).  This helper clips each e_y into the start corridor
    and then RESAMPLES any lane whose :func:`~..mpc.violation_floor` is
    still positive, so fleet benchmarks/tests measure driving, not doomed
    spawns.  Host-side setup; returns (wp_id0 (B,) int32, e_y0 (B,) f32).
    """
    import numpy as np

    from multi_purpose_mpc_tpu.mpc import corridor_violation_floor, mpc_corridor
    from multi_purpose_mpc_tpu.ops.constraints import extract_all_segments
    from multi_purpose_mpc_tpu.ops.path import gather_waypoint_index

    segs = extract_all_segments(grid, path, 2.0 * model.safety_margin,
                                n_samples=cfg.n_scan_samples,
                                max_segments=cfg.max_segments)

    @jax.jit
    def check(wp, ey):
        def one(w, e):
            cor = mpc_corridor(w, path, grid, cfg, model, segs)
            lo = cor.lb[0] + margin
            hi = cor.ub[0] - margin
            e = jnp.clip(e, jnp.minimum(lo, hi), hi)
            idx = gather_waypoint_index(path, w, jnp.arange(cfg.N))
            horizon = (path.v_ref[idx], path.kappa[idx], path.seg_dist[idx])
            fl = corridor_violation_floor(e, jnp.float32(0.0), horizon, cor,
                                          cfg, model)
            return e, fl

        return jax.vmap(one)(wp, ey)

    wp = rng.integers(0, path.n_wp, batch)
    ey = rng.uniform(-e_y_scale, e_y_scale, batch)
    for _ in range(max_rounds):
        e_fix, fl = check(jnp.asarray(wp, jnp.int32),
                          jnp.asarray(ey, jnp.float32))
        bad = np.asarray(fl) > 0
        ey = np.array(e_fix)
        if not bad.any():
            break
        wp[bad] = rng.integers(0, path.n_wp, int(bad.sum()))
        ey[bad] = rng.uniform(-e_y_scale, e_y_scale, int(bad.sum()))
    else:
        # pathological leftovers: the start waypoint (always feasible)
        e_fix, fl = check(jnp.asarray(wp, jnp.int32),
                          jnp.asarray(ey, jnp.float32))
        bad = np.asarray(fl) > 0
        ey = np.array(e_fix)
        wp[bad] = 0
        ey[bad] = 0.0
    return jnp.asarray(wp, jnp.int32), jnp.asarray(ey, jnp.float32)


def init_fleet(path: PathData, N: int, batch: int,
               e_y0: Optional[jnp.ndarray] = None,
               e_psi0: Optional[jnp.ndarray] = None,
               wp_id0: Optional[jnp.ndarray] = None) -> CarState:
    """Batch of initial states, optionally perturbed per lane (Monte-Carlo)."""
    e_y0 = jnp.zeros(batch) if e_y0 is None else e_y0
    e_psi0 = jnp.zeros(batch) if e_psi0 is None else e_psi0
    wp_id0 = jnp.zeros(batch, jnp.int32) if wp_id0 is None else wp_id0
    return jax.vmap(lambda ey, ep, wp: init_car_state(path, N, ey, ep, wp))(
        e_y0, e_psi0, wp_id0)
