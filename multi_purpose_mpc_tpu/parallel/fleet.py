"""Sharded fleet rollout: the multi-chip entry point.

``simulate_fleet_sharded`` runs the closed-loop scan with the fleet axis
split over a ``Mesh`` via ``shard_map``: each device executes the full local
rollout — including the ADMM kernel on GPUs — on its shard of lanes.
Lanes are independent, so the mapped body contains **zero collectives**
(SURVEY.md §2.3); cross-device reductions appear only in
:func:`~multi_purpose_mpc_tpu.parallel.mesh.fleet_metrics`.

``shard_map`` rather than bare GSPMD jit because the hot path is a
``pallas_call`` — a custom kernel the partitioner cannot split; per-shard
manual mapping is the canonical pattern.  The backends follow the MESH's
device platform (:func:`_pin_backends_for_mesh`), so on CPU meshes the local
body runs the XLA solver — which is how the virtual-device tests exercise
this exact code path.
"""

from __future__ import annotations

import functools

import jax
from jax.sharding import Mesh, PartitionSpec as P

from multi_purpose_mpc_tpu.backends import device_platform, select_backends
from multi_purpose_mpc_tpu.config import MPCConfig, ModelConfig, SimConfig
from multi_purpose_mpc_tpu.models.bicycle import CarState
from multi_purpose_mpc_tpu.ops.grid import GridMap
from multi_purpose_mpc_tpu.ops.path import PathData
from multi_purpose_mpc_tpu.parallel.mesh import (
    FLEET_AXIS,
    replicate,
    shard_fleet_state,
)
from multi_purpose_mpc_tpu.simulation import SimResult, simulate_fleet

try:  # jax >= 0.4.35 exposes shard_map at the top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map


def _pin_backends_for_mesh(cfg: MPCConfig, mesh: Mesh) -> MPCConfig:
    """Resolve the compute backends from the MESH's device platform, not
    ``jax.default_backend()``: a CPU mesh built in a GPU process must not
    route its local rollouts into the GPU kernel."""
    import dataclasses

    b = select_backends(device_platform(mesh), solver=cfg.solver_backend,
                        extract=cfg.extract_backend)
    return dataclasses.replace(cfg, solver_backend=b.solver,
                               extract_backend=b.extract)


def simulate_fleet_sharded(mesh: Mesh, grid: GridMap, path: PathData,
                           cfg: MPCConfig, model: ModelConfig, sim: SimConfig,
                           state0: CarState) -> SimResult:
    """Run the fleet rollout with the batch axis sharded over ``mesh``.

    ``state0``'s leading axis must divide evenly across the mesh (see
    ``round_up_batch``).  World data (grid, path) is replicated.
    """
    cfg = _pin_backends_for_mesh(cfg, mesh)
    state0 = shard_fleet_state(state0, mesh)

    # the dynamic-grid path's scanline table carries host-concretized window
    # metadata — build it OUTSIDE the traced shard_map body and replicate
    table = None
    if not sim.static_grid:
        from multi_purpose_mpc_tpu.ops.corridor_extract import build_scanline_table

        table = replicate(
            build_scanline_table(grid, path, cfg.n_scan_samples), mesh)

    grid = replicate(grid, mesh)
    path = replicate(path, mesh)
    return _fleet_rollout(grid, path, state0, table, mesh=mesh, cfg=cfg,
                          model=model, sim=sim)


# Built once per static configuration: jit caches the traced shard_map on
# (mesh, cfg, model, sim), so repeated calls reuse the compiled program.
@functools.partial(jax.jit, static_argnames=("mesh", "cfg", "model", "sim"))
def _fleet_rollout(grid, path, state0, table, *, mesh, cfg, model, sim):
    def local_rollout(grid_l, path_l, state_l, table_l):
        # full per-device rollout on this shard of lanes
        return simulate_fleet(grid_l, path_l, cfg, model, sim, state_l,
                              table=table_l)

    return shard_map(
        local_rollout,
        mesh=mesh,
        in_specs=(P(), P(), P(FLEET_AXIS), P()),
        # final_state: (B, ...) lanes-leading; logs: (T, B, ...) time-leading
        out_specs=SimResult(final_state=P(FLEET_AXIS),
                            log=P(None, FLEET_AXIS)),
        check_vma=False,
    )(grid, path, state0, table)


def simulate_lidar_fleet_sharded(mesh: Mesh, true_grid: GridMap,
                                 known_grid: GridMap, path: PathData,
                                 cfg: MPCConfig, model: ModelConfig,
                                 sim: SimConfig, lidar, state0: CarState,
                                 clear_free: bool = False,
                                 shared_grid: bool = False,
                                 scan_backend: str = "auto",
                                 writeback_backend: str = "auto",
                                 table=None, cells=None):
    """LiDAR-in-the-loop fleet with lanes (and their maps) sharded over
    ``mesh`` — the multi-chip flavor of
    :func:`~multi_purpose_mpc_tpu.simulation.simulate_lidar_fleet`.

    Two grid semantics, two sharding stories:

    * ``shared_grid=False``: per-lane online maps shard WITH their lanes —
      the (B, H, W) map stack is the dominant device-memory state
      (Sim_Track at B=256: 256 MB), so sharding it is what scales the fleet past one
      chip's memory.  Zero collectives (lanes stay independent).
    * ``shared_grid=True``: ONE cooperatively-built map, replicated, with
      each device pooling its local lanes' observation masks and one
      ``pmax`` (= logical-or, commutative) per mask class merging them over
      the device interconnect every step — every device's grid carry stays bitwise identical.
      The semantics match single-device pooling exactly: hit/clear masks
      are or-reduced over ALL lanes before one elementwise update.

    World inputs (true grid, path, scanline/cell tables) are replicated.
    Returns ``(SimResult, final_known_occ)`` with the occupancy sharded
    per-lane or replicated shared, matching the unsharded function.
    """
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from multi_purpose_mpc_tpu.simulation import (resolve_cell_table,
                                                  resolve_lidar_backends)

    cfg = _pin_backends_for_mesh(cfg, mesh)
    if table is None:
        from multi_purpose_mpc_tpu.ops.corridor_extract import build_scanline_table

        tgrid = known_grid  # pure geometry: 2-D frame even for (B, H, W)
        if known_grid.occ.ndim == 3:
            tgrid = known_grid.replace(occ=known_grid.occ[0])
        table = build_scanline_table(tgrid, path, cfg.n_scan_samples)
    scan_backend, writeback_backend = resolve_lidar_backends(
        shared_grid, scan_backend, writeback_backend,
        multi_device=True, platform=device_platform(mesh))
    cells = resolve_cell_table(true_grid, path, lidar, cells, scan_backend)

    B = state0.x.shape[0]
    occ0 = known_grid.occ
    if not shared_grid and occ0.ndim == 2:
        occ0 = jnp.broadcast_to(occ0, (B,) + occ0.shape)
    occ_spec = P() if shared_grid else P(FLEET_AXIS)

    state0 = shard_fleet_state(state0, mesh)
    known_grid = known_grid.replace(
        occ=jax.device_put(occ0, NamedSharding(mesh, occ_spec)))
    true_grid = replicate(true_grid, mesh)
    path = replicate(path, mesh)
    table = replicate(table, mesh)
    if cells is not None:
        cells = jax.device_put(cells, NamedSharding(mesh, P()))
    return _lidar_rollout(
        true_grid, known_grid, path, table, cells, state0, mesh=mesh,
        cfg=cfg, model=model, sim=sim, lidar=lidar, clear_free=clear_free,
        shared_grid=shared_grid, scan_backend=scan_backend,
        writeback_backend=writeback_backend)


@functools.partial(jax.jit, static_argnames=(
    "mesh", "cfg", "model", "sim", "lidar", "clear_free", "shared_grid",
    "scan_backend", "writeback_backend"))
def _lidar_rollout(true_grid, known_grid, path, table, cells, state0, *,
                   mesh, cfg, model, sim, lidar, clear_free, shared_grid,
                   scan_backend, writeback_backend):
    from multi_purpose_mpc_tpu.simulation import _simulate_lidar_fleet

    occ_spec = P() if shared_grid else P(FLEET_AXIS)
    axis_name = FLEET_AXIS if shared_grid else None

    def local_rollout(tg, pth, tbl, cl, kg, state_l):
        return _simulate_lidar_fleet(
            tg, kg, pth, cfg, model, sim, lidar, state_l, tbl, cl,
            clear_free=clear_free, shared_grid=shared_grid,
            scan_backend=scan_backend, writeback_backend=writeback_backend,
            axis_name=axis_name)

    grid_spec = known_grid.replace(occ=occ_spec, origin=P(), resolution=P())
    return shard_map(
        local_rollout,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), grid_spec, P(FLEET_AXIS)),
        out_specs=(SimResult(final_state=P(FLEET_AXIS),
                             log=P(None, FLEET_AXIS)), occ_spec),
        check_vma=False,
    )(true_grid, path, table, cells, known_grid, state0)
