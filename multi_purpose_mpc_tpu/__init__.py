"""multi_purpose_mpc_tpu — a multi-purpose MPC framework on accelerators.

A brand-new JAX/XLA/Pallas implementation of a closed-loop Linear-Time-Variant
MPC stack for autonomous driving, providing the capabilities of the reference
``matssteinweg/Multi-Purpose-MPC`` (reference-path tracking, time-optimal
driving, obstacle avoidance) re-designed as batched array programs:

* all geometry, dynamics, linearization, QP assembly and the QP solver are
  pure-functional, shape-static array programs (``jit``/``vmap``/``lax.scan``);
* the OSQP dependency of the reference is replaced by a batched, on-device
  ADMM solver (dense + block-tridiagonal Riccati-structured variants, plus a
  Pallas GPU kernel for the hot path);
* the closed-loop simulator runs thousands of vehicles per chip under ``vmap``
  and scales over a ``jax.sharding.Mesh`` for multi-chip fleets;
* a thin object-oriented API layer mirrors the reference's
  ``Map / ReferencePath / BicycleModel / MPC`` classes for drop-in use.

Package layout::

    models/    vehicle models + state pytrees (spatial bicycle model)
    ops/       array ops: occupancy grids, rays, paths, corridors, QP/ADMM
    parallel/  fleet batching, mesh sharding, multi-chip rollout
    utils/     host-side asset loading, visualization, checkpointing
    api.py     reference-mirroring object API
    backends.py    the one platform -> compute-backend choice
    simulation.py  closed-loop simulation drivers
"""

from multi_purpose_mpc_tpu.config import (
    MapConfig,
    PathConfig,
    ModelConfig,
    MPCConfig,
    SolverConfig,
    SpeedProfileConstraints,
    SimConfig,
    sim_track_preset,
    real_track_preset,
)
from multi_purpose_mpc_tpu.ops.grid import GridMap, w2m, m2w, add_obstacles, add_boundary
from multi_purpose_mpc_tpu.ops.path import PathData, build_reference_path
from multi_purpose_mpc_tpu.models.bicycle import CarState, init_car_state
from multi_purpose_mpc_tpu.mpc import WeightSet, weights_from_config
from multi_purpose_mpc_tpu.api import (
    Map,
    Obstacle,
    ReferencePath,
    BicycleModel,
    MPC,
    LidarModel,
)

__version__ = "0.1.0"

__all__ = [
    "MapConfig",
    "PathConfig",
    "ModelConfig",
    "MPCConfig",
    "SolverConfig",
    "SpeedProfileConstraints",
    "SimConfig",
    "sim_track_preset",
    "real_track_preset",
    "GridMap",
    "w2m",
    "m2w",
    "add_obstacles",
    "add_boundary",
    "PathData",
    "build_reference_path",
    "CarState",
    "init_car_state",
    "WeightSet",
    "weights_from_config",
    "Map",
    "Obstacle",
    "ReferencePath",
    "BicycleModel",
    "MPC",
    "LidarModel",
]
