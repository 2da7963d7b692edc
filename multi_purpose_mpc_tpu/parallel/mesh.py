"""Device-mesh sharding for fleet-scale Monte-Carlo MPC (SURVEY.md §2.3).

The reference is a single-threaded CPU program; the scale axis of the new
framework is the **fleet batch** — thousands of independent car/scenario
lanes.  Lanes never interact, so the sharding story is the simple-and-optimal
one from the GSPMD playbook:

* a 1-D ``Mesh`` over all devices with a single ``"fleet"`` axis;
* every per-lane array (CarState leaves, logs) sharded on its leading batch
  dimension; path/grid data replicated;
* **zero collectives in the hot loop** — XLA partitions the vmapped scan
  trivially; cross-device reductions appear only in metric aggregation
  (``fleet_metrics``) where a ``psum``-style all-reduce rides the device
  interconnect.

Multi-host scale-out uses the same code: ``jax.distributed.initialize`` +
the global mesh makes lanes span hosts (the network enters only at
checkpoint / metric time).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

FLEET_AXIS = "fleet"


def fleet_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or given) devices with a single fleet axis."""
    devices = jax.devices() if devices is None else devices
    import numpy as np

    return Mesh(np.asarray(devices), (FLEET_AXIS,))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Multi-host seam: guarded ``jax.distributed.initialize``.

    Call once per process before any backend use on a multi-host fleet.
    Coordinates come from explicit arguments or from the
    ``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``
    environment variables JAX itself reads.  With neither it no-ops, so
    single-process runs never pay a connection timeout.  Returns True iff
    the distributed runtime was (or already is) initialized.
    """
    import os

    from jax._src import distributed as _dist

    if _dist.global_state.client is not None:  # already initialized
        return True
    if (coordinator_address is None
            and os.environ.get("JAX_COORDINATOR_ADDRESS") is None):
        return False  # single process: nothing to do
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def global_fleet_mesh() -> Mesh:
    """Process-count-aware mesh: one fleet axis over ALL global devices.

    Under ``jax.distributed`` this spans hosts — lanes shard across every
    device of every process, and the (rare) metric all-reduce crosses the
    hosts' network.  Identical to :func:`fleet_mesh` on one
    host, by construction.
    """
    return fleet_mesh(jax.devices())


def local_lane_slice(global_batch: int, process_index: int,
                     process_count: int) -> slice:
    """Which contiguous lane block process ``process_index`` owns.

    Pure logic (unit-testable without multi-host hardware): lanes divide
    evenly across processes in device order, matching how a 1-D mesh over
    ``jax.devices()`` lays out the leading batch axis.  ``global_batch``
    must already be a multiple of ``process_count`` (use
    :func:`round_up_batch` with the global mesh first).
    """
    if global_batch % process_count:
        raise ValueError(
            f"global_batch {global_batch} not divisible by process_count "
            f"{process_count}; round_up_batch first")
    per = global_batch // process_count
    return slice(process_index * per, (process_index + 1) * per)


def fleet_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) dimension across the fleet axis."""
    return NamedSharding(mesh, P(FLEET_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_fleet_state(state, mesh: Mesh):
    """Place a batched CarState pytree with its leading axis sharded."""
    sh = fleet_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sh), state)


def replicate(tree, mesh: Mesh):
    """Replicate path/grid data on every device."""
    sh = replicated(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sh), tree)


def round_up_batch(batch: int, mesh: Mesh) -> int:
    """Lanes must divide evenly across devices; pad the fleet if needed."""
    n = mesh.devices.size
    return ((batch + n - 1) // n) * n


def fleet_metrics(log, length: jnp.ndarray):
    """Cross-fleet aggregates computed on-device.

    Under a sharded fleet these reductions lower to XLA all-reduces over the
    mesh (the only collectives in the system).  Returns a small dict of
    scalars — progress, completion, failure and solver health — the
    observability summary the reference printed ad hoc (SURVEY.md §5).
    """
    active = log.active
    solved = log.ok & active
    n_active_steps = jnp.maximum(active.sum(), 1)
    return {
        "mean_progress": jnp.mean(log.s[-1] / length),
        "laps_done": jnp.mean((log.s[-1] >= length).astype(jnp.float32)),
        "qp_solve_rate": solved.sum() / n_active_steps,
        "mean_speed": (log.v * active).sum() / n_active_steps,
        "max_abs_e_y": jnp.max(jnp.abs(log.e_y * active)),
    }
