"""The one place that picks compute backends from the device platform.

Every ``"auto"`` backend in the package resolves here, from the platform of
the devices the program runs on (``jax.default_backend()``, or a mesh's
device platform for sharded rollouts):

* ``gpu``: the Pallas-Triton ADMM kernel (:mod:`~.ops.admm_kernel`) for the
  QP solve, the ``march`` LiDAR scan, the ``scatter`` map write-back and the
  ``gather`` scanline extraction;
* ``cpu``: the same, with the XLA stage-scan solver
  (:func:`~.ops.ltv_qp.solve_ltv_qp` under ``vmap``) in place of the kernel.

Explicit requests are validated: asking for the kernel on a platform that
cannot compile it raises — it never falls back to the reference solver and
never runs in interpret mode (only tests reach interpret mode, through the
kernel's own ``interpret=`` argument).
"""

from __future__ import annotations

from typing import NamedTuple

import jax


class Backends(NamedTuple):
    solver: str  # "kernel" | "xla"
    extract: str  # dynamic-grid scanline extraction: "gather" | "onehot"
    scan: str  # LiDAR fleet scan: "march" | "cells"
    writeback: str  # LiDAR map write-back: "scatter" | "dense"


_CHOICES = Backends(solver=("kernel", "xla"), extract=("gather", "onehot"),
                    scan=("march", "cells"), writeback=("scatter", "dense"))
_KERNEL_PLATFORMS = ("gpu",)


def device_platform(mesh=None) -> str:
    """Platform of the mesh's devices, else of JAX's default backend."""
    if mesh is not None:
        return mesh.devices.flat[0].platform
    return jax.default_backend()


def select_backends(platform: str, solver: str = "auto",
                    extract: str = "auto", scan: str = "auto",
                    writeback: str = "auto") -> Backends:
    """Resolve every backend for ``platform``; ``"auto"`` takes the
    platform's default, anything else is validated."""
    defaults = Backends(
        solver="kernel" if platform in _KERNEL_PLATFORMS else "xla",
        extract="gather", scan="march", writeback="scatter")
    chosen = Backends(solver, extract, scan, writeback)
    out = []
    for name, want, default, allowed in zip(Backends._fields, chosen,
                                            defaults, _CHOICES):
        if want == "auto":
            want = default
        if want not in allowed:
            raise ValueError(f"unknown {name} backend {want!r}; expected "
                             f"'auto' or one of {allowed}")
        out.append(want)
    resolved = Backends(*out)
    if resolved.solver == "kernel" and platform not in _KERNEL_PLATFORMS:
        raise ValueError(
            f"the ADMM kernel compiles only for {_KERNEL_PLATFORMS}, not "
            f"{platform!r}; use solver_backend='xla' or 'auto'")
    return resolved
