"""Tracing / profiling hooks (SURVEY.md §5: the reference's only timing is
``time.time()`` prints in the lidar scan; lidar_model.py:45, 111-112).

Two layers:
* :func:`trace` — context manager around ``jax.profiler`` for device traces
  (open the output in XProf/TensorBoard or Perfetto for per-kernel times);
* :func:`time_stages` — wall-clock timing of jitted stage functions, each
  call fenced with ``jax.block_until_ready``, for quick per-stage breakdowns
  (linearize / corridor / QP-solve / integrate).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable, Dict

import jax


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """Capture a device profile: ``with trace(): run_step()``."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "mpc_trace")
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def timeit(fn: Callable, *args, warmup: int = 2, iters: int = 10,
           **kwargs) -> float:
    """Median wall-clock seconds per call of a jitted function (each call
    waits for its outputs with ``jax.block_until_ready``)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def time_stages(stages: Dict[str, Callable], warmup: int = 2,
                iters: int = 10) -> Dict[str, float]:
    """Time a dict of thunks; returns {name: median_seconds}."""
    return {name: timeit(fn, warmup=warmup, iters=iters)
            for name, fn in stages.items()}
