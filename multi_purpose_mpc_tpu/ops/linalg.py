"""Precision-pinned linear algebra helpers.

On an H100, JAX's default precision may run a float32 matrix product in
TF32 on the tensor cores (about three decimal digits), which is fine for
neural nets but fatal for an ADMM solver: per-iteration solve error
accumulates into the scaled dual variable and shifts the fixed point
(measured with bf16-pass matmuls: ~5e-2 solution error on a conditioned QP
that solves to ~1e-5 with exact float32).  Every matmul in a solver path
therefore pins ``precision=HIGHEST`` (full fp32).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


def mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Full-precision matmul (matrix @ matrix or matrix @ vector)."""
    return jnp.matmul(a, b, precision=HIGHEST)


def mv(a: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Full-precision matrix-vector product via einsum (batched-friendly)."""
    return jnp.einsum("...ij,...j->...i", a, x, precision=HIGHEST)


def mtv(a: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Full-precision A^T x."""
    return jnp.einsum("...ij,...i->...j", a, x, precision=HIGHEST)
