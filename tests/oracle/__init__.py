"""Float64 numpy oracle: an independent re-derivation of the reference math
(SURVEY.md §3) used as the parity baseline for the JAX implementation.

The environment has no ``osqp`` package, so QP ground truth comes from
:mod:`tests.oracle.qp` — a long-horizon float64 ADMM run to tight tolerance,
verified by explicit KKT residual checks (solver-independent optimality
certificates).
"""
