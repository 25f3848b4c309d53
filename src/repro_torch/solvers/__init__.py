"""Analog iterative solvers on the program-once engine (port of
:mod:`repro.solvers`): CG, BiCGSTAB and restarted GMRES (Krylov);
Richardson and Jacobi (stationary); iterative refinement with a digital
outer residual; LSQR and LSMR least squares; PDHG linear programming;
linearized ADMM for box-constrained QPs; Lanczos and LOBPCG extremal
eigenpairs, and ``operator_norm``.  That is all 12 solvers of the
reference registry, and :func:`registry` holds one :class:`SolverSpec`
for each (problem maker, adapter, digital residual recompute), which the
contract suite runs.

Every method is matvec-only (plus ``rmatvec``, the transposed MVM against the
same image, for LSQR, LSMR, PDHG, ADMM and ``operator_norm``; refinement also
reads the digital matrix) and takes ``(n,)`` or ``(n, batch)`` right-hand
sides;
``cg_pipeline``, ``pdhg_pipeline``, ``lsqr_pipeline`` and
``lsmr_pipeline`` return the core each public solver runs (panels in,
the loop's raw outputs back).  ``backend="cuda"`` fuses CG's and
Richardson's update step into a hand-written kernel, also inside
refinement.  An operand that carries no
device (a numpy array, a bare matvec) runs on ``device=``, default
``"cuda"``; a tensor keeps its own device.
"""
from .admm import admm, admm_pipeline, random_box_qp
from .base import LinearOperator, SolveLedger, SolveResult, as_operator
from .eigen import (lanczos, lanczos_pipeline, lobpcg, lobpcg_pipeline,
                    operator_norm)
from .krylov import bicgstab, cg, cg_pipeline, gmres
from .lstsq import lsmr, lsmr_pipeline, lsqr, lsqr_pipeline
from .pdhg import pdhg, pdhg_pipeline, random_feasible_lp
from .refinement import refine
from .registry import SolverSpec, registry
from .stationary import estimate_omega, jacobi, richardson, spectral_bounds

__all__ = ["LinearOperator", "SolveLedger", "SolveResult", "as_operator",
           "cg", "cg_pipeline", "bicgstab", "gmres", "refine", "richardson",
           "jacobi", "spectral_bounds", "estimate_omega", "lsqr",
           "lsqr_pipeline", "lsmr", "lsmr_pipeline", "pdhg", "pdhg_pipeline",
           "random_feasible_lp", "lanczos", "lanczos_pipeline", "lobpcg",
           "lobpcg_pipeline", "operator_norm", "admm", "admm_pipeline",
           "random_box_qp", "SolverSpec", "registry"]
