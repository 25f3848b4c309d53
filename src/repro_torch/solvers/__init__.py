"""Analog iterative linear solvers on the program-once engine (port of
:mod:`repro.solvers`, main-path subset: CG, Richardson, Jacobi).

Every method is matvec-only and takes ``(n,)`` or ``(n, batch)`` right-hand
sides; ``backend="cuda"`` fuses the update step into a hand-written kernel.
An operand that carries no device (a numpy array, a bare matvec) runs on
``device=``, default ``"cuda"``; a tensor keeps its own device.
"""
from .base import (LinearOperator, SolveLedger, SolveResult, as_operator,
                   col_norms, pack_result)
from .krylov import cg
from .stationary import estimate_omega, jacobi, richardson, spectral_bounds

__all__ = ["LinearOperator", "SolveLedger", "SolveResult", "as_operator",
           "col_norms", "pack_result", "cg", "richardson", "jacobi",
           "spectral_bounds", "estimate_omega"]
