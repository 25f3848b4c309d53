"""Analog iterative solvers on the program-once engine (port of
:mod:`repro.solvers`, subset: CG, Richardson, Jacobi; LSQR and LSMR least
squares; PDHG linear programming).

Every method is matvec-only (plus ``rmatvec``, the transposed MVM against the
same image, for LSQR, LSMR and PDHG) and takes ``(n,)`` or ``(n, batch)``
right-hand sides; ``backend="cuda"`` fuses CG's and Richardson's update
step into a hand-written kernel.  An operand that carries no device (a numpy
array, a bare matvec) runs on ``device=``, default ``"cuda"``; a tensor
keeps its own device.
"""
from .base import (LinearOperator, SolveLedger, SolveResult, as_operator,
                   col_norms, pack_result)
from .krylov import cg
from .lstsq import lsmr, lsqr
from .pdhg import pdhg, random_feasible_lp
from .stationary import estimate_omega, jacobi, richardson, spectral_bounds

__all__ = ["LinearOperator", "SolveLedger", "SolveResult", "as_operator",
           "col_norms", "pack_result", "cg", "richardson", "jacobi",
           "spectral_bounds", "estimate_omega", "lsqr", "lsmr", "pdhg",
           "random_feasible_lp"]
