"""Mixed-precision iterative refinement: analog inner solve, digital outer
(port of :mod:`repro.solvers.refinement`).

    r_k = b - A x_k          (digital fp32, the exact matrix A_tilde + dA)
    d_k ~= A^{-1} r_k        (analog inner solve against the programmed image)
    x_{k+1} = x_k + d_k

The inner solve needs only a crude correction, so it runs a few iterations
at a loose tolerance on the analog image; the exact outer residual lets the
pair converge below the analog noise floor that stops a bare Krylov or
stationary solve.  Each outer step costs one digital (n, n) product, a plain
``torch.matmul`` as it is a plain ``@`` in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.prng import fold_in
from .base import (SolveResult, as_operator, col_norms, init_history,
                   pack_result, use_cuda)
from .krylov import _cg_core, _prep
from .stationary import _stationary, spectral_bounds

__all__ = ["refine"]

_TINY = 1e-30


def refine(A, b, *, inner: str = "cg", inner_iters: int = 8,
           inner_tol: float = 1e-2, tol: float = 1e-8, maxiter: int = 20,
           omega: Optional[float] = None, x0=None, key: int = 0,
           a_digital=None, backend: Optional[str] = None,
           device=None) -> SolveResult:
    """Iterative refinement with an analog inner solver.

    ``inner`` is ``"cg"`` or ``"richardson"``, each capped at
    ``inner_iters`` iterations or ``inner_tol``; outer step k's inner solve
    starts from zeros under ``fold_in(key, 500_000 + k)``.  The digital
    matrix is ``a_digital`` or, by default, the operator's reconstruction
    (``A_tilde + dA`` of a programmed image); a bare matvec needs
    ``a_digital=``.  Richardson with ``omega=None`` estimates omega once
    (8 power iterations each way under ``fold_in(key, 900_002)``, billed as
    16 batch-1 MVMs).  ``backend="cuda"`` runs the inner loops' updates
    through the ``cg_update`` / ``richardson_update`` kernels.  The history
    holds the digital relative residual after each outer correction.
    """
    op = as_operator(A, device=device)
    if a_digital is None:
        if op.dense is None:
            raise ValueError(
                "refine needs a_digital= for a bare matvec operator")
        a_digital = op.dense()
    ad = torch.as_tensor(a_digital, dtype=torch.float32, device=op.device)
    if inner not in ("cg", "richardson"):
        raise ValueError(f"unknown inner solver {inner!r}")
    kernel = use_cuda(backend)
    b, x, squeeze = _prep(op, b, x0)

    mvms_single = 0
    if inner == "cg":
        def inner_solve(r, ikey):
            out = _cg_core(op, r, torch.zeros_like(r), ikey, tol=inner_tol,
                           maxiter=inner_iters, kernel=kernel)
            return out[0], out[3]
    else:
        if omega is None:
            # Once for the unchanged operator, not in every outer step.
            pi_iters = 8
            lmin, lmax = spectral_bounds(op, key=fold_in(key, 900_002),
                                         iters=pi_iters)
            omega = 2.0 / (1.05 * lmax + max(lmin, 0.0))
            mvms_single = 2 * pi_iters

        def inner_solve(r, ikey):
            out = _stationary(op, None, r, torch.zeros_like(r), ikey, omega,
                              inner_tol, inner_iters, kernel, 0)
            return out[0], out[2]

    batch = b.shape[1]
    bn = torch.clamp(col_norms(b), min=_TINY)
    r = b - ad @ x                                      # digital, exact
    rel0 = col_norms(r) / bn
    rel = rel0
    hist = init_history(maxiter, batch, op.device)
    k, mvms = 0, 0
    while k < maxiter and not bool(torch.all(rel <= tol)):
        d, inner_mvms = inner_solve(r, fold_in(key, 500_000 + k))
        x = x + d
        r = b - ad @ x                                  # digital, exact
        rel = col_norms(r) / bn
        hist[k] = rel
        k += 1
        mvms += inner_mvms
    return pack_result(op, f"refine[{inner}]", x, hist, k, mvms, tol, squeeze,
                       mvms_single=mvms_single, rel0=rel0)
