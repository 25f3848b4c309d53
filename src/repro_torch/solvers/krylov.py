"""Conjugate gradients (port of :func:`repro.solvers.cg`; BiCGSTAB and GMRES
are ROADMAP Queue A5).

The loop is driven from the host and tests convergence after every
iteration -- one device-to-host read of the per-column residuals -- so it
takes exactly the reference ``lax.while_loop``'s iterations.  MVM ``i`` of a
solve uses the key ``fold_in(key, i)`` (MVM 0 is the initial residual).
``backend="cuda"`` runs the x/r update through the ``cg_update`` kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from ..core.prng import fold_in
from .base import (SolveResult, as_operator, as_panel, col_norms, init_history,
                   pack_result, use_cuda)

__all__ = ["cg"]

_TINY = 1e-30


def _cdot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-column inner products of (n, batch) panels -> (batch,)."""
    return torch.sum(u * v, dim=0)


def _unconverged(rel: torch.Tensor, tol: float) -> bool:
    """NaN-robust: a NaN residual (breakdown) counts as not converged."""
    return not bool(torch.all(rel <= tol))


def cg(A, b, *, tol: float = 1e-6, maxiter: int = 200, x0=None,
       key: int = 0, backend: Optional[str] = None,
       device=None) -> SolveResult:
    """Conjugate gradients for SPD ``A``; one MVM per iteration."""
    op = as_operator(A, device=device)
    kernel = use_cuda(backend)
    b, squeeze = as_panel(b, op.device)
    x = torch.zeros_like(b) if x0 is None else as_panel(x0, op.device)[0]
    batch = b.shape[1]
    bn = torch.clamp(col_norms(b), min=_TINY)
    r = b - op.matvec(x, fold_in(key, 0))
    rho = _cdot(r, r)
    rel0 = torch.sqrt(rho) / bn
    rel = rel0
    p = r
    hist = init_history(maxiter, batch, op.device)
    k, mvms = 0, 1
    while k < maxiter and _unconverged(rel, tol):
        ap = op.matvec(p, fold_in(key, 1 + k))
        alpha = rho / torch.clamp(_cdot(p, ap), min=_TINY)
        if kernel:
            x, r = kernels.cg_update(x, r, p, ap, alpha)
        else:
            x = x + alpha[None, :] * p
            r = r - alpha[None, :] * ap
        rho_new = _cdot(r, r)
        beta = rho_new / torch.clamp(rho, min=_TINY)
        p = r + beta[None, :] * p
        rel = torch.sqrt(rho_new) / bn
        hist[k] = rel
        rho = rho_new
        k += 1
        mvms += 1
    return pack_result(op, "cg", x, hist, k, mvms, tol, squeeze, rel0=rel0)
