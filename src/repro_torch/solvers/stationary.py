"""Stationary iterative methods: Richardson (with auto-``omega``) and Jacobi
(port of :mod:`repro.solvers.stationary`).

Richardson iteration ``x_{k+1} = x_k + omega (b - A x_k)`` against one
programmed image; with ``omega=None`` a matvec-only power iteration
estimates the extremal eigenvalues of an SPD ``A`` and the solve uses
``2 / (1.05 lambda_max + lambda_min)``; :func:`spectral_bounds` and
:func:`estimate_omega` can take the bounds from a Lanczos sweep instead
(``method="lanczos"``).  The loop is host-driven and tests
convergence after every iteration, like the reference's ``while_loop``.
``omega`` stays a device scalar throughout (no ``.item()`` on the path);
``backend="cuda"`` runs the residual and relaxed step through the
``richardson_update`` kernel.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .. import kernels
from ..core.prng import fold_in, generator
from .base import (SolveResult, as_operator, as_panel, col_norms, init_history,
                   pack_result, use_cuda)

__all__ = ["richardson", "jacobi", "spectral_bounds", "estimate_omega"]

_TINY = 1e-30


def _power_iterate(matvec, n: int, key: int, iters: int, device,
                   shift: Optional[torch.Tensor] = None, v0=None):
    """(unit iterate, dominant |eigenvalue|) of A (or shift*I - A) by power
    iteration; the eigenvalue a 0-dim device tensor.  MVM ``i`` uses
    ``fold_in(key, 1 + i)``; the start vector is ``v0`` (n or (n, 1)) or,
    by default, drawn from ``fold_in(key, 0)``.  The iterate seeds
    :func:`repro_torch.solvers.lanczos`; ``v0`` lets a test feed in the
    reference's ``jax.random`` draw."""
    if v0 is None:
        v = torch.randn(n, 1, generator=generator(fold_in(key, 0), device),
                        device=device, dtype=torch.float32)
    else:
        v = as_panel(v0, device)[0]
    v = v / torch.clamp(col_norms(v), min=_TINY)
    lam = torch.zeros((), dtype=torch.float32, device=device)
    for i in range(iters):
        w = matvec(v, fold_in(key, 1 + i))
        if shift is not None:
            w = shift * v - w
        lam = col_norms(w)[0]
        v = w / torch.clamp(lam, min=_TINY)
    return v, lam


def _power_extreme(matvec, n: int, key: int, iters: int, device,
                   shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dominant |eigenvalue| only; see :func:`_power_iterate`."""
    return _power_iterate(matvec, n, key, iters, device, shift=shift)[1]


def _bounds(op, key: int, iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lambda_min, lambda_max) device scalars: lambda_max by power iteration,
    then lambda_max - lambda_min as the dominant eigenvalue of
    ``lambda_max I - A``; ``2 * iters`` MVMs."""
    lmax = _power_extreme(op.matvec, op.n, fold_in(key, 1), iters, op.device)
    mu = _power_extreme(op.matvec, op.n, fold_in(key, 2), iters, op.device,
                        shift=lmax)
    return lmax - mu, lmax


def spectral_bounds(A, *, key: int = 0, iters: int = 16,
                    method: str = "power",
                    device=None) -> Tuple[float, float]:
    """(lambda_min, lambda_max) estimates for SPD ``A``, matvec-only.

    ``method="power"``: power iteration for lambda_max, then on
    ``lambda_max I - A`` for lambda_min; ``2 * iters`` MVMs.
    ``method="lanczos"``: both ends from one sweep of
    :func:`repro_torch.solvers.lanczos` (``max(iters, 2)`` steps at
    ``tol=0``, after its 8 power-iteration seed steps)."""
    op = as_operator(A, device=device)
    if method == "lanczos":
        from .eigen import lanczos
        res = lanczos(op, tol=0.0, maxiter=max(int(iters), 2), key=key)
        return float(res.eigenvalues[0]), float(res.eigenvalues[1])
    if method != "power":
        raise ValueError(f"method must be 'power' or 'lanczos', got "
                         f"{method!r}")
    lmin, lmax = _bounds(op, key, iters)
    return float(lmin), float(lmax)


def estimate_omega(A, *, key: int = 0, iters: int = 16,
                   method: str = "power", device=None) -> float:
    """The auto relaxation factor :func:`richardson` uses when
    ``omega=None`` (with the same key, it is the same value);
    ``method="lanczos"`` takes the bounds from a Lanczos sweep under
    ``key`` instead (see :func:`spectral_bounds`)."""
    if method != "power":   # spectral_bounds refuses an unknown method
        lmin, lmax = spectral_bounds(A, key=key, iters=iters,
                                     method=method, device=device)
        return float(2.0 / (1.05 * lmax + max(lmin, 0.0)))
    lmin, lmax = _bounds(as_operator(A, device=device),
                         fold_in(key, 900_001), iters)
    return float(2.0 / (1.05 * lmax + torch.clamp(lmin, min=0.0)))


def _stationary(op, scale_fn: Optional[Callable], b, x, key: int, omega,
                tol: float, maxiter: int, kernel: bool, power_iters: int):
    """Shared Richardson/Jacobi loop, one MVM per iteration; returns
    ``(x, history, iterations, power-iteration MVMs)``.  ``scale_fn(r)`` maps
    the residual to the update direction (None: identity)."""
    batch = b.shape[1]
    bn = torch.clamp(col_norms(b), min=_TINY)
    if omega is None:
        lmin, lmax = _bounds(op, fold_in(key, 900_001), power_iters)
        om = 2.0 / (1.05 * lmax + torch.clamp(lmin, min=0.0))
        pi_mvms = 2 * power_iters
    else:
        om = torch.tensor(float(omega), dtype=torch.float32, device=op.device)
        pi_mvms = 0
    hist = init_history(maxiter, batch, op.device)
    rel = torch.full((batch,), float("inf"), device=op.device)
    k = 0
    while k < maxiter and not bool(torch.all(rel <= tol)):
        y = op.matvec(x, fold_in(key, k))
        if kernel and scale_fn is None:
            x, r = kernels.richardson_update(x, b, y, om)
        else:
            r = b - y
            step = r if scale_fn is None else scale_fn(r)
            x = x + om * step
        rel = col_norms(r) / bn
        hist[k] = rel
        k += 1
    return x, hist, k, pi_mvms


def richardson(A, b, *, omega: Optional[float] = None, tol: float = 1e-6,
               maxiter: int = 200, x0=None, key: int = 0,
               power_iters: int = 16, backend: Optional[str] = None,
               device=None) -> SolveResult:
    """Richardson iteration ``x += omega * (b - A x)``, matvec-only.

    ``omega=None`` spends ``2 * power_iters`` extra batch-1 MVMs on a
    power-iteration spectral estimate (billed to the ledger as
    ``mvms_single``)."""
    op = as_operator(A, device=device)
    b, squeeze = as_panel(b, op.device)
    x = torch.zeros_like(b) if x0 is None else as_panel(x0, op.device)[0]
    x, hist, k, pi = _stationary(op, None, b, x, key, omega, tol, maxiter,
                                 use_cuda(backend), power_iters)
    return pack_result(op, "richardson", x, hist, k, k, tol, squeeze,
                       mvms_single=pi)


def jacobi(A, b, *, diag=None, omega: float = 1.0, tol: float = 1e-6,
           maxiter: int = 200, x0=None, key: int = 0,
           device=None) -> SolveResult:
    """(Weighted) Jacobi ``x += omega * D^{-1} (b - A x)``; the diagonal is
    ``diag`` or read from the programmed operands (``A_tilde + dA``)."""
    op = as_operator(A, device=device)
    if diag is None:
        if op.dense is None:
            raise ValueError("jacobi needs diag= for a bare matvec operator")
        diag = torch.diagonal(op.dense())
    dinv = (1.0 / torch.as_tensor(diag, dtype=torch.float32)
            .to(op.device))[:, None]
    b, squeeze = as_panel(b, op.device)
    x = torch.zeros_like(b) if x0 is None else as_panel(x0, op.device)[0]
    x, hist, k, _ = _stationary(op, lambda r: dinv * r, b, x, key, omega,
                                tol, maxiter, False, 0)
    return pack_result(op, "jacobi", x, hist, k, k, tol, squeeze)
