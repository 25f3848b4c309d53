"""Least squares ``min_x ||A x - b||`` by LSQR and LSMR (port of
:mod:`repro.solvers.lstsq`) on the matvec + rmatvec operator: one corrected
``A @ v`` and one corrected ``A.T @ u`` per iteration against one programmed
(rectangular) image.

  * :func:`lsqr` -- Paige-Saunders: CG on the normal equations, built on the
    Golub-Kahan bidiagonalization;
  * :func:`lsmr` -- Fong-Saunders: MINRES on the normal equations, so
    ``||A'r_k||`` decreases monotonically.

The recorded history (and ``final_residual``) is the normal-equations
relative residual ``||A'(b - A x_k)|| / ||A'b||``, carried by the rotation
recurrences at no extra MVM; it goes to zero for consistent and
inconsistent systems alike.  The loop is host-driven with one convergence
read per iteration, like :func:`~repro_torch.solvers.cg`, so it takes the
reference ``lax.while_loop``'s iterations.  Key folds follow the reference:
``0`` (init ``A x0``), ``1`` (init ``A' u``), ``2 + 2k`` / ``3 + 2k``
(iteration ``k``) and ``900_011`` (the ``||A'b||`` normalization when
``x0`` is given).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.prng import fold_in
from .base import (LinearOperator, SolveResult, as_operator, as_panel,
                   col_norms, init_history, pack_result)

__all__ = ["lsqr", "lsmr"]

_TINY = 1e-30


def _normalize(v: torch.Tensor):
    """(v / ||v||, ||v||) per column, guarded against zero columns."""
    nrm = col_norms(v)
    return v / torch.clamp(nrm, min=_TINY)[None, :], nrm


def _unconverged(rel: torch.Tensor, tol: float) -> bool:
    """NaN-robust: a NaN residual (breakdown) counts as not converged."""
    return not bool(torch.all(rel <= tol))


def _bidiag_init(op: LinearOperator, b, x0, key: int):
    """Golub-Kahan start ``u1 = r0 / beta1``, ``v1 = A'u1 / alpha1``: one
    forward and one transposed MVM; ``alpha1 beta1 = ||A'r0||``."""
    u, beta = _normalize(b - op.matvec(x0, fold_in(key, 0)))
    v, alpha = _normalize(op.rmatvec(u, fold_in(key, 1)))
    return u, v, alpha, beta


def _atb_norm(op: LinearOperator, b, key: int, alpha, beta,
              explicit_x0: bool):
    """``||A'b||``, the denominator of the recorded residual: ``alpha1
    beta1`` for a zero start, one extra transposed MVM for a given ``x0``."""
    if not explicit_x0:
        return torch.clamp(alpha * beta, min=_TINY)
    return torch.clamp(col_norms(op.rmatvec(b, fold_in(key, 900_011))),
                       min=_TINY)


def _bidiag_step(op: LinearOperator, u, v, alpha, key: int, k: int):
    """One Golub-Kahan continuation: ``beta u' = A v - alpha u`` (fold
    2 + 2k), ``alpha' v' = A'u' - beta v`` (fold 3 + 2k)."""
    u, beta = _normalize(op.matvec(v, fold_in(key, 2 + 2 * k))
                         - alpha[None, :] * u)
    v, alpha = _normalize(op.rmatvec(u, fold_in(key, 3 + 2 * k))
                          - beta[None, :] * v)
    return u, beta, v, alpha


def _lsqr_loop(op, b, x, key, tol, maxiter, explicit_x0):
    u, v, alpha, beta = _bidiag_init(op, b, x, key)
    atb = _atb_norm(op, b, key, alpha, beta, explicit_x0)
    rel0 = rel = alpha * beta / atb
    w, rhobar, phibar = v, alpha, beta
    hist = init_history(maxiter, b.shape[1], op.device)
    k = 0
    while k < maxiter and _unconverged(rel, tol):
        u, beta, v, alpha = _bidiag_step(op, u, v, alpha, key, k)
        # Givens rotation eliminating beta from the lower bidiagonal.
        rho = torch.clamp(torch.sqrt(rhobar * rhobar + beta * beta),
                          min=_TINY)
        c, s = rhobar / rho, beta / rho
        theta = s * alpha
        rhobar = -c * alpha
        phi = c * phibar
        phibar = s * phibar
        x = x + (phi / rho)[None, :] * w
        w = v - (theta / rho)[None, :] * w
        # ||A'r_k|| = phibar_{k+1} alpha_{k+1} |c_k| (Paige-Saunders).
        rel = torch.abs(phibar * alpha * c) / atb
        hist[k] = rel
        k += 1
    return x, hist, k, rel0


def _lsmr_loop(op, b, x, key, tol, maxiter, explicit_x0):
    u, v, alpha, beta = _bidiag_init(op, b, x, key)
    atb = _atb_norm(op, b, key, alpha, beta, explicit_x0)
    rel0 = rel = alpha * beta / atb
    ones = torch.ones_like(alpha)
    h, hbar = v, torch.zeros_like(x)
    alphabar, zetabar = alpha, alpha * beta
    cbar, sbar, rho_old, rhobar_old = ones, torch.zeros_like(alpha), ones, ones
    hist = init_history(maxiter, b.shape[1], op.device)
    k = 0
    while k < maxiter and _unconverged(rel, tol):
        u, beta, v, alpha = _bidiag_step(op, u, v, alpha, key, k)
        # First rotation: eliminate beta from the lower bidiagonal.
        rho = torch.clamp(torch.sqrt(alphabar * alphabar + beta * beta),
                          min=_TINY)
        c, s = alphabar / rho, beta / rho
        theta_new = s * alpha
        alphabar = c * alpha
        # Second rotation: the MINRES-style QR of the R factor.
        thetabar = sbar * rho
        rhotemp = cbar * rho
        rhobar = torch.clamp(
            torch.sqrt(rhotemp * rhotemp + theta_new * theta_new), min=_TINY)
        cbar, sbar = rhotemp / rhobar, theta_new / rhobar
        zeta = cbar * zetabar
        zetabar = -sbar * zetabar
        # Solution update through the two-level direction recurrences.
        hbar = h - (thetabar * rho / torch.clamp(rho_old * rhobar_old,
                                                 min=_TINY))[None, :] * hbar
        x = x + (zeta / (rho * rhobar))[None, :] * hbar
        h = v - (theta_new / rho)[None, :] * h
        rho_old, rhobar_old = rho, rhobar
        # ||A'r_k|| = |zetabar_{k+1}|, monotone by construction.
        rel = torch.abs(zetabar) / atb
        hist[k] = rel
        k += 1
    return x, hist, k, rel0


def _lstsq_solve(loop, name: str, A, b, *, tol, maxiter, x0, key,
                 device) -> SolveResult:
    op = as_operator(A, device=device)
    if op.rmatvec is None:
        raise ValueError(
            f"{name} needs an operator with rmatvec (A.T @ u): pass an "
            "AnalogMatrix / dense matrix, or as_operator(mv, shape=..., "
            "rmatvec=...)")
    m, n = op.shape
    bb, squeeze = as_panel(b, op.device)
    if bb.shape[0] != m:
        raise ValueError(f"b has {bb.shape[0]} rows for an operator of shape "
                         f"{op.shape}; expected ({m}, batch)")
    explicit_x0 = x0 is not None
    x = torch.zeros(n, bb.shape[1], dtype=torch.float32, device=op.device) \
        if x0 is None else as_panel(x0, op.device)[0]
    x, hist, k, rel0 = loop(op, bb, x, key, tol, maxiter, explicit_x0)
    # Forward MVMs: init + one per iteration; transposed MVMs mirror them,
    # plus the ||A'b|| normalization when x0 was given.
    return pack_result(op, name, x, hist, k, 1 + k, tol, squeeze, rel0=rel0,
                       mvms_t=1 + k + int(explicit_x0))


def lsqr(A, b, *, tol: float = 1e-4, maxiter: int = 200, x0=None,
         key: int = 0, device=None) -> SolveResult:
    """LSQR for ``min ||A x - b||`` on rectangular ``A``: one corrected
    matvec and one corrected rmatvec per iteration.  ``b`` is (m,) or
    (m, batch), each column its own problem; the history is the
    normal-equations relative residual.  The ledger bills forward and
    transposed MVMs separately against the one image write."""
    return _lstsq_solve(_lsqr_loop, "lsqr", A, b, tol=tol, maxiter=maxiter,
                        x0=x0, key=key, device=device)


def lsmr(A, b, *, tol: float = 1e-4, maxiter: int = 200, x0=None,
         key: int = 0, device=None) -> SolveResult:
    """LSMR for ``min ||A x - b||``: MINRES on the normal equations, so
    ``||A'r||`` decreases monotonically.  Same contract as :func:`lsqr`."""
    return _lstsq_solve(_lsmr_loop, "lsmr", A, b, tol=tol, maxiter=maxiter,
                        x0=x0, key=key, device=device)
