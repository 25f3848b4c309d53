"""Krylov-subspace solvers: CG (SPD), BiCGSTAB and restarted GMRES(m)
(general square A) (port of :mod:`repro.solvers.krylov`).

All three touch ``A`` only through ``matvec(v, key)`` and solve ``(n,)`` or
``(n, batch)`` right-hand sides column by column.  The loops are driven from
the host and test convergence after every iteration (GMRES: every restart
cycle) -- one device-to-host read of the per-column residuals -- so they
take exactly the reference ``lax.while_loop``'s iterations.  The keys
follow the reference's folds: MVM 0 (the initial residual) uses
``fold_in(key, 0)``; CG's MVM of iteration k ``fold_in(key, 1 + k)``;
BiCGSTAB's two ``fold_in(key, 1 + 2k)`` and ``fold_in(key, 2 + 2k)``;
GMRES cycle c keys its Arnoldi step j with ``fold_in(ckey, 10 + j)`` and its
closing residual with ``fold_in(ckey, 1)``, ``ckey = fold_in(key, 1000 + c)``.
``backend="cuda"`` runs CG's x/r update through the ``cg_update`` kernel;
the rest is small vector work in plain PyTorch, as the reference computes it
outside any kernel.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from .. import kernels
from ..core.prng import fold_in
from .base import (LinearOperator, SolveResult, as_operator, as_panel,
                   col_norms, diverged, init_history, pack_result, use_cuda)

__all__ = ["cg", "bicgstab", "gmres", "cg_pipeline"]

_TINY = 1e-30


def _cdot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-column inner products of (n, batch) panels -> (batch,)."""
    return torch.sum(u * v, dim=0)


def _safe(d: torch.Tensor) -> torch.Tensor:
    """Sign-preserving division guard (BiCGSTAB's scalars are signed)."""
    return torch.where(torch.abs(d) < _TINY, _TINY, d)


def _unconverged(rel: torch.Tensor, tol: float) -> bool:
    """NaN-robust: a NaN residual (breakdown) counts as not converged."""
    return not bool(torch.all(rel <= tol))


def _prep(op: LinearOperator, b, x0):
    """(n, batch) float32 panels of ``b`` and the start point (zeros by
    default) on the operator's device, and whether ``b`` was a vector."""
    b, squeeze = as_panel(b, op.device)
    x = torch.zeros_like(b) if x0 is None else as_panel(x0, op.device)[0]
    return b, x, squeeze


# --------------------------------------------------------------------------- #
# Conjugate gradients (SPD)
# --------------------------------------------------------------------------- #

def _cg_core(op: LinearOperator, b: torch.Tensor, x0: torch.Tensor, key: int,
             *, tol: float, maxiter: int, kernel: bool,
             divergence: Optional[float] = None):
    """CG on (n, batch) panels; returns ``(x, history, iterations, MVMs,
    relative residual at entry)`` as the reference's ``_cg_core`` does.
    With a ``divergence`` factor the loop also tracks each column's best
    residual and exits on a NaN or on ``rel > divergence * max(best, tol)``;
    None runs the plain loop."""
    batch = b.shape[1]
    bn = torch.clamp(col_norms(b), min=_TINY)
    x = x0
    r = b - op.matvec(x, fold_in(key, 0))
    rho = _cdot(r, r)
    rel0 = torch.sqrt(rho) / bn
    rel = best = rel0
    p = r
    hist = init_history(maxiter, batch, op.device)
    k, mvms = 0, 1
    while k < maxiter and _unconverged(rel, tol) \
            and not diverged(rel, best, divergence, tol):
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
        if divergence is not None:
            best = torch.minimum(best, rel)
        k += 1
        mvms += 1
    return x, hist, k, mvms, rel0


def cg_pipeline(op: LinearOperator, *, tol: float = 1e-6, maxiter: int = 200,
                backend: Optional[str] = None,
                divergence: Optional[float] = None):
    """The CG core ``(b, x0, key) -> (x, hist, k, mvms, rel0)`` that
    :func:`cg` runs, on (n, batch) panels ``b`` and ``x0`` on the operator's
    device; ``backend="cuda"`` takes the ``cg_update`` kernel.  ``k`` and
    ``mvms`` are Python ints (the reference's are int32 arrays)."""
    return functools.partial(_cg_core, op, tol=tol, maxiter=maxiter,
                             kernel=use_cuda(backend), divergence=divergence)


def cg(A, b, *, tol: float = 1e-6, maxiter: int = 200, x0=None,
       key: int = 0, backend: Optional[str] = None,
       divergence: Optional[float] = None, device=None) -> SolveResult:
    """Conjugate gradients for SPD ``A``; one MVM per iteration.

    ``divergence`` (a factor) exits early on a NaN or on a residual above
    ``divergence`` x the best seen (the reliability wrappers' in-loop fault
    detector); the default None keeps the plain loop."""
    op = as_operator(A, device=device)
    core = cg_pipeline(op, tol=tol, maxiter=maxiter, backend=backend,
                       divergence=divergence)
    b, x, squeeze = _prep(op, b, x0)
    x, hist, k, mvms, rel0 = core(b, x, key)
    return pack_result(op, "cg", x, hist, k, mvms, tol, squeeze, rel0=rel0)


# --------------------------------------------------------------------------- #
# BiCGSTAB (general square A)
# --------------------------------------------------------------------------- #

def bicgstab(A, b, *, tol: float = 1e-6, maxiter: int = 200, x0=None,
             key: int = 0, device=None) -> SolveResult:
    """BiCGSTAB for general square ``A``; two MVMs per iteration, against a
    fixed shadow residual ``r0``."""
    op = as_operator(A, device=device)
    b, x, squeeze = _prep(op, b, x0)
    batch = b.shape[1]
    bn = torch.clamp(col_norms(b), min=_TINY)
    r = b - op.matvec(x, fold_in(key, 0))
    rhat = r
    rho = alpha = w = torch.ones(batch, dtype=torch.float32, device=op.device)
    p = v = torch.zeros_like(b)
    rel0 = col_norms(r) / bn
    rel = rel0
    hist = init_history(maxiter, batch, op.device)
    k, mvms = 0, 1
    while k < maxiter and _unconverged(rel, tol):
        rho_new = _cdot(rhat, r)
        beta = (rho_new / _safe(rho)) * (alpha / _safe(w))
        p = r + beta[None, :] * (p - w[None, :] * v)
        v = op.matvec(p, fold_in(key, 1 + 2 * k))
        alpha = rho_new / _safe(_cdot(rhat, v))
        s = r - alpha[None, :] * v
        t = op.matvec(s, fold_in(key, 2 + 2 * k))
        w = _cdot(t, s) / _safe(_cdot(t, t))
        x = x + alpha[None, :] * p + w[None, :] * s
        r = s - w[None, :] * t
        rel = col_norms(r) / bn
        hist[k] = rel
        rho = rho_new
        k += 1
        mvms += 2
    return pack_result(op, "bicgstab", x, hist, k, mvms, tol, squeeze,
                       rel0=rel0)


# --------------------------------------------------------------------------- #
# Restarted GMRES(m) (general square A)
# --------------------------------------------------------------------------- #

def _gmres_cycle(op: LinearOperator, x: torch.Tensor, r: torch.Tensor,
                 key: int, m: int) -> torch.Tensor:
    """One Arnoldi(m) + least-squares correction, in the reference's fixed
    shapes: the Krylov basis V is (m+1, n, batch) with the unfilled rows
    zero, and the projections mask by position (``rows <= j``)."""
    n, batch = r.shape
    dev = r.device
    beta = col_norms(r)
    V = torch.zeros(m + 1, n, batch, dtype=torch.float32, device=dev)
    V[0] = r / torch.clamp(beta, min=_TINY)[None, :]
    H = torch.zeros(m + 1, m, batch, dtype=torch.float32, device=dev)
    rows = torch.arange(m + 1, device=dev)
    for j in range(m):
        w = op.matvec(V[j], fold_in(key, 10 + j))
        # Classical Gram-Schmidt against the filled basis, twice (CGS2).
        mask = (rows <= j).to(torch.float32)[:, None]
        h1 = torch.einsum("inb,nb->ib", V, w) * mask
        w = w - torch.einsum("ib,inb->nb", h1, V)
        h2 = torch.einsum("inb,nb->ib", V, w) * mask
        w = w - torch.einsum("ib,inb->nb", h2, V)
        hnorm = col_norms(w)
        hcol = h1 + h2 + (rows == j + 1).to(torch.float32)[:, None] * hnorm
        V[j + 1] = w / torch.clamp(hnorm, min=_TINY)[None, :]
        H[:, j] = hcol
    # Per-column least squares min ||beta e1 - H y|| through the reference's
    # ridge normal equations in fp32 (not a QR: another algorithm, which can
    # move the cycle count).
    Hb = torch.movedim(H, -1, 0)                        # (batch, m+1, m)
    rhs = torch.zeros(batch, m + 1, dtype=torch.float32, device=dev)
    rhs[:, 0] = beta
    gram = torch.einsum("bij,bik->bjk", Hb, Hb) \
        + 1e-12 * torch.eye(m, dtype=torch.float32, device=dev)
    hty = torch.einsum("bij,bi->bj", Hb, rhs)
    y = torch.linalg.solve(gram, hty[..., None])[..., 0]   # (batch, m)
    return x + torch.einsum("bj,jnb->nb", y, V[:m])


def gmres(A, b, *, restart: int = 20, tol: float = 1e-6, maxiter: int = 200,
          x0=None, key: int = 0, device=None) -> SolveResult:
    """Restarted GMRES(m) for general square ``A``.

    ``maxiter`` bounds the MVMs: ``max(1, ceil(maxiter / restart))`` cycles
    of ``restart + 1`` MVMs each.  ``SolveResult.iterations`` and the
    residual history are per *cycle*.
    """
    op = as_operator(A, device=device)
    b, x, squeeze = _prep(op, b, x0)
    batch = b.shape[1]
    bn = torch.clamp(col_norms(b), min=_TINY)
    ncycles = max(1, -(-maxiter // restart))
    r = b - op.matvec(x, fold_in(key, 0))
    rel0 = col_norms(r) / bn
    rel = rel0
    hist = init_history(ncycles, batch, op.device)
    c, mvms = 0, 1
    while c < ncycles and _unconverged(rel, tol):
        ckey = fold_in(key, 1000 + c)
        x = _gmres_cycle(op, x, r, ckey, restart)
        r = b - op.matvec(x, fold_in(ckey, 1))
        rel = col_norms(r) / bn
        hist[c] = rel
        c += 1
        mvms += restart + 1
    return pack_result(op, "gmres", x, hist, c, mvms, tol, squeeze, rel0=rel0)
