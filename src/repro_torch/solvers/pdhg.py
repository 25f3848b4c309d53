"""Primal-dual hybrid gradient (Chambolle-Pock) for linear programs (port of
:mod:`repro.solvers.pdhg`).

Solves the standard-form LP ``min c'x s.t. A x = b, x >= 0`` touching ``A``
only through one corrected ``A.T @ y`` and one corrected ``A @ x`` per
iteration against one programmed image:

    x_{k+1} = proj_+( x_k - tau (c + A'y_k) )
    y_{k+1} = y_k + sigma (A (2 x_{k+1} - x_k) - b)

convergent for ``tau sigma ||A||_2^2 < 1``.  The steps default to
``tau = sigma = eta / ||A||_2`` with the norm estimated by power iteration
on ``A.T A`` (each step one forward and one transposed batch-1 MVM, billed
as setup MVMs).  Convergence is tested per column on the PDLP-style KKT
residual (primal and dual infeasibility, relative duality gap) once per
iteration, from the host; ``A x_{k+1}`` comes from the over-relaxation
identity ``(A x_bar + A x_k) / 2``, so the test costs no MVM.  Key folds
follow the reference: ``900_003`` (power iteration; ``0`` its start vector,
``1 + 2i`` / ``2 + 2i`` its MVMs), ``0`` / ``1`` (init ``A'y0`` / ``A x0``)
and ``2 + 2k`` / ``3 + 2k`` (iteration ``k``).

The reference's ``divergence=`` fault tracking, used by its reliability
wrappers, is not ported here (ROADMAP Queue A10).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..core.prng import fold_in, generator
from .base import (LinearOperator, SolveResult, as_operator, as_panel,
                   col_norms, init_history, pack_result)

__all__ = ["pdhg", "random_feasible_lp"]

_TINY = 1e-30


def random_feasible_lp(seed: int, m: int, n: int, batch: int = 1, *,
                       device="cuda") -> Tuple[torch.Tensor, ...]:
    """A random standard-form LP with a known optimal primal-dual pair, drawn
    from ``seed`` through a ``torch.Generator`` on ``device``.

    The reference's construction: ``A`` (m, n) Gaussian over ``sqrt(n)``,
    a Gaussian ``u`` split into ``x* = max(u, 0)`` and ``s = max(-u, 0)``
    (``s'x* = 0``), a Gaussian ``y*``, ``b = A x*`` and ``c = A'y* + s``:
    ``x*`` is feasible, ``(y*, s)`` dual feasible and complementary, so both
    are optimal with ``c'x* = b'y*``.  Returns ``(a, b, c, x_star,
    y_star)``, the vectors squeezed to 1-D when ``batch == 1``.
    """
    gen = generator(seed, device)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32)

    a = normal(m, n) / math.sqrt(float(n))
    u = normal(n, batch)
    x_star = torch.clamp(u, min=0.0)
    s = torch.clamp(-u, min=0.0)
    y_star = normal(m, batch)
    b = a @ x_star
    c = a.T @ y_star + s
    if batch == 1:
        return a, b[:, 0], c[:, 0], x_star[:, 0], y_star[:, 0]
    return a, b, c, x_star, y_star


def _power_norm(op: LinearOperator, key: int, iters: int) -> torch.Tensor:
    """``||A||_2`` by power iteration on ``A.T A`` (a 0-dim device tensor):
    ``iters`` steps of one matvec and one rmatvec."""
    v = torch.randn(op.shape[1], 1, generator=generator(fold_in(key, 0),
                                                         op.device),
                    device=op.device, dtype=torch.float32)
    v = v / torch.clamp(col_norms(v), min=_TINY)
    lam = torch.zeros((), dtype=torch.float32, device=op.device)
    for i in range(iters):
        w = op.matvec(v, fold_in(key, 1 + 2 * i))
        u = op.rmatvec(w, fold_in(key, 2 + 2 * i))
        lam = col_norms(u)[0]
        v = u / torch.clamp(lam, min=_TINY)
    return torch.sqrt(torch.clamp(lam, min=_TINY))


def _kkt(b, c, bn, cn, x, y, ax, aty) -> torch.Tensor:
    """Per-column KKT residual: the max of primal infeasibility, dual
    infeasibility and the relative duality gap."""
    primal = col_norms(ax - b) / bn
    dual = col_norms(torch.clamp(-(c + aty), min=0.0)) / cn
    pobj = torch.sum(c * x, dim=0)
    dobj = -torch.sum(b * y, dim=0)
    gap = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj) + torch.abs(dobj))
    return torch.maximum(torch.maximum(primal, dual), gap)


def pdhg(A, b, c, *, tol: float = 1e-4, maxiter: int = 2000,
         eta: float = 0.9, tau: Optional[float] = None,
         sigma: Optional[float] = None, x0=None, y0=None, key: int = 0,
         power_iters: int = 16, device=None) -> SolveResult:
    """Solve ``min c'x s.t. A x = b, x >= 0`` by PDHG, matvec/rmatvec-only.

    ``A`` is anything :func:`~repro_torch.solvers.as_operator` accepts that
    has an ``rmatvec``; ``b`` is (m,) or (m, batch) and ``c`` (n,) or
    (n, batch), each column its own LP.  ``tau``/``sigma`` default to
    ``eta / ||A||_2`` (``power_iters`` forward plus as many transposed
    batch-1 setup MVMs).  Returns a :class:`SolveResult` whose ``x`` is the
    primal solution, ``dual`` the dual ``y`` and ``residuals`` the
    per-iteration KKT residual; the ledger bills the two directions
    separately.
    """
    op = as_operator(A, device=device)
    if op.rmatvec is None:
        raise ValueError(
            "pdhg needs an operator with rmatvec (A.T @ y): pass an "
            "AnalogMatrix / dense matrix, or as_operator(mv, shape=..., "
            "rmatvec=...)")
    m, n = op.shape
    bb, squeeze = as_panel(b, op.device)
    cc, c_vec = as_panel(c, op.device)
    if c_vec != squeeze:
        raise ValueError("b and c must both be vectors or both be panels")
    if bb.shape[0] != m or cc.shape[0] != n:
        raise ValueError(
            f"b has {bb.shape[0]} rows and c {cc.shape[0]} for an operator "
            f"of shape {op.shape}; expected ({m}, batch) and ({n}, batch)")
    if bb.shape[1] != cc.shape[1]:
        raise ValueError(f"b batch {bb.shape[1]} != c batch {cc.shape[1]}")
    x = torch.zeros_like(cc) if x0 is None else as_panel(x0, op.device)[0]
    y = torch.zeros_like(bb) if y0 is None else as_panel(y0, op.device)[0]
    bn, cn = 1.0 + col_norms(bb), 1.0 + col_norms(cc)

    if tau is None or sigma is None:
        step = eta / _power_norm(op, fold_in(key, 900_003), power_iters)
        tau_v = step if tau is None else float(tau)
        sigma_v = step if sigma is None else float(sigma)
        pi_mvms = power_iters
    else:
        tau_v, sigma_v, pi_mvms = float(tau), float(sigma), 0

    aty = op.rmatvec(y, fold_in(key, 0))
    ax = op.matvec(x, fold_in(key, 1))
    rel0 = rel = _kkt(bb, cc, bn, cn, x, y, ax, aty)
    hist = init_history(maxiter, bb.shape[1], op.device)
    k = 0
    while k < maxiter and not bool(torch.all(rel <= tol)):
        x_new = torch.clamp(x - tau_v * (cc + aty), min=0.0)
        ax_bar = op.matvec(2.0 * x_new - x, fold_in(key, 2 + 2 * k))
        y = y + sigma_v * (ax_bar - bb)
        aty = op.rmatvec(y, fold_in(key, 3 + 2 * k))
        # A x_{k+1} from x_bar = 2 x_{k+1} - x_k: exact for a digital
        # operator, an averaged estimate for the analog one; no extra MVM.
        ax = 0.5 * (ax_bar + ax)
        x = x_new
        rel = _kkt(bb, cc, bn, cn, x, y, ax, aty)
        hist[k] = rel
        k += 1
    # Forward MVMs: init + one per iteration; the transposed count mirrors
    # it, and the power iteration adds pi_mvms of each at batch 1.
    res = pack_result(op, "pdhg", x, hist, k, 1 + k, tol, squeeze,
                      mvms_single=pi_mvms, rel0=rel0, mvms_t=1 + k,
                      mvms_single_t=pi_mvms)
    res.dual = y[:, 0] if squeeze else y
    return res
