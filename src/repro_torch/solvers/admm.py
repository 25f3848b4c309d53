"""Linearized ADMM for box-constrained quadratic programs (port of
:mod:`repro.solvers.admm`), matvec + rmatvec only.

Solves

    min_x  (1/2) || A x - b ||^2  +  q' x      s.t.  lo <= x <= hi

by splitting ``f(x) = (1/2)||Ax - b||^2 + q'x`` from the box indicator with
the consensus constraint ``x = z`` and linearizing ``f`` in the x-update, so
each iteration is one corrected ``A @ x`` and one corrected ``A.T @ r``
against one programmed image:

    grad  = A'(A x - b) + q
    x_new = x - mu * (grad + rho * (x - z + u))
    z_new = clip(x_new + u, lo, hi)
    u_new = u + x_new - z_new

``mu`` defaults to ``1 / (1.05 (||A||_2^2 + rho))`` with ``||A||_2`` from
PDHG's power iteration (``power_iters`` forward and as many transposed
batch-1 MVMs, billed as setup MVMs).  The recorded history is the KKT
measure at the returned primal iterate,

    ( || x - clip(x - grad, lo, hi) ||  +  || x - z || ) / (1 + ||x||)

per column, with the gradient the iteration just computed; the feasible
split copy ``z`` comes back in ``SolveResult.dual``.  The loop is
host-driven with one convergence read per iteration, like the port's other
solvers, so it takes the reference ``lax.while_loop``'s iterations.  Key
folds follow the reference: ``900_005`` (the power iteration), ``0`` / ``1``
(the init gradient) and ``2 + 2k`` / ``3 + 2k`` (iteration ``k``).  The
power iteration starts from the port's own draw, so with ``mu=None`` the
step differs slightly from the reference's; pass ``mu=`` for exact parity.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.prng import fold_in, generator
from .base import (LinearOperator, SolveResult, as_operator, as_panel,
                   col_norms, init_history, pack_result)
from .pdhg import _power_norm

__all__ = ["admm", "admm_pipeline", "random_box_qp"]


def random_box_qp(seed: int, m: int, n: int, batch: int = 1,
                  active_frac: float = 0.3, *,
                  device="cuda") -> Tuple[torch.Tensor, ...]:
    """A random box-constrained QP with a known optimal point, drawn from
    ``seed`` through a ``torch.Generator`` on ``device``.

    The reference's construction: ``A`` (m, n) Gaussian over ``sqrt(n)``,
    the box ``[-1, 1]^n``, and ``x*`` uniform in ``[-0.9, 0.9]`` except a
    ~``active_frac`` share of its components, which sit on a bound (each
    side with probability 1/2).  The gradient at ``x*`` is drawn to satisfy
    the box KKT conditions (``|N(0, 1)|`` at ``lo``, its negative at
    ``hi``, 0 inside), ``b`` is Gaussian and ``q = g - A'(A x* - b)``, so
    ``x*`` is exactly optimal.  Returns ``(a, b, q, lo, hi, x_star)``, the
    vectors squeezed to 1-D when ``batch == 1``.
    """
    gen = generator(seed, device)
    a = torch.randn((m, n), generator=gen, device=device,
                    dtype=torch.float32) / math.sqrt(float(n))
    b, q, lo, hi, x_star = _box_qp_on(a, gen, batch, active_frac)
    if batch == 1:
        return a, b[:, 0], q[:, 0], lo, hi, x_star[:, 0]
    return a, b, q, lo, hi, x_star


def _box_qp_on(a: torch.Tensor, gen: torch.Generator, batch: int,
               active_frac: float) -> Tuple[torch.Tensor, ...]:
    """``random_box_qp``'s construction on a given (m, n) matrix ``a``, drawn
    from ``gen``: returns ``(b, q, lo, hi, x_star)`` with ``b``, ``q`` and
    ``x_star`` as (., batch) panels and ``x_star`` exactly optimal."""
    m, n = a.shape
    device = a.device

    def draw(fn, *shape):
        return fn(shape, generator=gen, device=device, dtype=torch.float32)

    lo = -torch.ones(n, dtype=torch.float32, device=device)
    hi = torch.ones(n, dtype=torch.float32, device=device)
    interior = draw(torch.rand, n, batch) * 1.8 - 0.9
    active = draw(torch.rand, n, batch) < active_frac
    side = draw(torch.rand, n, batch) < 0.5
    x_star = torch.where(active, torch.where(side, lo[:, None], hi[:, None]),
                         interior)
    mult = torch.abs(draw(torch.randn, n, batch))
    grad = torch.where(active, torch.where(side, mult, -mult),
                       torch.zeros_like(mult))
    b = draw(torch.randn, m, batch)
    q = grad - a.T @ (a @ x_star - b)
    return b, q, lo, hi, x_star


def _admm_core(op: LinearOperator, b, q, x0, key: int, *, lo, hi,
               rho: float, mu, tol: float, maxiter: int, power_iters: int):
    """Returns ``(x, z, hist, k, mvms, pi_mvms, rel0)`` as the reference's
    ``_admm_core`` does."""
    lo_c, hi_c = lo[:, None], hi[:, None]
    if mu is None:
        norm_a = _power_norm(op, fold_in(key, 900_005), power_iters)
        mu_v = 1.0 / (1.05 * (torch.square(norm_a) + rho))
        # Each power step is one forward + one transposed batch-1 MVM,
        # billed apart from the solve's full-batch iterations.
        pi_mvms = power_iters
    else:
        mu_v = torch.tensor(float(mu), dtype=torch.float32, device=op.device)
        pi_mvms = 0

    def kkt(x, z, grad):
        stat = col_norms(x - torch.clamp(x - grad, lo_c, hi_c))
        feas = col_norms(x - z)
        return (stat + feas) / (1.0 + col_norms(x))

    x = x0
    z = torch.clamp(x0, lo_c, hi_c)
    u = torch.zeros_like(x0)
    grad = op.rmatvec(op.matvec(x, fold_in(key, 0)) - b,
                      fold_in(key, 1)) + q
    rel0 = rel = kkt(x, z, grad)
    hist = init_history(maxiter, b.shape[1], op.device)
    k = 0
    while k < maxiter and not bool(torch.all(rel <= tol)):
        x = x - mu_v * (grad + rho * (x - z + u))
        z = torch.clamp(x + u, lo_c, hi_c)
        u = u + x - z
        # The gradient at the new iterate, the iteration's MVM pair, so the
        # recorded measure is that of the (x, z) returned.
        grad = op.rmatvec(op.matvec(x, fold_in(key, 2 + 2 * k)) - b,
                          fold_in(key, 3 + 2 * k)) + q
        rel = kkt(x, z, grad)
        hist[k] = rel
        k += 1
    return x, z, hist, k, 1 + k, pi_mvms, rel0


def admm_pipeline(op: LinearOperator, *, lo: torch.Tensor, hi: torch.Tensor,
                  rho: float = 1.0, mu: Optional[float] = None,
                  tol: float = 1e-4, maxiter: int = 500,
                  power_iters: int = 16):
    """The ADMM core ``(b, q, x0, key) -> (x, z, hist, k, mvms, pi_mvms,
    rel0)``: ``b`` is (m, batch), ``q`` / ``x0`` (n, batch) and ``lo`` /
    ``hi`` (n,) bound vectors on the operator's device; ``mu=None`` adds
    the power-iteration ``||A||_2`` estimate."""
    return functools.partial(_admm_core, op, lo=lo, hi=hi, rho=rho, mu=mu,
                             tol=tol, maxiter=maxiter,
                             power_iters=power_iters)


def _bound(v, n: int, device) -> torch.Tensor:
    """A scalar or (n,) bound as an (n,) float32 vector on ``device``."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.asarray(v, dtype=np.float32))
    return torch.broadcast_to(v.to(device=device, dtype=torch.float32),
                              (n,)).contiguous()


def admm(A, b, q, *, lo, hi, rho: float = 1.0, mu: Optional[float] = None,
         tol: float = 1e-4, maxiter: int = 500, x0=None, key: int = 0,
         power_iters: int = 16, device=None) -> SolveResult:
    """Solve ``min (1/2)||Ax - b||^2 + q'x  s.t.  lo <= x <= hi`` by
    linearized ADMM: one corrected matvec and one corrected rmatvec per
    iteration against the programmed image.

    ``b`` is (m,) or (m, batch) and ``q`` (n,) or (n, batch), each column
    its own QP over the shared bounds ``lo`` / ``hi`` (scalars or (n,)
    vectors).  ``rho`` is the consensus penalty and ``mu`` the linearized
    step (default ``1 / (1.05 (||A||_2^2 + rho))``, the norm from
    ``power_iters`` power-iteration steps billed to the ledger).  Returns a
    :class:`SolveResult` with the stationarity iterate in ``x``, the
    box-feasible split copy in ``dual`` and the KKT history; the ledger
    bills the two directions separately.
    """
    op = as_operator(A, device=device)
    if op.rmatvec is None:
        raise ValueError(
            "admm needs an operator with rmatvec (A.T @ u): pass an "
            "AnalogMatrix / dense matrix, or as_operator(mv, shape=..., "
            "rmatvec=...)")
    m, n = op.shape
    bb, squeeze = as_panel(b, op.device)
    qq, q_vec = as_panel(q, op.device)
    if q_vec != squeeze:
        raise ValueError("b and q must both be vectors or both be panels")
    if bb.shape[0] != m or qq.shape[0] != n:
        raise ValueError(
            f"b has {bb.shape[0]} rows and q {qq.shape[0]} for an operator "
            f"of shape {op.shape}; expected ({m}, batch) and ({n}, batch)")
    if bb.shape[1] != qq.shape[1]:
        raise ValueError(f"b batch {bb.shape[1]} != q batch {qq.shape[1]}")
    lo_v, hi_v = _bound(lo, n, op.device), _bound(hi, n, op.device)
    if bool(torch.any(lo_v > hi_v)):
        raise ValueError("box is empty: lo > hi somewhere")
    x0b = torch.zeros_like(qq) if x0 is None else as_panel(x0, op.device)[0]
    core = admm_pipeline(op, lo=lo_v, hi=hi_v, rho=rho, mu=mu, tol=tol,
                         maxiter=maxiter, power_iters=power_iters)
    x, z, hist, k, mvms, pi_mvms, rel0 = core(bb, qq, x0b, key)
    res = pack_result(op, "admm", x, hist, k, mvms, tol, squeeze,
                      mvms_single=pi_mvms, rel0=rel0, mvms_t=mvms,
                      mvms_single_t=pi_mvms)
    res.dual = z[:, 0] if squeeze else z
    return res
