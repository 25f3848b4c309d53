"""Extremal eigenpair solvers: Lanczos and LOBPCG on the analog operator
(port of :mod:`repro.solvers.eigen`).

The iteration touches ``A`` only through MVMs against the one programmed
image, and what comes back feeds the step sizes of the other solvers:
Richardson's ``2 / (1.05 lambda_max + lambda_min)``
(``estimate_omega(method="lanczos")``) and PDHG's ``eta / ||A||_2``.

  * :func:`lanczos` -- both extremal eigenpairs of a symmetric operator from
    one Krylov sweep, seeded by the power iteration of
    :mod:`repro_torch.solvers.stationary` (``seed_iters`` batch-1 MVMs),
    fully reorthogonalised against a zero-filled ``(n, maxiter)`` basis, with
    the Ritz pairs taken each step from the ``eigh`` of the fixed-shape
    masked tridiagonal, padded on the diagonal with the mean of the seen
    alphas, as the reference does.
  * :func:`lobpcg` -- a block of ``k`` extremal eigenpairs; each iteration
    is one batched ``[X | R | P]`` MVM of ``3k`` columns.  The ``cuda``
    engine launches ``ec_matmul`` on at most
    :data:`~repro_torch.kernels.rram_mvm.MAX_KERNEL_BATCH` (8) columns, so
    for ``k >= 3`` a panel splits into two launches that each read the
    image again.
  * :func:`operator_norm` -- ``||A||_2`` of a rectangular operator: Lanczos
    on ``[[0, A], [A', 0]]``, one forward and one transposed MVM a step.

Both solvers record the relative Ritz residual ``||A y - theta y|| /
|theta|`` per pair as the history, bill every MVM to the ledger, and stop
on a NaN-robust test with one host read a step.  Keys are the port's
integers: Lanczos seeds from ``fold_in(key, 900_007)`` and keys step ``k``
``fold_in(key, k)``; LOBPCG keys its entry MVM ``fold_in(key, 0)`` and
iteration ``k`` ``fold_in(key, 1 + k)``, and draws its default start block
from ``fold_in(key, 900_009)``.  The draws cannot match ``jax.random``, so
``lanczos(v0=)`` takes the power iteration's start vector and ``lobpcg(x0=)``
the start block (tests feed in the reference's).  Eigenvectors carry no
sign convention: ``eigh`` may flip a column between implementations, and
the Ritz residual does not see it.  The small ``eigh`` / ``qr`` calls run on
the operator's device, like the rest of the path.
"""
from __future__ import annotations

import functools

import torch

from ..core.prng import fold_in, generator
from .base import (LinearOperator, SolveResult, as_operator, as_panel,
                   col_norms, init_history, pack_result)
from .stationary import _power_iterate

__all__ = ["lanczos", "lobpcg", "operator_norm", "lanczos_pipeline",
           "lobpcg_pipeline"]

_TINY = 1e-30


def _unconverged(rel: torch.Tensor, tol: float) -> bool:
    """NaN-robust: a NaN Ritz residual (breakdown) counts as not converged."""
    return not bool(torch.all(rel <= tol))


def _ritz_rel(resid: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    return resid / torch.clamp(torch.abs(theta), min=_TINY)


# --------------------------------------------------------------------------- #
# Lanczos
# --------------------------------------------------------------------------- #

def _lanczos_core(op: LinearOperator, key: int, v0=None, *, tol: float,
                  maxiter: int, seed_iters: int):
    """Returns ``(Y, theta, history, steps, MVMs)`` as the reference's
    ``_lanczos_core`` does."""
    n, m, dev = op.n, maxiter, op.device
    # The power iterate is rich in the top eigenvector; Lanczos refines it
    # and pulls out the bottom of the spectrum at the same time.
    vk, _ = _power_iterate(op.matvec, n, fold_in(key, 900_007), seed_iters,
                           dev, v0=v0)
    idx = torch.arange(m, device=dev)
    basis = torch.zeros(n, m, dtype=torch.float32, device=dev)
    v_prev = torch.zeros_like(vk)
    beta_prev = torch.zeros((), dtype=torch.float32, device=dev)
    alphas = torch.zeros(m, dtype=torch.float32, device=dev)
    betas = torch.zeros(m, dtype=torch.float32, device=dev)
    y_pair = torch.zeros(n, 2, dtype=torch.float32, device=dev)
    theta2 = torch.zeros(2, dtype=torch.float32, device=dev)
    hist = init_history(m, 2, dev)
    rel = torch.full((2,), float("inf"), device=dev)
    k = 0
    while k < maxiter and _unconverged(rel, tol):
        w = op.matvec(vk, fold_in(key, k))
        alpha = torch.sum(vk * w)
        w = w - alpha * vk - beta_prev * v_prev
        # Full reorthogonalisation; the unfilled columns are zero.
        w = w - basis @ (basis.T @ w)
        beta = col_norms(w)[0]
        alphas[k] = alpha
        betas[k] = beta
        basis[:, k] = vk[:, 0]
        # The active (k+1)-block of T, padded on the diagonal with the mean
        # of the seen alphas (inside its spectrum) and decoupled from it: the
        # extremal eigenpairs are the active block's.
        pad = torch.sum(alphas) / (k + 1)
        diag = torch.where(idx <= k, alphas, pad)
        off = torch.where(idx[:-1] < k, betas[:-1], 0.0)
        t_mat = torch.diag(diag) + torch.diag(off, 1) + torch.diag(off, -1)
        theta, s_mat = torch.linalg.eigh(t_mat)
        s_pair = torch.stack([s_mat[:, 0], s_mat[:, -1]], dim=1)
        theta2 = torch.stack([theta[0], theta[-1]])
        # ||A y - theta y|| = |beta_k s[k]|, the pair's last active row.
        rel = _ritz_rel(torch.abs(beta * s_pair[k, :]), theta2)
        if k < 1:   # one step cannot separate the ends of the spectrum
            rel = torch.full_like(rel, float("inf"))
        hist[k] = rel
        y_pair = basis @ s_pair
        v_prev, vk = vk, w / torch.clamp(beta, min=_TINY)
        beta_prev = beta
        k += 1
    return y_pair, theta2, hist, k, seed_iters + k


def lanczos_pipeline(op: LinearOperator, *, tol: float = 1e-4,
                     maxiter: int = 48, seed_iters: int = 8):
    """The Lanczos core ``(key, v0=None) -> (Y, theta, hist, k, mvms)``:
    ``Y`` the (n, 2) [bottom | top] Ritz panel, ``theta`` the (2,)
    estimates."""
    return functools.partial(_lanczos_core, op, tol=tol, maxiter=maxiter,
                             seed_iters=seed_iters)


def lanczos(A, *, tol: float = 1e-4, maxiter: int = 48, seed_iters: int = 8,
            key: int = 0, v0=None, device=None) -> SolveResult:
    """Both extremal eigenpairs of a symmetric operator, matvec-only.

    ``x`` is the (n, 2) panel of [lambda_min | lambda_max] eigenvectors and
    ``eigenvalues`` the (2,) estimates, ascending; the history is the
    relative Ritz residual per pair.  Every MVM (``seed_iters`` seed steps,
    then one a Lanczos step) is batch 1, billed as ``mvms_single``.  ``v0``
    is the power iteration's start vector (default: drawn from the key).
    """
    op = as_operator(A, device=device)
    m_, n_ = op.shape
    if m_ != n_:
        raise ValueError(
            f"lanczos needs a symmetric (square) operator, got {op.shape}; "
            "for rectangular A use operator_norm (singular values)")
    if maxiter < 2:
        raise ValueError("lanczos needs maxiter >= 2")
    core = lanczos_pipeline(op, tol=tol, maxiter=maxiter,
                            seed_iters=seed_iters)
    y_pair, theta2, hist, k, mvms = core(key, v0)
    res = pack_result(op, "lanczos", y_pair, hist, k, 0, tol, squeeze=False,
                      mvms_single=mvms)
    res.eigenvalues = theta2
    return res


# --------------------------------------------------------------------------- #
# LOBPCG
# --------------------------------------------------------------------------- #

def _rayleigh_ritz(s_basis: torch.Tensor, a_s: torch.Tensor, nev: int,
                   largest: bool):
    """The ``nev`` extremal Ritz ``(theta, X, AX)`` of the projected operator
    on an orthonormal basis, theta ascending; ``AX`` from ``A @ basis``."""
    m_proj = s_basis.T @ a_s
    m_proj = 0.5 * (m_proj + m_proj.T)
    theta, c_mat = torch.linalg.eigh(m_proj)
    sel = slice(-nev, None) if largest else slice(None, nev)
    c_sel = c_mat[:, sel]
    return theta[sel], s_basis @ c_sel, a_s @ c_sel


def _lobpcg_core(op: LinearOperator, x0: torch.Tensor, key: int, *,
                 tol: float, maxiter: int, largest: bool):
    """Returns ``(X, theta, history, iterations, MVMs, rel0)`` as the
    reference's ``_lobpcg_core`` does."""
    nev = x0.shape[1]
    x_blk, _ = torch.linalg.qr(x0)
    ax_blk = op.matvec(x_blk, fold_in(key, 0))
    theta, x_blk, ax_blk = _rayleigh_ritz(x_blk, ax_blk, nev, largest)
    rel0 = _ritz_rel(col_norms(ax_blk - x_blk * theta[None, :]), theta)
    rel = rel0
    p_blk = torch.zeros_like(x_blk)
    hist = init_history(maxiter, nev, op.device)
    k, mvms = 0, 1
    while k < maxiter and _unconverged(rel, tol):
        r_blk = ax_blk - x_blk * theta[None, :]
        s_basis, _ = torch.linalg.qr(torch.cat([x_blk, r_blk, p_blk], dim=1))
        # The whole [X | R | P] subspace in one batched MVM.
        a_s = op.matvec(s_basis, fold_in(key, 1 + k))
        theta, x_new, ax_new = _rayleigh_ritz(s_basis, a_s, nev, largest)
        # Conjugate-direction memory: the part of the step outside old X.
        p_blk = x_new - x_blk @ (x_blk.T @ x_new)
        rel = _ritz_rel(col_norms(ax_new - x_new * theta[None, :]), theta)
        hist[k] = rel
        x_blk, ax_blk = x_new, ax_new
        # The 3k-column panel bills as three k-column MVMs.
        k, mvms = k + 1, mvms + 3
    return x_blk, theta, hist, k, mvms, rel0


def lobpcg_pipeline(op: LinearOperator, *, tol: float = 1e-4,
                    maxiter: int = 100, largest: bool = True):
    """The LOBPCG core ``(x0, key) -> (X, theta, hist, k, mvms, rel0)``;
    ``x0`` is the (n, k) starting block."""
    return functools.partial(_lobpcg_core, op, tol=tol, maxiter=maxiter,
                             largest=largest)


def lobpcg(A, k: int = 1, *, which: str = "largest", tol: float = 1e-4,
           maxiter: int = 100, x0=None, key: int = 0,
           device=None) -> SolveResult:
    """``k`` extremal eigenpairs of a symmetric operator by LOBPCG.

    ``which`` is ``"largest"`` or ``"smallest"``.  Each iteration is one
    batched 3k-column MVM (billed as three k-column MVMs), after one
    k-column MVM at entry.  ``x`` is the (n, k) eigenvector block ((n,) for
    ``k=1`` without ``x0``, or for a vector ``x0``) and ``eigenvalues`` the
    estimates, ascending.
    """
    op = as_operator(A, device=device)
    m_, n_ = op.shape
    if m_ != n_:
        raise ValueError(
            f"lobpcg needs a symmetric (square) operator, got {op.shape}")
    if which not in ("largest", "smallest"):
        raise ValueError(f"which must be 'largest' or 'smallest', got "
                         f"{which!r}")
    if not 1 <= k <= n_ // 3:
        raise ValueError(
            f"lobpcg needs 1 <= k <= n//3 (the [X|R|P] subspace must fit), "
            f"got k={k} for n={n_}")
    if x0 is None:
        x0b = torch.randn(n_, k, generator=generator(fold_in(key, 900_009),
                                                     op.device),
                          device=op.device, dtype=torch.float32)
        squeeze = k == 1
    else:
        x0b, squeeze = as_panel(x0, op.device)
        if tuple(x0b.shape) != (n_, k):
            raise ValueError(f"x0 has shape {tuple(x0b.shape)}, expected "
                             f"({n_}, {k})")
    core = lobpcg_pipeline(op, tol=tol, maxiter=maxiter,
                           largest=(which == "largest"))
    x_blk, theta, hist, it, mvms, rel0 = core(x0b, key)
    res = pack_result(op, "lobpcg", x_blk, hist, it, mvms, tol,
                      squeeze=squeeze, rel0=rel0)
    res.eigenvalues = theta
    return res


# --------------------------------------------------------------------------- #
# ||A||_2 of a rectangular operator
# --------------------------------------------------------------------------- #

def _augmented(op: LinearOperator) -> LinearOperator:
    """``H = [[0, A], [A', 0]]``, whose eigenvalues are +/- the singular
    values of ``A``: one H-matvec is a forward MVM keyed ``fold_in(key, 0)``
    and a transposed one keyed ``fold_in(key, 1)`` against the same image."""
    m, n = op.shape

    def aug_mv(v, key):
        top = op.matvec(v[m:], fold_in(key, 0))
        bot = op.rmatvec(v[:m], fold_in(key, 1))
        return torch.cat([top, bot], dim=0)

    return LinearOperator(
        matvec=aug_mv, rmatvec=aug_mv, shape=(m + n, m + n),
        write_stats=op.write_stats, input_stats=op.input_stats,
        input_stats_t=op.input_stats_t, dense=None, analog=op.analog,
        device=op.device)


def operator_norm(A, *, tol: float = 1e-3, maxiter: int = 32, key: int = 0,
                  v0=None, device=None) -> float:
    """``||A||_2`` (the largest singular value) of a rectangular operator:
    :func:`lanczos` on ``[[0, A], [A', 0]]``, each step one forward and one
    transposed MVM.  ``v0`` is Lanczos's start vector, of length m + n.
    Typical use: ``step = 0.9 / operator_norm(A)``, then
    ``pdhg(A, b, c, tau=step, sigma=step)``."""
    op = as_operator(A, device=device)
    if op.rmatvec is None:
        raise ValueError("operator_norm needs an operator with rmatvec")
    res = lanczos(_augmented(op), tol=tol, maxiter=maxiter, key=key, v0=v0)
    return float(res.eigenvalues[1])
