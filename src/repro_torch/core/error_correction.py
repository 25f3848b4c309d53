"""Two-tier error correction (port of :mod:`repro.core.error_correction`).

Tier 1 -- first-order cancellation (paper Eq. 4-7): with Ã = A(1+eps_A) and
x̃ = x(1+eps_x), ``p = Ãx + Ax̃ - Ãx̃ = Ax(1 - eps_A eps_x)``; ``fused`` mode
computes the same as ``Ã(x - x̃) + Ax̃`` (two products instead of three).

Tier 2 -- second-order denoising (paper Eq. 8-10, Algorithm 5):
``y = (I + lam L^T L)^{-1} p`` with ``L = I + h * superdiag``.  Three methods:
``dense`` (the paper's explicit inverse), ``thomas`` (exact O(n) tridiagonal
solve) and ``neumann`` (``p - lam (L^T L) p``, exact to O(lam^2), a 3-point
stencil; the default and what the ``cuda`` backend runs as a kernel).

End to end on pre-encoded operands: :func:`corrected_matvecmul` (``A @ x``)
and :func:`corrected_matmul` (row-major ``x @ W``, the LM layers' form).
"""
from __future__ import annotations

import torch

__all__ = [
    "first_order_correct",
    "build_l_matrix",
    "tridiag_coeffs",
    "stencil_apply",
    "denoise_least_square",
    "corrected_matvecmul",
    "corrected_matmul",
]


def first_order_correct(a, a_tilde, x, x_tilde, *, mode: str = "fused"):
    """p = Ãx + Ax̃ - Ãx̃ (paper Eq. 7); ``x`` a vector or (n, batch) panel."""
    if mode == "faithful":
        return a_tilde @ x + a @ x_tilde - a_tilde @ x_tilde
    if mode == "fused":
        return a_tilde @ (x - x_tilde) + a @ x_tilde
    raise ValueError(f"unknown first-order EC mode {mode!r}")


def build_l_matrix(n: int, h: float = -1.0, *, device=None) -> torch.Tensor:
    """First-order differential matrix L: 1 on diag, h on superdiag (Eq. 9)."""
    eye = torch.eye(n, dtype=torch.float32, device=device)
    return eye + h * torch.diag(torch.ones(n - 1, dtype=torch.float32,
                                           device=device), 1)


def tridiag_coeffs(n: int, lam: float, h: float = -1.0, *, device=None):
    """(sub, diag, super) diagonals of M = I + lam * L^T L (float32)."""
    diag = torch.full((n,), 1.0 + lam * (1.0 + h * h), dtype=torch.float32,
                      device=device)
    diag[0] = 1.0 + lam
    off = torch.full((n - 1,), lam * h, dtype=torch.float32, device=device)
    return off, diag, off


def stencil_apply(v: torch.Tensor, h: float) -> torch.Tensor:
    """(L^T L) v as a 3-point stencil down the rows of ``v``:
    ``(1+h^2) v_i + h (v_{i-1} + v_{i+1})``, row 0 diagonal 1, zero beyond
    the ends."""
    up = torch.zeros_like(v)
    up[:-1] = v[1:]                     # v_{i+1}
    dn = torch.zeros_like(v)
    dn[1:] = v[:-1]                     # v_{i-1}
    out = (1.0 + h * h) * v + h * (up + dn)
    out[0] = out[0] - (h * h) * v[0]
    return out


def _dense_inverse_apply(p: torch.Tensor, lam: float, h: float) -> torch.Tensor:
    n = p.shape[0]
    l = build_l_matrix(n, h, device=p.device)
    m = torch.eye(n, dtype=torch.float32, device=p.device) + lam * (l.T @ l)
    # The paper encodes M^{-1} on the MCA and multiplies: keep that dataflow.
    return (torch.linalg.inv(m) @ p.to(torch.float32)).to(p.dtype)


def _thomas_solve(p: torch.Tensor, lam: float, h: float) -> torch.Tensor:
    """Exact O(n) tridiagonal solve, vectorized over trailing dims of p (a
    host loop over rows, the reference backend's tier-2; the ``cuda``
    backend runs :func:`repro_torch.kernels.thomas_solve`)."""
    n = p.shape[0]
    sub, diag, sup = tridiag_coeffs(n, lam, h, device=p.device)
    flat = p.to(torch.float32).reshape(n, -1)
    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    a_seq = torch.cat([zero[None], sub])
    c_seq = torch.cat([sup, zero[None]])
    cp = torch.empty(n, dtype=torch.float32, device=p.device)
    dp = torch.empty_like(flat)
    c_prev, d_prev = zero, torch.zeros_like(flat[0])
    for i in range(n):
        denom = diag[i] - a_seq[i] * c_prev
        c_prev = c_seq[i] / denom
        d_prev = (flat[i] - a_seq[i] * d_prev) / denom
        cp[i], dp[i] = c_prev, d_prev
    xs = torch.empty_like(flat)
    x_next = torch.zeros_like(flat[0])
    for i in range(n - 1, -1, -1):
        x_next = dp[i] - cp[i] * x_next
        xs[i] = x_next
    return xs.reshape(p.shape).to(p.dtype)


def _neumann_apply(p: torch.Tensor, lam: float, h: float,
                   terms: int = 2) -> torch.Tensor:
    """y = sum_k (-lam K)^k p with K = L^T L as a stencil (no matrices)."""
    pf = p.to(torch.float32)
    y = pf
    term = pf
    for _ in range(terms - 1):
        term = -lam * stencil_apply(term, h)
        y = y + term
    return y.to(p.dtype)


def denoise_least_square(p: torch.Tensor, lam: float = 1e-12, h: float = -1.0,
                         method: str = "neumann") -> torch.Tensor:
    """Paper Algorithm 5 (second-order EC). ``p`` is (n,) or (n, batch)."""
    if method == "dense":
        return _dense_inverse_apply(p, lam, h)
    if method == "thomas":
        return _thomas_solve(p, lam, h)
    if method == "neumann":
        return _neumann_apply(p, lam, h)
    raise ValueError(f"unknown denoise method {method!r}")


# --------------------------------------------------------------------------- #
# End-to-end corrected products on pre-encoded operands (paper Algorithm 6)
# --------------------------------------------------------------------------- #

def corrected_matvecmul(a, x, a_tilde, x_tilde, *, lam: float = 1e-12,
                        h: float = -1.0, ec_mode: str = "fused",
                        denoise_method: str = "neumann") -> torch.Tensor:
    """correctedMatVecMul: tier-1 then tier-2 on pre-encoded operands."""
    p = first_order_correct(a, a_tilde, x, x_tilde, mode=ec_mode)
    return denoise_least_square(p, lam=lam, h=h, method=denoise_method)


def corrected_matmul(x, w, x_tilde, w_tilde, *, lam: float = 1e-12,
                     h: float = -1.0, ec_mode: str = "fused",
                     denoise_method: str = "neumann") -> torch.Tensor:
    """Row-major ``y = x @ W`` with EC over both operands (the LM layers').

    ``faithful``: ``x~W + xW~ - x~W~`` (= ``xW - dx dW``); ``fused``:
    ``xW~ + x~(W - W~)``.  ``x`` may have any leading axes.  Tier-2 runs
    along the last (output-feature) axis, the analog column lines: the
    product is flattened to (-1, n_out), the feature axis moved to the front
    for :func:`denoise_least_square`, and moved back.
    """
    if ec_mode == "faithful":
        p = x_tilde @ w + x @ w_tilde - x_tilde @ w_tilde
    elif ec_mode == "fused":
        p = x @ w_tilde + x_tilde @ (w - w_tilde)
    else:
        raise ValueError(f"unknown first-order EC mode {ec_mode!r}")
    shape = p.shape
    pt = torch.movedim(p.reshape(-1, shape[-1]), -1, 0)   # (n_out, rows)
    yt = denoise_least_square(pt, lam=lam, h=h, method=denoise_method)
    return torch.movedim(yt, 0, -1).reshape(shape)
