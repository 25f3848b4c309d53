"""Tier-2 denoise kernels (port of :mod:`repro.kernels.tridiag`).

  * ``stencil_denoise(p, lam, h) = p - lam * (L^T L) p`` on an (n, batch)
    panel: the truncated-Neumann form of ``(I + lam L^T L)^{-1} p``, the
    engine's default tier-2;
  * ``thomas_solve(p, lam, h) = (I + lam L^T L)^{-1} p`` exactly, by the
    Thomas algorithm with the elimination coefficients precomputed once per
    ``(n, lam, h, device)`` (:func:`thomas_coeffs`), as the JAX wrapper does.

On CUDA tensors the wrappers launch ``csrc/tridiag.cu``; on CPU tensors they
run the ``*_plain`` versions.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core.error_correction import stencil_apply
from . import build
from ._checks import check_panels, on_cpu

__all__ = ["stencil_denoise", "stencil_denoise_plain", "thomas_solve",
           "thomas_solve_plain", "thomas_coeffs"]

_COEFFS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def stencil_denoise_plain(p: torch.Tensor, lam: float,
                          h: float = -1.0) -> torch.Tensor:
    """The plain PyTorch version: ``p - lam * stencil(p)``."""
    return p - lam * stencil_apply(p, h)


def stencil_denoise(p: torch.Tensor, lam: float, h: float = -1.0) -> torch.Tensor:
    """First-order Neumann denoise of an (n, batch) float32 panel."""
    check_panels("stencil_denoise", p)
    if p.ndim != 2:
        raise ValueError(f"stencil_denoise: expected (n, batch), got "
                         f"{tuple(p.shape)}")
    if on_cpu(p):
        return stencil_denoise_plain(p, lam, h)
    n, batch = p.shape
    y = torch.empty_like(p)
    build.launch("stencil_denoise", "repro_stencil_denoise", p.device,
                 p.data_ptr(), y.data_ptr(), n, batch, float(lam), float(h))
    return y


def thomas_coeffs(n: int, lam: float, h: float,
                  device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(c', pivots)`` of ``I + lam L^T L`` (n,) each, float32, on ``device``.

    The fp32 recurrence of the JAX wrapper: diagonal ``1 + lam (1 + h^2)``,
    row 0 ``1 + lam``, off-diagonal ``a = lam h``; ``piv_i = 1 / (diag_i -
    a c'_{i-1})``, ``c'_i = a piv_i``, ``c'_{n-1} = 0``.  From row 1 on the
    diagonal is constant, so once a step repeats the previous one exactly,
    every later row repeats it too and the loop stops there.  Cached per
    ``(n, lam, h, device)``.
    """
    device = torch.device(device)
    key = (int(n), float(lam), float(h), str(device))
    if key not in _COEFFS:
        f32 = np.float32
        a = f32(lam * h)
        body, row0 = f32(1.0 + lam * (1.0 + h * h)), f32(1.0 + lam)
        cp = np.empty(n, np.float32)
        piv = np.empty(n, np.float32)
        c = f32(0.0)
        for i in range(n):
            pv = f32(1.0) / ((row0 if i == 0 else body) - a * c)
            c = a * pv
            cp[i], piv[i] = c, pv
            if i >= 1 and c == cp[i - 1] and pv == piv[i - 1]:
                cp[i:], piv[i:] = c, pv
                break
        cp[-1:] = 0.0                   # no superdiagonal on the last row
        _COEFFS[key] = (torch.from_numpy(cp).to(device),
                        torch.from_numpy(piv).to(device))
    return _COEFFS[key]


def thomas_solve_plain(p: torch.Tensor, lam: float,
                       h: float = -1.0) -> torch.Tensor:
    """The plain PyTorch version: the kernel's two recurrences as a loop
    over rows, each step on the whole batch (2n small steps: slow on a
    large panel, by nature)."""
    n = p.shape[0]
    cp, piv = thomas_coeffs(n, lam, h, p.device)
    a = float(np.float32(lam * h))
    y = torch.empty_like(p)
    d = torch.zeros_like(p[0])
    for i in range(n):
        d = (p[i] - a * d) * piv[i]
        y[i] = d
    v = torch.zeros_like(p[0])
    for i in range(n - 1, -1, -1):
        v = y[i] - cp[i] * v
        y[i] = v
    return y


def thomas_solve(p: torch.Tensor, lam: float, h: float = -1.0) -> torch.Tensor:
    """Exact tier-2 solve ``(I + lam L^T L) y = p`` of an (n, batch) float32
    panel."""
    check_panels("thomas_solve", p)
    if p.ndim != 2:
        raise ValueError(f"thomas_solve: expected (n, batch), got "
                         f"{tuple(p.shape)}")
    if on_cpu(p):
        return thomas_solve_plain(p, lam, h)
    n, batch = p.shape
    cp, piv = thomas_coeffs(n, lam, h, p.device)
    y = torch.empty_like(p)
    build.launch("thomas_solve", "repro_thomas_solve", p.device,
                 p.data_ptr(), cp.data_ptr(), piv.data_ptr(), y.data_ptr(),
                 n, batch, float(np.float32(lam * h)))
    return y
