"""Tier-2 denoise kernels (port of :mod:`repro.kernels.tridiag`, first half).

``stencil_denoise(p, lam, h) = p - lam * (L^T L) p`` on an (n, batch) panel:
the truncated-Neumann form of ``(I + lam L^T L)^{-1} p``, the engine's
default tier-2.  On CUDA tensors it launches ``csrc/tridiag.cu``; on CPU
tensors it runs :func:`stencil_denoise_plain`.  The exact Thomas solve is not
ported yet (ROADMAP Queue B1).
"""
from __future__ import annotations

import torch

from ..core.error_correction import stencil_apply
from . import build
from ._checks import check_panels, on_cpu

__all__ = ["stencil_denoise", "stencil_denoise_plain"]


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
