"""Fused tier-1 error-corrected product (port of
:func:`repro.kernels.rram_mvm.ec_matmul`).

``ec_matmul(at, da, x, x_t) = at @ x + da @ x_t`` in the engine's layout:
``at``/``da`` row-major (M, K) images, ``x``/``x_t`` (K, batch) panels, fp32
accumulation, fp32 (M, batch) out.  On CUDA tensors it launches the
hand-written kernel in ``csrc/rram_mvm.cu`` (memory-bound GEMV: reads each
image once); on CPU tensors it runs :func:`ec_matmul_plain`.
"""
from __future__ import annotations

import torch

from . import build
from ._checks import check_panels, on_cpu

__all__ = ["ec_matmul", "ec_matmul_plain", "MAX_KERNEL_BATCH"]

#: Widest panel one launch takes; wider panels are split into launches of
#: this many columns (each re-reads the images).
MAX_KERNEL_BATCH = 8


def ec_matmul_plain(at: torch.Tensor, da: torch.Tensor, x: torch.Tensor,
                    x_t: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: two float32 products and a sum."""
    return at @ x + da @ x_t


def ec_matmul(at: torch.Tensor, da: torch.Tensor, x: torch.Tensor,
              x_t: torch.Tensor) -> torch.Tensor:
    """``at @ x + da @ x_t`` for (M, K) images and (K, batch) panels."""
    check_panels("ec_matmul", at, da, x, x_t)
    if at.ndim != 2 or x.ndim != 2 or da.shape != at.shape \
            or x_t.shape != x.shape or x.shape[0] != at.shape[1]:
        raise ValueError(
            f"ec_matmul: images {tuple(at.shape)}/{tuple(da.shape)} do not "
            f"match panels {tuple(x.shape)}/{tuple(x_t.shape)}")
    if on_cpu(at):
        return ec_matmul_plain(at, da, x, x_t)
    m, k = at.shape
    batch = x.shape[1]
    out = torch.empty(m, batch, dtype=torch.float32, device=at.device)
    for c0 in range(0, batch, MAX_KERNEL_BATCH):
        cols = min(MAX_KERNEL_BATCH, batch - c0)
        build.launch("ec_matmul", "repro_ec_matmul", at.device,
                     at.data_ptr(), da.data_ptr(),
                     x[:, c0:].data_ptr(), x_t[:, c0:].data_ptr(),
                     out[:, c0:].data_ptr(), m, k, cols, batch)
    return out
