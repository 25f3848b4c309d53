"""Fused tier-1 error-corrected products, forward and transposed (port of
:func:`repro.kernels.rram_mvm.ec_matmul` and of the same call read backwards,
``repro.kernels.ops.rram_ec_tile_rmvm``).

  * ``ec_matmul(at, da, x, x_t) = at @ x + da @ x_t``: (M, K) images,
    (K, batch) panels, (M, batch) out;
  * ``ec_rmatmul(at, da, y, y_t) = at.T @ y + da.T @ y_t``: the same images
    read backwards, (M, batch) panels, (K, batch) out.

fp32 accumulation, fp32 out.  The images are row-major with unit column
stride and may have a row stride larger than their width, so one capacity
block of a padded image runs as a view without a copy; the panels are
contiguous.  On CUDA tensors the wrappers launch the hand-written kernels in
``csrc/rram_mvm.cu`` (memory-bound GEMVs: each reads both images once); on
CPU tensors they run the ``*_plain`` versions.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from ._checks import check_images, check_panels, on_cpu, row_stride

__all__ = ["ec_matmul", "ec_matmul_plain", "ec_rmatmul", "ec_rmatmul_plain",
           "MAX_KERNEL_BATCH"]

#: Widest panel one launch takes; wider panels are split into launches of
#: this many columns (each re-reads the images).
MAX_KERNEL_BATCH = 8


def ec_matmul_plain(at: torch.Tensor, da: torch.Tensor, x: torch.Tensor,
                    x_t: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: two float32 products and a sum."""
    return at @ x + da @ x_t


def ec_rmatmul_plain(at: torch.Tensor, da: torch.Tensor, y: torch.Tensor,
                     y_t: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: two float32 products through transposed
    views (no copy) and a sum."""
    return at.T @ y + da.T @ y_t


def _check(name, at, da, u, u_t, contraction: int) -> None:
    check_panels(name, u, u_t)
    check_images(name, at, da, u.device)
    if u.ndim != 2 or u_t.shape != u.shape or u.shape[0] != contraction:
        raise ValueError(
            f"{name}: images {tuple(at.shape)}/{tuple(da.shape)} do not "
            f"match panels {tuple(u.shape)}/{tuple(u_t.shape)}")


def ec_matmul(at: torch.Tensor, da: torch.Tensor, x: torch.Tensor,
              x_t: torch.Tensor) -> torch.Tensor:
    """``at @ x + da @ x_t`` for (M, K) images and (K, batch) panels."""
    _check("ec_matmul", at, da, x, x_t, at.shape[-1])
    if on_cpu(x):
        return ec_matmul_plain(at, da, x, x_t)
    m, k = at.shape
    batch = x.shape[1]
    out = torch.empty(m, batch, dtype=torch.float32, device=x.device)
    for c0 in range(0, batch, MAX_KERNEL_BATCH):
        cols = min(MAX_KERNEL_BATCH, batch - c0)
        build.launch("ec_matmul", "repro_ec_matmul", x.device,
                     at.data_ptr(), da.data_ptr(),
                     x[:, c0:].data_ptr(), x_t[:, c0:].data_ptr(),
                     out[:, c0:].data_ptr(), m, k, row_stride(at), cols,
                     batch)
    return out


@functools.lru_cache(maxsize=None)
def _rmatmul_workspace(m: int, k: int, batch: int, device: torch.device) -> int:
    """Floats of workspace the transposed launcher asks for (0: none); the
    launcher alone decides how it cuts the rows."""
    floats = ctypes.c_longlong()
    build.query("repro_ec_rmatmul_workspace", device, m, k, batch,
                ctypes.byref(floats))
    return floats.value


def ec_rmatmul(at: torch.Tensor, da: torch.Tensor, y: torch.Tensor,
               y_t: torch.Tensor) -> torch.Tensor:
    """``at.T @ y + da.T @ y_t`` for (M, K) images and (M, batch) panels;
    returns (K, batch).  The kernel sums row slabs in a second pass over a
    workspace, in a fixed order: the result is the same run to run."""
    _check("ec_rmatmul", at, da, y, y_t, at.shape[0])
    if on_cpu(y):
        return ec_rmatmul_plain(at, da, y, y_t)
    m, k = at.shape
    batch = y.shape[1]
    out = torch.empty(k, batch, dtype=torch.float32, device=y.device)
    for c0 in range(0, batch, MAX_KERNEL_BATCH):
        cols = min(MAX_KERNEL_BATCH, batch - c0)
        floats = _rmatmul_workspace(m, k, cols, y.device)
        ws = torch.empty(floats, dtype=torch.float32,
                         device=y.device) if floats else None
        build.launch("ec_rmatmul", "repro_ec_rmatmul", y.device,
                     at.data_ptr(), da.data_ptr(),
                     y[:, c0:].data_ptr(), y_t[:, c0:].data_ptr(),
                     out[:, c0:].data_ptr(),
                     ws.data_ptr() if ws is not None else None, floats,
                     m, k, row_stride(at), cols, batch, batch)
    return out
