"""Fused solver-update kernels (port of :mod:`repro.kernels.solver_update`).

  * ``cg_update(x, r, p, ap, alpha) = (x + alpha * p, r - alpha * ap)`` with
    ``alpha`` of shape (batch,), one value per right-hand side;
  * ``richardson_update(x, b, y, omega) = (x + omega * (b - y), b - y)`` with
    ``omega`` a 0-dim tensor.

Coefficients stay tensors on the device (no ``.item()``): the kernels read
them from device memory.  On CUDA tensors the wrappers launch
``csrc/solver_update.cu``; on CPU tensors they run the ``*_plain`` versions.
Both kernels walk their panels in 4-float units on a grid of one wave of
the card and are launched with programmatic dependent launch: each waits
for the kernel before it on the stream ahead of its first global access.

``launch_floor_probe`` is no port of a kernel: a measurement probe that
writes one float with a plain launch (no PDL), so that a measurement can
time the least a separate launch costs; no solver or model calls it, and
``build.LAUNCHES`` does not count it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build, cost
from .cost import OBSERVERS
from ._checks import check_panels, check_shapes, on_cpu

__all__ = ["cg_update", "cg_update_plain", "richardson_update",
           "richardson_update_plain", "launch_floor_probe"]


def cg_update_plain(x, r, p, ap, alpha) -> Tuple[torch.Tensor, torch.Tensor]:
    if OBSERVERS and cost.outermost():
        return cost.observed("cg_update", cg_update_plain, x, r, p, ap, alpha)
    a = alpha[None, :]
    return x + a * p, r - a * ap


def richardson_update_plain(x, b, y, omega) -> Tuple[torch.Tensor, torch.Tensor]:
    if OBSERVERS and cost.outermost():
        return cost.observed("richardson_update", richardson_update_plain, x,
                             b, y, omega)
    r = b - y
    return x + omega * r, r


def cg_update(x: torch.Tensor, r: torch.Tensor, p: torch.Tensor,
              ap: torch.Tensor, alpha: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CG's twin axpy on (n, batch) panels with per-column ``alpha``."""
    if OBSERVERS and cost.outermost():
        return cost.observed("cg_update", cg_update, x, r, p, ap, alpha)
    check_panels("cg_update", x, r, p, ap, alpha)
    check_shapes("cg_update", x.shape, r, p, ap)
    if x.ndim != 2 or tuple(alpha.shape) != (x.shape[1],):
        raise ValueError(f"cg_update: panels {tuple(x.shape)} need alpha of "
                         f"shape ({x.shape[-1]},), got {tuple(alpha.shape)}")
    if on_cpu(x):
        return cg_update_plain(x, r, p, ap, alpha)
    n, batch = x.shape
    x_out, r_out = torch.empty_like(x), torch.empty_like(r)
    build.launch("cg_update", "repro_cg_update", x.device,
                 x.data_ptr(), r.data_ptr(), p.data_ptr(), ap.data_ptr(),
                 alpha.data_ptr(), x_out.data_ptr(), r_out.data_ptr(),
                 n, batch)
    return x_out, r_out


def richardson_update(x: torch.Tensor, b: torch.Tensor, y: torch.Tensor,
                      omega: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Richardson's residual and relaxed step on (n, batch) panels."""
    if OBSERVERS and cost.outermost():
        return cost.observed("richardson_update", richardson_update, x, b, y,
                             omega)
    check_panels("richardson_update", x, b, y, omega)
    check_shapes("richardson_update", x.shape, b, y)
    if x.ndim != 2 or omega.numel() != 1:
        raise ValueError(f"richardson_update: expected (n, batch) panels and "
                         f"a scalar omega, got {tuple(x.shape)} and "
                         f"{tuple(omega.shape)}")
    if on_cpu(x):
        return richardson_update_plain(x, b, y, omega)
    n, batch = x.shape
    x_out, r_out = torch.empty_like(x), torch.empty_like(x)
    build.launch("richardson_update", "repro_richardson_update", x.device,
                 x.data_ptr(), b.data_ptr(), y.data_ptr(), omega.data_ptr(),
                 x_out.data_ptr(), r_out.data_ptr(), n, batch)
    return x_out, r_out


def launch_floor_probe(out: torch.Tensor) -> torch.Tensor:
    """Writes 1.0 into the one-element float32 tensor ``out`` and returns it:
    on a CUDA tensor one plain launch of a one-thread kernel (not counted),
    on a CPU tensor ``out.fill_(1.0)``."""
    check_panels("launch_floor_probe", out)
    if out.numel() != 1:
        raise ValueError(f"launch_floor_probe: expected one element, got "
                         f"{tuple(out.shape)}")
    if on_cpu(out):
        return out.fill_(1.0)
    build.launch_uncounted("launch_floor_probe", "repro_launch_floor",
                           out.device, out.data_ptr())
    return out
