"""Distributed-optimization primitives of the port (of
:mod:`repro.distributed.collectives`): compressed gradient reduction and a
ring collective matmul, over a :class:`~repro_torch.launch.mesh.Mesh` with
one tensor per rank (rank order), where the reference runs inside
``shard_map`` with an axis name bound.

``compressed_psum`` is the int8 gradient-compression path: a shared
absmax scale (a scalar ``pmax``), symmetric int8 quantization with
round-half-to-even, an int32 ``psum`` (no saturation), one dequantize, and
the error-feedback residual returned to the caller so the quantization
error is re-injected next step.  ``ring_collective_matmul`` computes ``x @
w`` with ``w`` split over an axis: each of n steps multiplies the shard a
rank holds by its slice of ``x`` and passes the shard on (``ppermute``).
The reference computes both outside any Pallas kernel; so does the port.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..launch.mesh import (Mesh, axis_index, mesh_axis_sizes, pmax, ppermute,
                           psum)

__all__ = ["int8_quantize", "int8_dequantize", "compressed_psum",
           "ring_collective_matmul"]


def int8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = x.abs().max() / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(mesh: Mesh, xs: Sequence[torch.Tensor], axis_name: str,
                    error_feedback: Optional[Sequence[torch.Tensor]] = None
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """int8-on-the-wire psum over ``axis_name`` with error feedback:
    ``xs[r]`` (and ``error_feedback[r]``) is rank ``r``'s.  Returns (the
    reduced float32 sums, the new error-feedback residuals), one a rank."""
    xf = [x.to(torch.float32) for x in xs]
    if error_feedback is not None:
        xf = [x + e for x, e in zip(xf, error_feedback)]
    # Shared scale: every participant quantizes onto the same grid, so the
    # int8 payload reduces exactly in int32 and one dequantize gives the sum.
    scales = pmax(mesh, [x.abs().max() for x in xf], axis_name)
    scales = [s / 127.0 for s in scales]
    scales = [torch.where(s == 0, torch.ones_like(s), s) for s in scales]
    qs = [torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
          for x, s in zip(xf, scales)]
    qsums = psum(mesh, [q.to(torch.int32) for q in qs], axis_name)
    outs = [qsum.to(torch.float32) * s for qsum, s in zip(qsums, scales)]
    residuals = [x - int8_dequantize(q, s)
                 for x, q, s in zip(xf, qs, scales)]
    return outs, residuals


def ring_collective_matmul(mesh: Mesh, xs: Sequence[torch.Tensor],
                           w_locals: Sequence[torch.Tensor],
                           axis_name: str) -> List[torch.Tensor]:
    """``y = x @ w_global`` as a ring: ``xs[r]`` (m, k_global) is rank
    ``r``'s activations (k replicated), ``w_locals[r]`` (k_local, n) its
    shard of ``w``, split over ``axis_name``.  At step i the rank at index
    ``idx`` multiplies its slice ``(idx - i) mod n`` of x by the shard it
    holds, then passes the shard to ``idx + 1``.  The accumulator is
    float32 and is cast back to x's dtype."""
    n_dev = mesh_axis_sizes(mesh)[axis_name]
    k_local = w_locals[0].shape[0]
    perm = [(j, (j + 1) % n_dev) for j in range(n_dev)]
    idx = [axis_index(mesh, r, axis_name) for r in range(mesh.size)]
    acc_dtype = torch.promote_types(xs[0].dtype, torch.float32)
    accs = [torch.zeros((x.shape[0], w.shape[1]), dtype=acc_dtype,
                        device=x.device) for x, w in zip(xs, w_locals)]
    ws = list(w_locals)
    for i in range(n_dev):
        for r in range(mesh.size):
            src = (idx[r] - i) % n_dev
            x_slice = xs[r][:, src * k_local:(src + 1) * k_local]
            accs[r] += (x_slice @ ws[r]).to(acc_dtype)
        ws = ppermute(mesh, ws, axis_name, perm)   # the next shard
    return [acc.to(x.dtype) for acc, x in zip(accs, xs)]
