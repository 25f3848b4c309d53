"""adjustableWriteandVerify, paper Algorithms 1 and 2 (port of
:mod:`repro.core.write_verify`).

Closed-loop programming: re-program the array while the relative deviation
``delta(A, A_tilde) > eps`` and fewer than ``max_iters`` passes have run.
Each pass refines the residual programming noise by the device's effective
verify gain and accrues write energy and latency.  ``delta`` is the p-norm
(2 or inf) of ``A_tilde - A`` relative to ``||A||_p``.

The loop is a host ``while`` loop over the reference's stopping rule.  Pass
``k`` draws its noise from ``fold_in(key, k)`` (:mod:`repro_torch.core.prng`);
``eta`` of shape ``(max_iters + 1, *a.shape)`` replaces the draws, row ``k``
for pass ``k``.  The cost sums run in float32, as the reference's do, and
:class:`WriteStats` holds host scalars.  The engine bills its closed-form
encode with the analytic :func:`repro_torch.core.crossbar.write_cost`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .devices import DeviceModel, effective_sigma, effective_sigma_py, \
    quantize
from .prng import fold_in, generator

__all__ = [
    "WriteStats",
    "adjustable_write_and_verify",
    "adjustable_mat_write_and_verify",
    "adjustable_vec_write_and_verify",
    "refresh_write_and_verify",
]


@dataclasses.dataclass(frozen=True)
class WriteStats:
    """Side-channel accounting for programming cost (host scalars)."""

    energy_j: float      # total write energy (J)
    latency_s: float     # total write latency (s); rows of a pass are parallel
    iterations: int      # verify iterations used
    final_delta: float   # relative ||A_tilde - A||_p at exit

    @classmethod
    def zero(cls) -> "WriteStats":
        return cls(energy_j=0.0, latency_s=0.0, iterations=0, final_delta=0.0)

    def __add__(self, other: "WriteStats") -> "WriteStats":
        return WriteStats(
            energy_j=self.energy_j + other.energy_j,
            # Writes to distinct arrays in one pipeline are sequential per MCA.
            latency_s=self.latency_s + other.latency_s,
            iterations=self.iterations + other.iterations,
            final_delta=max(self.final_delta, other.final_delta),
        )


def _tensor(a) -> torch.Tensor:
    # The loop runs where its input lives; a host array has no such place.
    if not isinstance(a, torch.Tensor):
        raise TypeError(f"write-and-verify takes a torch.Tensor, not "
                        f"{type(a).__name__}: the loop runs on its device")
    return a.to(torch.float32)


def _pnorm(x: torch.Tensor, p) -> torch.Tensor:
    if p in (float("inf"), "inf"):
        return x.abs().amax()
    return x.square().sum().sqrt()


def adjustable_write_and_verify(
    a,
    key: int,
    device: DeviceModel,
    *,
    eps: float = 1e-3,
    max_iters: int = 20,
    p=2,
    rows_parallel: bool = True,
    eta: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, WriteStats]:
    """Program ``a`` onto an MCA with closed-loop write-and-verify.

    Returns the encoded array and its :class:`WriteStats`.  Works for
    matrices (Algorithm 1) and vectors (Algorithm 2, programmed as one row).
    ``a`` is a tensor, and the loop runs on its device.  ``eta``
    ((max_iters + 1, *a.shape)) replaces the per-pass draws.
    """
    a = _tensor(a)
    cells = float(a.numel())
    rows = float(a.shape[0]) if (a.ndim == 2 and rows_parallel) else 1.0
    norm_a = torch.clamp(_pnorm(a, p), min=torch.finfo(torch.float32).tiny)
    q = quantize(a, device.levels)
    if eta is not None:
        eta = torch.as_tensor(eta, dtype=torch.float32, device=a.device)
        if tuple(eta.shape) != (max_iters + 1,) + tuple(a.shape):
            raise ValueError(f"eta must be (max_iters + 1, *a.shape) = "
                             f"{(max_iters + 1,) + tuple(a.shape)}, got "
                             f"{tuple(eta.shape)}")

    def program(k: int) -> torch.Tensor:
        # Residual noise shrinks with each verify pass.
        sigma = effective_sigma(device, k)
        if eta is None:
            noise = torch.randn(a.shape, generator=generator(
                fold_in(key, k), a.device), device=a.device)
        else:
            noise = eta[k].clone()
        return q * noise.mul_(float(sigma)).add_(1.0)

    def delta_of(at: torch.Tensor) -> float:
        return float(_pnorm(at - a, p) / norm_a)

    # float32 sums, as the reference's loop carries them.
    e_pass = np.float32(cells * device.e_write)
    t_pass = np.float32(rows * device.t_write)
    k, at, e, t = 0, program(0), e_pass, t_pass
    delta = delta_of(at)
    while k < max_iters and delta > eps:
        k += 1
        at = program(k)
        e, t = np.float32(e + e_pass), np.float32(t + t_pass)
        delta = delta_of(at)
    return at, WriteStats(energy_j=float(e), latency_s=float(t),
                          iterations=k, final_delta=delta)


def refresh_write_and_verify(a, key: int, device: DeviceModel, *,
                             k_iters: int,
                             eta: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, WriteStats]:
    """Re-program one aged capacity tile back to engine-grade precision: the
    verify loop targets the residual noise the closed-form encode reaches
    after ``k_iters`` passes (``eps = effective_sigma(device, k_iters)``)
    and stops after at most ``k_iters`` iterations."""
    return adjustable_write_and_verify(
        a, key, device, eps=effective_sigma_py(device, k_iters),
        max_iters=int(k_iters), eta=eta)


def adjustable_mat_write_and_verify(a, key: int, device: DeviceModel, **kw):
    """Paper Algorithm 1 (matrix form)."""
    if _tensor(a).ndim != 2:
        raise ValueError("adjustableMatWriteandVerify expects a matrix")
    return adjustable_write_and_verify(a, key, device, **kw)


def adjustable_vec_write_and_verify(x, key: int, device: DeviceModel, **kw):
    """Paper Algorithm 2 (vector form), programmed on a single row."""
    if _tensor(x).ndim != 1:
        raise ValueError("adjustableVecWriteandVerify expects a vector")
    return adjustable_write_and_verify(x, key, device, rows_parallel=False,
                                       **kw)
