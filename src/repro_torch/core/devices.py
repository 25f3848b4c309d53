"""RRAM device models (port of :mod:`repro.core.devices`).

The four material systems and their effective constants are copied verbatim;
the noisy stages draw from an explicit ``torch.Generator`` (or take a
pre-drawn ``eta`` so tests can feed both packages the same noise).

Programming model: writing ``w`` yields ``Q(w) * (1 + sigma_k * eta)`` with
``Q`` a symmetric quantization to ``levels`` states (scale = max-abs over the
physical tile) and ``sigma_k`` the residual noise after ``k`` write-verify
passes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

__all__ = [
    "DeviceModel",
    "DEVICES",
    "get_device",
    "effective_sigma",
    "effective_sigma_py",
    "drift_factor",
    "drift_factor_py",
    "quantize",
    "encode",
]


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """Effective per-material constants (see DESIGN.md section 7)."""

    name: str
    levels: int            # conductance states available for weight storage
    sigma0: float          # initial relative programming noise (std, multiplicative)
    verify_gain: float     # fraction of residual error removed per verify iteration
    e_write: float         # J per cell per programming pulse
    t_write: float         # s per row programming pulse (rows in a column are parallel)
    nl_pot: float          # potentiation nonlinearity coefficient
    nl_dep: float          # depression nonlinearity coefficient
    drift_nu: float = 0.0       # drift exponent (dimensionless)
    drift_t0: float = 1.0       # drift reference time (s)
    fault_rate: float = 0.0     # stuck-at faults per cell per MVM

    @property
    def sigma_floor(self) -> float:
        # Quantization-limited noise floor of a symmetric `levels`-state cell.
        return 1.0 / (self.levels * (12.0 ** 0.5))

    @property
    def effective_gain(self) -> float:
        # Nonlinearity shrinks the usable verify correction per iteration.
        nl = 0.5 * (abs(self.nl_pot) + abs(self.nl_dep))
        return self.verify_gain / (1.0 + 0.35 * nl)


DEVICES: Dict[str, DeviceModel] = {
    "epiram": DeviceModel(
        name="epiram", levels=64, sigma0=0.022, verify_gain=0.50,
        e_write=2.3e-8, t_write=6.8e-4, nl_pot=0.5, nl_dep=-0.5,
        drift_nu=0.002, drift_t0=1.0, fault_rate=1e-9,
    ),
    "ag-si": DeviceModel(
        name="ag-si", levels=16, sigma0=0.23, verify_gain=0.60,
        e_write=8.6e-10, t_write=1.5e-2, nl_pot=2.4, nl_dep=-4.88,
        drift_nu=0.02, drift_t0=1.0, fault_rate=2e-7,
    ),
    "alox-hfo2": DeviceModel(
        name="alox-hfo2", levels=8, sigma0=0.60, verify_gain=0.60,
        e_write=1.3e-8, t_write=2.1e-3, nl_pot=1.0, nl_dep=-1.0,
        drift_nu=0.01, drift_t0=1.0, fault_rate=1e-7,
    ),
    "taox-hfox": DeviceModel(
        name="taox-hfox", levels=8, sigma0=0.49, verify_gain=0.60,
        e_write=1.2e-11, t_write=3.1e-6, nl_pot=0.8, nl_dep=-0.8,
        drift_nu=0.015, drift_t0=1.0, fault_rate=5e-8,
    ),
}


def get_device(name: str) -> DeviceModel:
    key = name.lower().replace("_", "-")
    if key not in DEVICES:
        raise KeyError(f"unknown RRAM device {name!r}; known: {sorted(DEVICES)}")
    return DEVICES[key]


def effective_sigma(device: DeviceModel, k: int) -> torch.Tensor:
    """Residual relative programming noise after ``k`` write-verify passes,
    as a float32 scalar computed in float32 (the reference's arithmetic)."""
    f32 = torch.float32
    sigma = torch.tensor(device.sigma0, dtype=f32) * \
        torch.tensor(1.0 - device.effective_gain, dtype=f32) ** \
        torch.tensor(float(k), dtype=f32)
    return torch.maximum(sigma, torch.tensor(device.sigma_floor, dtype=f32))


def effective_sigma_py(device: DeviceModel, k: float) -> float:
    """Pure-Python twin of :func:`effective_sigma` (host-side cost models)."""
    return max(device.sigma0 * (1.0 - device.effective_gain) ** float(k),
               device.sigma_floor)


def drift_factor(device: DeviceModel, seconds) -> torch.Tensor:
    """Multiplicative conductance decay after ``seconds`` of retention,
    ``(1 + t/t0)^-nu`` in float32: exactly 1 at t = 0, the log-time power
    law ``(t/t0)^-nu`` for ``t >> t0``."""
    t = torch.as_tensor(seconds, dtype=torch.float32)
    return (1.0 + t / device.drift_t0) ** (-device.drift_nu)


def drift_factor_py(device: DeviceModel, seconds: float) -> float:
    """Pure-Python twin of :func:`drift_factor` (host-side cost models)."""
    return (1.0 + float(seconds) / device.drift_t0) ** (-device.drift_nu)


def quantize(w: torch.Tensor, levels: int, axis=None) -> torch.Tensor:
    """Symmetric quantization to ``levels`` conductance states.

    The scale is the max-abs over ``axis`` (``None``: one scale over the
    whole tensor, as the input DAC applies to a whole ``(n, batch)`` panel).
    """
    if axis is None:
        scale = w.abs().amax()
    else:
        scale = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.round(w / scale * (levels - 1)) / (levels - 1)
    return q * scale


def apply_noise(q: torch.Tensor, sigma: torch.Tensor, *,
                gen: Optional[torch.Generator] = None,
                eta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``q * (1 + sigma * eta)`` with ``eta ~ N(0, 1)`` drawn from ``gen``
    unless given (reshaped to ``q``'s shape).  Consumes ``q`` in place."""
    if eta is None:
        if gen is None:
            raise ValueError("a noisy stage needs gen= or a pre-drawn eta=")
        eta = torch.randn(q.shape, generator=gen, device=q.device,
                          dtype=q.dtype)
    else:
        eta = torch.as_tensor(eta, dtype=q.dtype, device=q.device) \
            .reshape(q.shape).clone()
    eta.mul_(float(sigma)).add_(1.0)     # float32 arithmetic, as the reference
    return q.mul_(eta)


def encode(w: torch.Tensor, device: DeviceModel, k_iters: int = 0,
           quantize_axis=None, *, gen: Optional[torch.Generator] = None,
           eta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Closed-form encode: quantize + residual programming noise after k iters."""
    q = quantize(w, device.levels, axis=quantize_axis)
    return apply_noise(q, effective_sigma(device, k_iters),
                       gen=gen, eta=eta)
