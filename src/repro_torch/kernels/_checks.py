"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch


def check_panels(name: str, *tensors: torch.Tensor) -> None:
    """Every operand is a contiguous float32 tensor on one CPU or CUDA
    device, and 2**31 - 1 bounds every dimension the kernels index with int."""
    dev = tensors[0].device
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: expected tensors, got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if any(s >= 2 ** 31 for s in t.shape):
            raise ValueError(f"{name}: dimension too large: {tuple(t.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")


def on_cpu(t: torch.Tensor) -> bool:
    """True when the plain version must run (the operands are on the CPU)."""
    return t.device.type == "cpu"


def check_shapes(name: str, shape, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
