"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch


def _check_tensor(name: str, t, dev) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected tensors, got {type(t).__name__}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name}: operands on {dev} and {t.device}")
    if any(s >= 2 ** 31 for s in t.shape):
        raise ValueError(f"{name}: dimension too large: {tuple(t.shape)}")


def check_panels(name: str, *tensors: torch.Tensor) -> None:
    """Every operand is a contiguous float32 tensor on one CPU or CUDA
    device, and 2**31 - 1 bounds every dimension the kernels index with int."""
    dev = tensors[0].device
    for t in tensors:
        _check_tensor(name, t, dev)
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")


def check_images(name: str, at: torch.Tensor, da: torch.Tensor,
                 dev: torch.device) -> None:
    """``at`` and ``da`` are (M, K) float32 images on ``dev`` with unit column
    stride and one common row stride >= K: a padded image or a block of one
    (a view, no copy)."""
    for t in (at, da):
        _check_tensor(name, t, dev)
        if t.ndim != 2:
            raise ValueError(f"{name}: images must be 2-D, got "
                             f"{tuple(t.shape)}")
        if t.shape[1] > 1 and t.stride(1) != 1 \
                or t.shape[0] > 1 and t.stride(0) < t.shape[1]:
            raise ValueError(f"{name}: images must be row-major with unit "
                             f"column stride, got strides {t.stride()}")
    if at.shape != da.shape or at.stride() != da.stride():
        raise ValueError(f"{name}: images {tuple(at.shape)}/{at.stride()} "
                         f"and {tuple(da.shape)}/{da.stride()} differ")


def row_stride(image: torch.Tensor) -> int:
    """The row stride of a checked image (its width when it has one row)."""
    return image.stride(0) if image.shape[0] > 1 else image.shape[1]


def on_cpu(t: torch.Tensor) -> bool:
    """True when the plain version must run (the operands are on the CPU)."""
    return t.device.type == "cpu"


def check_shapes(name: str, shape, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")
