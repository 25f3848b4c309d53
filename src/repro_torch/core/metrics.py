"""Evaluation metrics (port of :mod:`repro.core.metrics`)."""
from __future__ import annotations

import math

import torch

__all__ = ["relative_error", "rel_l2", "rel_linf"]


def relative_error(y: torch.Tensor, b: torch.Tensor, p=2) -> torch.Tensor:
    """||y - b||_p / ||b||_p, p in {2, inf}, computed in float32."""
    y = torch.as_tensor(y).to(torch.float32)
    b = torch.as_tensor(b).to(device=y.device, dtype=torch.float32)
    if p == math.inf or p == "inf":
        num = (y - b).abs().amax()
        den = b.abs().amax()
    else:
        num = torch.linalg.vector_norm((y - b).reshape(-1))
        den = torch.linalg.vector_norm(b.reshape(-1))
    return num / torch.clamp(den, min=torch.finfo(torch.float32).tiny)


def rel_l2(y, b):
    return relative_error(y, b, p=2)


def rel_linf(y, b):
    return relative_error(y, b, p=math.inf)
