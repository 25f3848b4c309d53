"""Carry configurations and programmed images across from the JAX package.

Both directions go through plain Python and numpy, so this module imports
neither ``jax`` nor ``repro``:

  * ``config_from_dict(dataclasses.asdict(jax_cfg))`` rebuilds a
    :class:`~repro_torch.core.crossbar.CrossbarConfig`;
  * ``image_from_numpy(np.asarray(A.at_blocks), np.asarray(A.da_blocks),
    A.shape, cfg, device)`` turns a JAX handle's programmed image into a
    port :class:`~repro_torch.engine.AnalogMatrix`, so that both packages
    execute the same image.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Tuple

import numpy as np
import torch

from .core import crossbar
from .core.crossbar import CrossbarConfig
from .core.devices import DeviceModel
from .core.virtualization import MCAGeometry
from .engine import AnalogEngine, AnalogMatrix

__all__ = ["config_from_dict", "image_from_numpy"]


def config_from_dict(d: Mapping[str, Any]) -> CrossbarConfig:
    """A :class:`CrossbarConfig` from the nested dict of
    ``dataclasses.asdict`` of the reference's config (unknown keys raise)."""
    d = dict(d)
    device = DeviceModel(**d.pop("device"))
    geom = MCAGeometry(**d.pop("geom"))
    names = {f.name for f in dataclasses.fields(CrossbarConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown CrossbarConfig fields {sorted(unknown)}")
    return CrossbarConfig(device=device, geom=geom, **d)


def image_from_numpy(at_blocks: np.ndarray, da_blocks: np.ndarray,
                     shape: Tuple[int, int], cfg: CrossbarConfig, device,
                     *, backend: str = "reference") -> AnalogMatrix:
    """A port handle holding the (mb, nb, cap_m, cap_n) block images
    ``at_blocks`` / ``da_blocks``, reassembled into the padded (Mp, Np)
    layout on ``device``; its engine uses ``backend`` and its DAC schedule
    starts from key 0."""
    at_blocks = np.asarray(at_blocks, np.float32)
    da_blocks = np.asarray(da_blocks, np.float32)
    mb, nb, cap_m, cap_n = at_blocks.shape
    if da_blocks.shape != at_blocks.shape:
        raise ValueError(f"image shapes differ: {at_blocks.shape} vs "
                         f"{da_blocks.shape}")
    if (cap_m, cap_n) != cfg.geom.capacity:
        raise ValueError(f"blocks of {(cap_m, cap_n)} do not match the "
                         f"capacity {cfg.geom.capacity}")

    def padded(blocks):
        dense = blocks.transpose(0, 2, 1, 3).reshape(mb * cap_m, nb * cap_n)
        # A copy: the blocks may be a read-only view of a JAX array.
        return torch.from_numpy(np.array(dense, order="C")).to(device)

    m, n = shape
    engine = AnalogEngine(cfg, backend=backend, device=device)
    return AnalogMatrix(engine=engine, shape=(int(m), int(n)),
                        base_key=0,
                        write_stats=crossbar.matrix_write_cost(m, n, cfg),
                        at_pad=padded(at_blocks), da_pad=padded(da_blocks))
