"""Carry configurations and programmed images across from the JAX package.

Both directions go through plain Python and numpy, so this module imports
neither ``jax`` nor ``repro``:

  * ``config_from_dict(dataclasses.asdict(jax_cfg))`` rebuilds a
    :class:`~repro_torch.core.crossbar.CrossbarConfig`;
  * ``image_from_numpy(np.asarray(A.at_blocks), np.asarray(A.da_blocks),
    A.shape, cfg, device)`` turns a JAX handle's programmed image into a
    port :class:`~repro_torch.engine.AnalogMatrix`, so that both packages
    execute the same image;
  * ``group_from_numpy(np.asarray(G.at_blocks), np.asarray(G.da_blocks),
    G.shape, cfg, device)`` does the same for a JAX
    ``AnalogMatrixGroup``'s (g, mb, nb, cap_m, cap_n) stacks;
  * ``params_from_numpy(jax.tree.map(np.asarray, params), device)`` turns a
    model's parameter tree (programmed ``w_tilde`` / ``dw`` siblings
    included) into the port's, so both packages compute with the same
    weights.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .core import crossbar
from .core.crossbar import CrossbarConfig
from .core.devices import DeviceModel
from .core.virtualization import MCAGeometry
from .core.prng import fold_in
from .engine import AnalogEngine, AnalogMatrix, AnalogMatrixGroup, _scale_stats

__all__ = ["config_from_dict", "image_from_numpy", "group_from_numpy",
           "params_from_numpy"]


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


def _padded(at_blocks: np.ndarray, da_blocks: np.ndarray,
            cfg: CrossbarConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., mb, nb, cap_m, cap_n) blocks -> (..., Mp, Np) padded tensors."""
    at_blocks = np.asarray(at_blocks, np.float32)
    da_blocks = np.asarray(da_blocks, np.float32)
    if da_blocks.shape != at_blocks.shape:
        raise ValueError(f"image shapes differ: {at_blocks.shape} vs "
                         f"{da_blocks.shape}")
    *lead, mb, nb, cap_m, cap_n = at_blocks.shape
    if (cap_m, cap_n) != cfg.geom.capacity:
        raise ValueError(f"blocks of {(cap_m, cap_n)} do not match the "
                         f"capacity {cfg.geom.capacity}")
    k = len(lead)

    def padded(blocks):
        axes = tuple(range(k)) + (k, k + 2, k + 1, k + 3)
        dense = blocks.transpose(axes).reshape(*lead, mb * cap_m, nb * cap_n)
        # A copy: the blocks may be a read-only view of a JAX array.
        return torch.from_numpy(np.array(dense, order="C")).to(device)

    return padded(at_blocks), padded(da_blocks)


def image_from_numpy(at_blocks: np.ndarray, da_blocks: np.ndarray,
                     shape: Tuple[int, int], cfg: CrossbarConfig, device,
                     *, backend: str = "reference") -> AnalogMatrix:
    """A port handle holding the (mb, nb, cap_m, cap_n) block images
    ``at_blocks`` / ``da_blocks``, reassembled into the padded (Mp, Np)
    layout on ``device``; its engine uses ``backend`` and its DAC schedule
    starts from key 0."""
    if np.ndim(at_blocks) != 4:
        raise ValueError(f"expected (mb, nb, cap_m, cap_n) blocks, got "
                         f"{np.shape(at_blocks)}")
    at, da = _padded(at_blocks, da_blocks, cfg, device)
    m, n = shape
    engine = AnalogEngine(cfg, backend=backend, device=device)
    return AnalogMatrix(engine=engine, shape=(int(m), int(n)),
                        base_key=0,
                        write_stats=crossbar.matrix_write_cost(m, n, cfg),
                        at_pad=at, da_pad=da)


def group_from_numpy(at_blocks_g: np.ndarray, da_blocks_g: np.ndarray,
                     shape: Tuple[int, int], cfg: CrossbarConfig, device,
                     *, member_keys: Optional[Sequence[int]] = None,
                     backend: str = "reference") -> AnalogMatrixGroup:
    """A port group holding a JAX group's (g, mb, nb, cap_m, cap_n) stacks,
    reassembled into (g, Mp, Np) padded stacks on ``device``.  Its engine
    uses ``backend``; member ``g``'s base key is ``member_keys[g]``, by
    default ``fold_in(0, g)`` (what ``program_group`` under key 0 gives)."""
    if np.ndim(at_blocks_g) != 5:
        raise ValueError(f"expected (g, mb, nb, cap_m, cap_n) stacks, got "
                         f"{np.shape(at_blocks_g)}")
    at, da = _padded(at_blocks_g, da_blocks_g, cfg, device)
    size = at.shape[0]
    keys = [fold_in(0, g) for g in range(size)] if member_keys is None \
        else [int(k) for k in member_keys]
    if len(keys) != size:
        raise ValueError(f"{len(keys)} member keys for {size} members")
    m, n = shape
    engine = AnalogEngine(cfg, backend=backend, device=device)
    return AnalogMatrixGroup(
        engine=engine, size=size, shape=(int(m), int(n)), base_key=0,
        member_keys=keys,
        write_stats=_scale_stats(crossbar.matrix_write_cost(m, n, cfg), size),
        at_pad=at, da_pad=da)


def _tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        return torch.from_numpy(np.array(a.view(np.int16))).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def params_from_numpy(tree: Any, device) -> Any:
    """The port's parameter tree from the reference's as nested dicts of
    numpy arrays: the same keys (sorted, as ``jax.tree.unflatten`` leaves
    them), each array a tensor of its dtype on ``device``."""
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(tree[k], device) for k in sorted(tree)}
    return _tensor_from_numpy(tree, device)
