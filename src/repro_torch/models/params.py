"""Parameter-spec machinery of the port (of :mod:`repro.models.params`).

A model is described once as a *spec tree*: nested dicts whose leaves are
:class:`ParamSpec` (shape + logical axes + initializer).  From it:

  * ``materialize(specs, key, dtype, device)`` -> real parameter tree;
  * ``abstract(specs, dtype)``                 -> :class:`ShapeDtype` tree;
  * ``logical_axes(specs)``                    -> tree of logical-axis tuples.

Trees are plain nested dicts.  Like the reference's (whose trees come out
of ``jax.tree.unflatten``), every dict that ``materialize`` builds has its
keys in sorted order, and leaves are visited in that order: the walk order
that :func:`repro_torch.models.rram.program_rram` keys its kernels by.

Logical axis vocabulary: "embed", "mlp", "heads", "kv_heads", "head_dim",
"vocab", "expert", "state", "layer" (the stacked leading axis), None.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.prng import fold_in, generator

__all__ = ["ParamSpec", "ShapeDtype", "spec", "materialize", "abstract",
           "logical_axes", "is_spec", "tree_paths", "stack_specs",
           "tree_map", "unstack", "torch_dtype", "split_key"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | embed | small
    scale: Optional[float] = None  # overrides the default fan-in scale
    dtype: Any = None              # overrides the materialize dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


class ShapeDtype(NamedTuple):
    """A parameter that is never allocated: its shape and dtype."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def spec(shape, axes, init="normal", scale=None, dtype=None) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), init, scale, dtype)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def torch_dtype(d) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` / a torch dtype -> the torch dtype."""
    if isinstance(d, torch.dtype):
        return d
    out = getattr(torch, str(d), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {d!r}")
    return out


def split_key(key: int, n: int) -> list:
    """``n`` keys from ``key`` (the port's ``jax.random.split``):
    ``fold_in(key, i)`` for ``i < n``."""
    return [fold_in(key, i) for i in range(n)]


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf of a tree of nested dicts; the dicts come back
    with their keys sorted."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def unstack(tree) -> list:
    """The per-layer trees of a stacked tree (one a slice of the leaves'
    leading axis): ``leaf[l]`` of every leaf, cut with one ``unbind`` a
    leaf, whose backward stacks the layers' gradients once (``leaf[l]``
    alone would scatter each into a zero tensor of the whole stack)."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    n = len(tree_paths(parts)[0][1])
    return [tree_map(lambda t: t[l], parts) for l in range(n)]


def _leaves(tree, path=""):
    """[(keystr path, leaf)] of a dict tree in sorted-key order; the paths
    are ``jax.tree_util.keystr``'s (``"['layers']['attn']['wq']['w']"``)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], f"{path}[{k!r}]")
        return out
    return [(path, tree)]


def _truncated_normal(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard normal truncated to (-2, 2), float32, by inverting the CDF
    of a uniform draw (the reference's construction)."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    u.mul_(hi - lo).add_(lo)
    out = u.erfinv_().mul_(math.sqrt(2.0))
    return out.clamp_(math.nextafter(-2.0, 0.0), math.nextafter(2.0, 0.0))


def _init_leaf(s: ParamSpec, key: int, dtype, device) -> torch.Tensor:
    dt = torch_dtype(s.dtype or dtype)
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dt, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dt, device=device)
    gen = generator(key, device)
    if s.init in ("embed", "small"):
        sc = s.scale if s.scale is not None else \
            (1.0 if s.init == "embed" else 0.02)
        w = torch.randn(s.shape, generator=gen, device=device,
                        dtype=torch.float32)
        return w.mul_(sc).to(dt)
    # default: truncated-normal fan-in scaling on the contraction dim(s):
    # the LAST axis is the output dim, everything else is fan-in, except
    # stacked-layer ("layer") and expert ("expert") leading axes.
    dims = [d for d, a in zip(s.shape, s.axes) if a not in ("layer", "expert")]
    fan_in = max(1, int(np.prod(dims[:-1])) if len(dims) > 1 else
                 (dims[0] if dims else 1))
    sc = s.scale if s.scale is not None else 1.0 / math.sqrt(fan_in)
    return _truncated_normal(s.shape, gen, device).mul_(sc).to(dt)


def materialize(specs, key: int, dtype=torch.float32, device="cuda"):
    """Real parameters from a spec tree, deterministic in ``key``: leaf
    ``i`` of the sorted walk draws from ``split_key(key, n)[i]``."""
    leaves = _leaves(specs)
    keys = iter(split_key(key, len(leaves)))
    device = torch.device(device)
    return tree_map(lambda s: _init_leaf(s, next(keys), dtype, device),
                    specs)


def abstract(specs, dtype=torch.float32):
    """:class:`ShapeDtype` tree -- parameters that are never allocated."""
    return tree_map(lambda s: ShapeDtype(s.shape,
                                         torch_dtype(s.dtype or dtype)),
                    specs)


def logical_axes(specs):
    """Tree of logical-axis tuples, same structure as the params."""
    return tree_map(lambda s: s.axes, specs)


def tree_paths(tree):
    """[(path_string, leaf)] in the reference's order and notation."""
    return _leaves(tree)


def stack_specs(n: int, layer_specs):
    """Prepend an (n,)-sized "layer" axis to every spec (stacked layers)."""
    return tree_map(lambda s: ParamSpec((n,) + s.shape, ("layer",) + s.axes,
                                        s.init, s.scale, s.dtype),
                    layer_specs)
