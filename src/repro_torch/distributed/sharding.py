"""Logical-axis sharding rules of the port (of
:mod:`repro.distributed.sharding`): MaxText-style and divisibility-aware.

Rule tables map logical axis names (see :mod:`repro_torch.models.params`)
to an ordered list of candidate mesh axes; the resolver shards a tensor dim
on the first candidate whose size divides the dim and which no other dim of
the same tensor already uses -- otherwise the dim is replicated.  Two
parameter rule sets:

  * ``tp``      -- inference: weights resident, sharded over ``model`` only;
  * ``fsdp_tp`` -- training: weights and optimizer state also sharded over
    ``data`` (+ ``pod``) on the embed dim.

A :class:`PartitionSpec` and a :class:`NamedSharding` are records: every
rank of the port's :class:`~repro_torch.launch.mesh.Mesh` shares one device,
so a sharding places nothing.  :func:`shard` cuts a tensor into its ranks'
blocks, each a view of the one global tensor (no copy), and :func:`unshard`
joins per-rank blocks back into one tensor; together they are the
counterpart of ``jax.device_put(a, NamedSharding)`` and of reading a
sharded array whole.  A dim the mesh cannot split raises, as ``shard_map``
does.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..launch.mesh import Mesh, mesh_axis_sizes
from ..models.params import tree_map

__all__ = [
    "PartitionSpec", "NamedSharding", "param_rules", "resolve_pspec",
    "param_pspecs", "param_shardings", "batch_pspec", "cache_pspecs",
    "mesh_axis_sizes", "data_axes", "shard", "unshard", "check_sharding",
]


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name or
    a tuple of names (the dim split over their product, row-major).  A
    one-name tuple is stored as the name, as ``jax.sharding.PartitionSpec``
    stores it."""

    def __new__(cls, *parts):
        norm = []
        for p in parts:
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                p = p[0] if len(p) == 1 else (p or None)
            norm.append(p)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding:
    """A :class:`PartitionSpec` on a mesh: a record of where each rank's
    block lies, which :func:`shard` and :func:`unshard` read."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else P(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding(mesh={self.mesh.shape}, spec={self.spec})"


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _sizes(mesh) -> Dict[str, int]:
    """Axis sizes of the port's mesh, or of any mesh with ``axis_names``
    and a ``devices`` array (the reference's)."""
    if isinstance(mesh, Mesh):
        return mesh_axis_sizes(mesh)
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def param_rules(mode: str, mesh) -> Dict[Optional[str], Tuple]:
    da = data_axes(mesh)
    # One *combined* candidate ("pod", "data") -- not two alternatives --
    # so multi-pod FSDP shards 32-way, falling back to "data" alone when
    # the dim divides only that.
    fsdp = ((da, da[-1]) if len(da) > 1 else (da[0],)) \
        if mode == "fsdp_tp" else ()
    return {
        "vocab": ("model",),
        "mlp": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "state": (),
        "expert": (),            # expert compute is TP inside the MoE
        "embed": fsdp,           # FSDP shards the d_model dim over data(+pod)
        "head_dim": (),
        "layer": (),
        None: (),
    }


def resolve_pspec(shape: Sequence[int], axes: Sequence[Optional[str]],
                  rules: Dict, sizes: Dict[str, int]) -> PartitionSpec:
    used: set = set()
    out: list = []
    for dim, ax in zip(shape, axes):
        pick = None
        for c in rules.get(ax, ()):
            c = (c,) if isinstance(c, str) else tuple(c)
            total = math.prod(sizes[cc] for cc in c)
            if all(cc not in used for cc in c) and dim % total == 0 \
                    and dim > 0:
                pick = c
                break
        if pick is None:          # a repeated logical axis falls through
            out.append(None)
        else:
            used.update(pick)
            out.append(pick if len(pick) > 1 else pick[0])
    return P(*out)


def param_pspecs(specs, mesh, mode: str = "tp"):
    """Spec tree -> tree of PartitionSpecs."""
    rules = param_rules(mode, mesh)
    sizes = _sizes(mesh)
    return tree_map(lambda s: resolve_pspec(s.shape, s.axes, rules, sizes),
                    specs)


def param_shardings(specs, mesh: Mesh, mode: str = "tp"):
    return tree_map(lambda ps: NamedSharding(mesh, ps),
                    param_pspecs(specs, mesh, mode))


def _prod(mesh, axes: Tuple[str, ...]) -> int:
    sizes = _sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def batch_pspec(leaf_shape: Sequence[int], mesh,
                global_batch: int) -> PartitionSpec:
    """Batch inputs: the dim equal to global_batch shards over (pod, data)."""
    da = data_axes(mesh)
    out: list = []
    assigned = False
    for dim in leaf_shape:
        if not assigned and dim == global_batch and dim % _prod(mesh, da) == 0:
            out.append(da if len(da) > 1 else da[0])
            assigned = True
        else:
            out.append(None)
    return P(*out)


def cache_pspecs(cache_tree, mesh, global_batch: int):
    """Decode caches: batch dim -> data axes; then the largest remaining
    dim divisible by the model-axis size -> model.  The port keeps a
    cache's ``len`` on the host; it is resolved like any other leaf."""
    da = data_axes(mesh)
    dsz = _prod(mesh, da)
    msz = _sizes(mesh).get("model", 1)

    def leaf_spec(leaf):
        shape = tuple(leaf.shape)
        out: list = [None] * len(shape)
        for i, dim in enumerate(shape):
            if dim == global_batch and dim % dsz == 0:
                out[i] = da if len(da) > 1 else da[0]
                break
        # model axis on the largest divisible non-batch dim
        best, best_dim = None, 0
        for i, dim in enumerate(shape):
            if out[i] is None and dim % msz == 0 and dim > best_dim \
                    and dim >= msz:
                best, best_dim = i, dim
        if best is not None and msz > 1:
            out[best] = "model"
        return P(*out)

    return tree_map(leaf_spec, cache_tree)


# --------------------------------------------------------------------------- #
# Per-rank views
# --------------------------------------------------------------------------- #

def _dim_axes(spec: PartitionSpec, ndim: int) -> List[Tuple[str, ...]]:
    if len(spec) > ndim:
        raise ValueError(f"partition spec {spec} has more entries than the "
                         f"tensor's {ndim} dims")
    out = []
    for p in tuple(spec) + (None,) * (ndim - len(spec)):
        out.append(() if p is None else (p,) if isinstance(p, str)
                   else tuple(p))
    return out


def check_sharding(shape: Sequence[int], sharding: NamedSharding
                   ) -> List[Tuple[str, ...]]:
    """The mesh axes of each dim of a ``shape`` tensor under ``sharding``;
    raises ``ValueError`` where the spec names an axis the mesh lacks,
    names an axis twice, or does not divide a dim."""
    mesh, spec = sharding.mesh, sharding.spec
    dims = _dim_axes(spec, len(shape))
    sizes = mesh_axis_sizes(mesh)
    named = [a for axes in dims for a in axes]
    if len(set(named)) != len(named):
        raise ValueError(f"partition spec {spec} names a mesh axis twice")
    for d, axes in enumerate(dims):
        unknown = [a for a in axes if a not in sizes]
        if unknown:
            raise ValueError(f"partition spec {spec}: {unknown} not axes of "
                             f"the mesh {mesh.axis_names}")
        n = math.prod(sizes[a] for a in axes)
        if shape[d] % n:
            raise ValueError(f"dim {d} of a {tuple(shape)} tensor does not "
                             f"split over {axes} ({n} ranks) under {spec}")
    return dims


def _block_index(mesh: Mesh, rank: int, dims) -> Tuple[int, ...]:
    c = mesh.coords(rank)
    sizes = mesh_axis_sizes(mesh)
    out = []
    for axes in dims:
        i = 0
        for a in axes:              # row-major over the dim's axes
            i = i * sizes[a] + c[a]
        out.append(i)
    return tuple(out)


def shard(t: torch.Tensor, sharding: NamedSharding) -> List[torch.Tensor]:
    """Rank ``r``'s block of ``t`` for every rank, in rank order: each a
    view of ``t`` (no copy).  Ranks that differ only on axes the spec does
    not name get the same view.  The blocks of each dim come from one
    ``chunk``, whose gradient is one concatenation."""
    mesh = sharding.mesh
    dims = check_sharding(t.shape, sharding)
    sizes = mesh_axis_sizes(mesh)
    blocks: Dict[Tuple[int, ...], torch.Tensor] = {(): t}
    for d, axes in enumerate(dims):
        n = math.prod(sizes[a] for a in axes)
        blocks = {k + (i,): part for k, v in blocks.items()
                  for i, part in enumerate(v.chunk(n, d) if n > 1 else (v,))}
    return [blocks[_block_index(mesh, r, dims)] for r in range(mesh.size)]


def unshard(shards: Sequence[torch.Tensor],
            sharding: NamedSharding) -> torch.Tensor:
    """The global tensor whose :func:`shard` under ``sharding`` is
    ``shards`` (one block per rank, rank order): the first rank's block of
    each position, joined by ``torch.cat`` dim by dim.  Where the spec
    splits nothing, that is the first rank's tensor itself."""
    mesh = sharding.mesh
    if len(shards) != mesh.size:
        raise ValueError(f"unshard needs one block per rank ({mesh.size}), "
                         f"got {len(shards)}")
    ndim = shards[0].ndim
    dims = _dim_axes(sharding.spec, ndim)
    sizes = mesh_axis_sizes(mesh)
    counts = [math.prod(sizes[a] for a in axes) for axes in dims]
    blocks: Dict[Tuple[int, ...], torch.Tensor] = {}
    for r in range(mesh.size):
        blocks.setdefault(_block_index(mesh, r, dims), shards[r])

    def join(prefix: Tuple[int, ...], d: int) -> torch.Tensor:
        if d == ndim:
            return blocks[prefix]
        parts = [join(prefix + (i,), d + 1) for i in range(counts[d])]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)

    return join((), 0)
