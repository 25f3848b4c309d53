"""Mesh topology of the port (port of :mod:`repro.launch.mesh`).

A :class:`Mesh` is a named R x C (or any-rank) grid of ranks, each with the
device its tensors live on, driven from one process: the single-controller
image of the JAX package's ``shard_map`` over a device mesh.  Rank ``r`` is
the row-major index of its coordinates over ``shape``.  :func:`psum` adds
one partial per rank over the named axes in fixed rank order, on the device
of the first rank of each group, so a result does not depend on where the
ranks run.

:func:`pmax`, :func:`pmean` and :func:`ppermute` are ``jax.lax``'s
namesakes on the same per-rank lists.

:func:`gather_to_lead` joins the ranks' output segments in order on the
lead device.  The collective audit of :mod:`repro_torch.analysis.verify`
observes them all, and so does the wire count of
:mod:`repro_torch.analysis.wire`: while :data:`OBSERVERS` is not empty,
each call hands every observer ``(kind, axes, tensors, mesh)``, ``kind``
``"psum"``, ``"pmax"``, ``"pmean"``, ``"ppermute"`` or ``"gather"``.
Idle, the hook is one list test.

Every rank of a mesh must name the same device: several cards need a
``torch.distributed`` (NCCL) process group behind the same :func:`psum`,
which ROADMAP Queue A16 holds; any other mesh raises ``ValueError`` naming
it.  Functions, not module constants: importing this module touches no
device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Sequence, Tuple, Union

import torch

__all__ = ["Mesh", "make_mesh", "make_production_mesh", "axis_index",
           "mesh_axis_sizes", "psum", "pmax", "pmean", "ppermute",
           "gather_to_lead", "OBSERVERS"]

#: ``observer(kind, axes, tensors, mesh)`` for every collective of this
#: module while an audit or a cost count runs.
OBSERVERS: List[Callable] = []

_MULTI_DEVICE = ("ROADMAP Queue A16 (several cards: a torch.distributed "
                 "NCCL process group behind the same psum)")


def pin_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a bare ``"cuda"`` gets the current
    index, so it compares equal to tensor devices (and raises where there
    is no GPU: nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of ranks: ``shape`` over ``axis_names``, and ``devices``, one
    per rank in row-major rank order."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names) or not self.shape:
            raise ValueError(f"mesh shape {self.shape} does not match axes "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axis names repeat: {self.axis_names}")
        if any(int(s) < 1 for s in self.shape):
            raise ValueError(f"mesh axes need at least one rank: {self.shape}")
        if len(self.devices) != self.size:
            raise ValueError(f"a {self.shape} mesh has {self.size} ranks, "
                             f"got {len(self.devices)} devices")
        if len(set(self.devices)) != 1:
            raise ValueError(
                f"the mesh's ranks name the devices "
                f"{sorted({str(d) for d in self.devices})}: only meshes "
                f"whose ranks share one device run here; several devices "
                f"wait for {_MULTI_DEVICE}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def lead_device(self) -> torch.device:
        """The device of rank 0, where global results are assembled."""
        return self.devices[0]

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank ``rank``'s index along every axis."""
        if not 0 <= rank < self.size:
            raise IndexError(f"rank {rank} of a {self.size}-rank mesh")
        out = {}
        for name, size in zip(reversed(self.axis_names),
                              reversed(self.shape)):
            rank, out[name] = divmod(rank, size)
        return {name: out[name] for name in self.axis_names}

    def rank(self, coords: Dict[str, int]) -> int:
        """The rank at ``coords`` (every axis named)."""
        r = 0
        for name, size in zip(self.axis_names, self.shape):
            idx = int(coords[name])
            if not 0 <= idx < size:
                raise IndexError(f"index {idx} on mesh axis {name!r} of "
                                 f"size {size}")
            r = r * size + idx
        return r


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: Union[str, torch.device, Sequence] = "cuda") -> Mesh:
    """A mesh of ``shape`` over ``axes``; ``device`` is one device for every
    rank or a sequence of one device per rank (row-major rank order)."""
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape)
    if isinstance(device, (str, torch.device)):
        devices = (pin_device(device),) * size
    else:
        devices = tuple(pin_device(d) for d in device)
    return Mesh(shape=shape, axis_names=tuple(axes), devices=devices)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Union[str, torch.device] = "cuda") -> Mesh:
    """The reference's production topology: 16 x 16 over ("data", "model"),
    or 2 x 16 x 16 with a leading "pod" axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def mesh_axis_sizes(mesh: Mesh) -> Dict[str, int]:
    """{axis name: ranks along it}."""
    return dict(zip(mesh.axis_names, mesh.shape))


def axis_index(mesh: Mesh, rank: int, axis: str) -> int:
    """Rank ``rank``'s index along ``axis`` (``jax.lax.axis_index``)."""
    return mesh.coords(rank)[axis]


def _groups(mesh: Mesh, axes: Tuple[str, ...]) -> List[List[int]]:
    """The ranks of each group that shares its indices off ``axes``, in
    rank order."""
    groups: Dict[tuple, List[int]] = {}
    for r in range(mesh.size):
        c = mesh.coords(r)
        groups.setdefault(tuple(c[a] for a in mesh.axis_names
                                if a not in axes), []).append(r)
    return list(groups.values())


def _reduce(kind: str, mesh: Mesh, partials: Sequence[torch.Tensor],
            axes: Union[str, Sequence[str]], combine) -> List[torch.Tensor]:
    """``combine(acc, partial)`` over each group's partials in rank order,
    into a clone of the first on the device of the group's first rank;
    the group's ranks share that one result tensor."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    unknown = set(axes) - set(mesh.axis_names)
    if unknown:
        raise ValueError(f"{kind} over {sorted(unknown)}: not axes of the "
                         f"mesh {mesh.axis_names}")
    if len(partials) != mesh.size:
        raise ValueError(f"{kind} needs one partial per rank ({mesh.size}), "
                         f"got {len(partials)}")
    for observe in OBSERVERS:
        observe(kind, axes, partials, mesh)
    out: List[torch.Tensor] = [None] * mesh.size
    for ranks in _groups(mesh, axes):
        dev = mesh.devices[ranks[0]]
        acc = partials[ranks[0]].to(dev)
        if len(ranks) > 1:
            acc = acc.clone()
            for r in ranks[1:]:
                acc = combine(acc, partials[r].to(dev))
        for r in ranks:
            out[r] = acc
    return out


def _add(acc, t):
    acc += t
    return acc


def psum(mesh: Mesh, partials: Sequence[torch.Tensor],
         axes: Union[str, Sequence[str]]) -> List[torch.Tensor]:
    """Sum over ``axes`` (``jax.lax.psum``): ``partials[r]`` is rank ``r``'s;
    every rank gets the sum over the ranks that share its indices on the
    other axes.  Each group's partials are added in rank order on the device
    of its first rank, and the group's ranks share that one result tensor."""
    return _reduce("psum", mesh, partials, axes, _add)


def pmax(mesh: Mesh, partials: Sequence[torch.Tensor],
         axes: Union[str, Sequence[str]]) -> List[torch.Tensor]:
    """The elementwise maximum over ``axes`` (``jax.lax.pmax``), grouped as
    :func:`psum` groups."""
    return _reduce("pmax", mesh, partials, axes, torch.maximum)


def pmean(mesh: Mesh, partials: Sequence[torch.Tensor],
          axes: Union[str, Sequence[str]]) -> List[torch.Tensor]:
    """The mean over ``axes`` (``jax.lax.pmean``: the :func:`psum` over the
    group divided by its size), grouped as :func:`psum` groups."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sums = _reduce("pmean", mesh, partials, axes, _add)
    sizes = mesh_axis_sizes(mesh)
    n = math.prod(sizes[a] for a in axes)
    means: Dict[int, torch.Tensor] = {}
    return [means.setdefault(id(t), t / n) for t in sums]


def ppermute(mesh: Mesh, tensors: Sequence[torch.Tensor], axis: str,
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``jax.lax.ppermute`` along ``axis``: for each ``(src, dst)`` of
    ``perm``, the rank at index ``dst`` on ``axis`` receives the tensor of
    the rank at index ``src`` with the same indices on the other axes
    (moved to its device); a rank that receives nothing gets zeros."""
    if axis not in mesh.axis_names:
        raise ValueError(f"ppermute over {axis!r}: not an axis of the mesh "
                         f"{mesh.axis_names}")
    if len(tensors) != mesh.size:
        raise ValueError(f"ppermute needs one tensor per rank ({mesh.size}), "
                         f"got {len(tensors)}")
    size = mesh_axis_sizes(mesh)[axis]
    perm = [(int(s), int(d)) for s, d in perm]
    if any(not (0 <= s < size and 0 <= d < size) for s, d in perm) or \
            len({s for s, _ in perm}) != len(perm) or \
            len({d for _, d in perm}) != len(perm):
        raise ValueError(f"ppermute: {perm} is not a permutation of indices "
                         f"of axis {axis!r} (size {size})")
    for observe in OBSERVERS:
        observe("ppermute", (axis,), tensors, mesh)
    source = {d: s for s, d in perm}
    out: List[torch.Tensor] = []
    for r in range(mesh.size):
        c = mesh.coords(r)
        if c[axis] in source:
            src = mesh.rank({**c, axis: source[c[axis]]})
            out.append(tensors[src].to(mesh.devices[r]))
        else:
            out.append(torch.zeros_like(tensors[r]))
    return out


def gather_to_lead(mesh: Mesh, segments: Sequence[torch.Tensor],
                   dim: int = 0) -> torch.Tensor:
    """The ranks' output segments joined in order along ``dim`` on the
    mesh's lead device: one global tensor."""
    for observe in OBSERVERS:
        observe("gather", (), segments, mesh)
    return torch.cat([s.to(mesh.lead_device) for s in segments], dim=dim)
