"""Collective wire bytes of a run (of :mod:`repro.analysis.hlo_parse`).

The reference parses the compiled per-device program for its collectives.
The port runs the call and sees its collectives through
:data:`repro_torch.launch.mesh.OBSERVERS`: a
:func:`~repro_torch.launch.mesh.psum`, ``pmax`` or ``pmean`` over axes of
g ranks in all is an all-reduce of one partial's bytes over g (XLA
lowers all three to one), a ``ppermute`` a collective-permute of one
rank's tensor, and a
:func:`~repro_torch.launch.mesh.gather_to_lead` an all-gather of the
joined output's bytes over the mesh's size.  Each becomes one record
``{"op", "bytes", "group", "wire"}``, with the per-device wire bytes of the
ring model (:func:`collective_wire`, the reference's):

    all-gather          G (g-1)/g        G = gathered (output) bytes
    reduce-scatter      G (g-1)/g        G = unreduced (g x output) bytes
    all-reduce          2 G (g-1)/g      (reduce-scatter + all-gather)
    all-to-all          G (g-1)/g        G = output bytes
    collective-permute  G                one send

On one card every rank shares the device and nothing crosses a link: the
wire term is what the placement would move between cards if each rank had
its own, not traffic of this run.  The adds a psum does and the join's copy
are operators on the card and are counted as such by
:mod:`repro_torch.analysis.cost`.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

__all__ = ["collective_wire", "collective_record", "collective_wire_bytes",
           "count_op"]


def collective_wire(op: str, bytes_out: float, g: int) -> float:
    """Per-device wire bytes of one collective ``op`` whose output is
    ``bytes_out`` bytes, over a group of ``g`` ranks (the ring model)."""
    if op == "all-gather":
        return bytes_out * (g - 1) / g
    if op == "reduce-scatter":
        return bytes_out * (g - 1)
    if op == "all-reduce":
        return 2 * bytes_out * (g - 1) / g
    if op == "all-to-all":
        return bytes_out * (g - 1) / g
    return bytes_out   # collective-permute


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def collective_record(kind: str, axes: Sequence[str],
                      tensors: Sequence[torch.Tensor], mesh) -> Dict:
    """The record of one observed collective (``kind``, ``axes``,
    ``tensors``, ``mesh`` as :data:`repro_torch.launch.mesh.OBSERVERS` hand
    them over): a psum, pmax or pmean is an all-reduce of one partial over
    the ranks of its axes, a ppermute a collective-permute of one rank's
    tensor (one send, whatever the group), a join an all-gather of the
    joined segments over the mesh."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    if kind in ("psum", "pmax", "pmean"):
        op, g = "all-reduce", math.prod(sizes[a] for a in axes)
        bytes_out = _nbytes(tensors[0])
    elif kind == "ppermute":
        op, g = "collective-permute", math.prod(sizes[a] for a in axes)
        bytes_out = _nbytes(tensors[0])
    elif kind == "gather":
        op, g = "all-gather", mesh.size
        bytes_out = sum(_nbytes(t) for t in tensors)
    else:
        raise ValueError(f"unknown collective kind {kind!r}")
    return {"op": op, "bytes": bytes_out, "group": g,
            "wire": collective_wire(op, bytes_out, g)}


def collective_wire_bytes(records: List[Dict]
                          ) -> Tuple[float, Dict[str, float]]:
    """(total per-device wire bytes, per-op breakdown) of a run's records."""
    by_op: Dict[str, float] = {}
    for r in records:
        by_op[r["op"]] = by_op.get(r["op"], 0.0) + r["wire"]
    return sum(by_op.values()), by_op


def count_op(records: List[Dict], opname: str) -> int:
    """How many of a run's collective records are ``opname``."""
    return sum(r["op"] == opname for r in records)
