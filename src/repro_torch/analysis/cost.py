"""The cost model of one run: flops, bytes and collective wire bytes (of
:mod:`repro.analysis.hlo_cost`).

The reference walks the compiled program's HLO text.  Eager PyTorch has no
such program, so :func:`measure_cost` *runs* the call once under a
:class:`~torch.utils._python_dispatch.TorchDispatchMode` and counts every
operator the dispatcher sees, under the reference's conventions:

  * matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, the attention
    operators ``torch.utils.flop_counter``'s registry covers): that
    registry's formulas; ``mv``, ``addmv``, ``dot`` and ``vdot``, which it
    does not cover, 2 flops a multiply-add as the reference's ``dot``;
  * views and aliases, and ``empty*``: free (the reference's ``_ZERO_OPS``);
  * reductions: ``max(in_elements, out_elements)`` flops;
  * every other operator: 1 flop per output element;
  * bytes: every tensor an operator reads plus every tensor it writes.

A hand-written kernel launched through ``ctypes`` is not an operator.  Each
kernel function (the ten wrappers of :mod:`repro_torch.kernels` and their
plain twins) is counted by its declared cost (:mod:`repro_torch.kernels.cost`),
and the operators run inside it are not counted again: neither the plain
twin's on the CPU nor the launcher's ``torch.empty`` on the card.  So a call
counts the same whether the CUDA kernel or its plain twin ran it.

Collectives come from :data:`repro_torch.launch.mesh.OBSERVERS` and carry
the wire bytes of :mod:`repro_torch.analysis.wire`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import cost as kernel_cost
from ..launch import mesh as mesh_mod
from . import wire
from .memory import _describe, _tensors

__all__ = ["RunCost", "measure_cost", "op_cost"]

aten = torch.ops.aten

_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided}

_REDUCTIONS = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max,
               aten.min, aten.argmax, aten.argmin, aten.prod, aten.norm,
               aten.linalg_vector_norm, aten.var, aten.std, aten.var_mean,
               aten.std_mean, aten.any, aten.all, aten.logsumexp,
               aten.nansum, aten.count_nonzero, aten.aminmax, aten.median,
               aten.nanmedian, aten.sort, aten.topk}


def _dot_flops(lhs: torch.Tensor, out: torch.Tensor) -> int:
    """2 x output elements x the contraction (the lhs's last side)."""
    return 2 * max(out.numel(), 1) * (lhs.shape[-1] if lhs.ndim else 1)


#: Products the flop counter's registry leaves out: name -> flops of a call.
_PRODUCTS = {
    aten.mv: lambda a, out: _dot_flops(a[0], out),
    aten.addmv: lambda a, out: _dot_flops(a[1], out),
    aten.dot: lambda a, out: _dot_flops(a[0], out),
    aten.vdot: lambda a, out: _dot_flops(a[0], out),
}


@dataclasses.dataclass
class RunCost:
    """A run's flops, bytes and collective wire bytes (per op)."""
    flops: float = 0.0
    bytes: float = 0.0
    wire: float = 0.0
    wire_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __iadd__(self, o: "RunCost"):
        self.flops += o.flops
        self.bytes += o.bytes
        self.wire += o.wire
        for k, v in o.wire_by_op.items():
            self.wire_by_op[k] = self.wire_by_op.get(k, 0.0) + v
        return self

    def scaled(self, k: float) -> "RunCost":
        return RunCost(self.flops * k, self.bytes * k, self.wire * k,
                       {kk: v * k for kk, v in self.wire_by_op.items()})


def _is_alias(func) -> bool:
    """Every return aliases an input without writing it: a view."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def op_cost(func, args, kwargs, out) -> Tuple[float, int]:
    """``(flops, bytes)`` of one dispatched operator under the conventions
    above."""
    packet = func._overloadpacket
    if packet in _FREE or func.namespace == "profiler" or _is_alias(func):
        return 0.0, 0
    ins, outs = _tensors((args, kwargs), []), _tensors(out, [])
    nbytes = _nbytes(ins) + _nbytes(outs)
    if packet in flop_registry:
        flops = flop_registry[packet](*args, **kwargs, out_val=out)
    elif packet in _PRODUCTS:
        flops = _PRODUCTS[packet](args, outs[0])
    elif packet in _REDUCTIONS:
        flops = max(max((t.numel() for t in ins), default=0),
                    sum(t.numel() for t in outs))
    else:
        flops = sum(t.numel() for t in outs)
    return float(flops), nbytes


def _describe_all(out) -> str:
    return ",".join(map(_describe, _tensors(out, [])))


class _CostMode(TorchDispatchMode):
    """Adds every operator's cost outside a kernel function, each kernel
    function's declared cost, and each collective's wire bytes."""

    def __init__(self, record: Optional[List] = None):
        super().__init__()
        self.total = RunCost()
        self.record = record
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.inside = False

    def _add(self, flops, nbytes, wire_b, op, name, shape, by_op=None):
        self.total += RunCost(flops, nbytes, wire_b, by_op or {})
        if self.record is not None:
            self.record.append((float(nbytes), float(flops), float(wire_b),
                                op, name, shape[:80]))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.inside:
            flops, nbytes = op_cost(func, args, kwargs, out)
            if flops or nbytes:
                self._add(flops, nbytes, 0.0, func._overloadpacket.__name__,
                          str(func), _describe_all(out))
        return out

    def on_kernel(self, event: str, name: str, cost) -> None:
        self.inside = event == "enter"
        if self.inside:
            k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                               "bytes": 0})
            k["calls"] += 1
            k["flops"] += cost.flops
            k["bytes"] += cost.bytes
            self._add(cost.flops, cost.bytes, 0.0, name,
                      kernel_cost.range_name(name), "declared")

    def on_collective(self, kind, axes, tensors, mesh) -> None:
        rec = wire.collective_record(kind, axes, tensors, mesh)
        self._add(0.0, 0, rec["wire"], rec["op"], f"launch.mesh.{kind}",
                  _describe_all(tensors[:1]), {rec["op"]: rec["wire"]})


def _measure(fn, args, kwargs, record) -> Tuple[_CostMode, Any]:
    """Run ``fn(*args, **kwargs)`` once under the counting mode and its
    observers (removed again however the call ends)."""
    mode = _CostMode(record)
    kernel_cost.OBSERVERS.append(mode.on_kernel)
    mesh_mod.OBSERVERS.append(mode.on_collective)
    try:
        with mode:
            out = fn(*args, **kwargs)
    finally:
        kernel_cost.OBSERVERS.remove(mode.on_kernel)
        mesh_mod.OBSERVERS.remove(mode.on_collective)
    return mode, out


def measure_cost(fn, *args, record: Optional[List] = None,
                 **kwargs) -> RunCost:
    """Flops, bytes and wire bytes of one run of ``fn(*args, **kwargs)``.
    With ``record`` a list, also appends ``(bytes, flops, wire, op, name,
    shape[:80])`` per counted operator, kernel function and collective,
    which sum to the totals."""
    return _measure(fn, args, kwargs, record)[0].total
