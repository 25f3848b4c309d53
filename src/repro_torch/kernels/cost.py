"""The declared work of each kernel function: one cost per function, beside
the kernels, the same whichever implementation runs the call.

Each cost function takes the shapes of a call and returns ``Cost(flops,
bytes)``: every operand read once and every output written once, float32
(4 bytes an element), and a multiply-add as 2 flops.  That is the least
traffic the function's work needs, the bound a roofline reads; a launcher
that re-reads an operand (``_launch_ec`` reads the images once per
:data:`~repro_torch.kernels.rram_mvm.MAX_KERNEL_BATCH` columns) moves more,
and :func:`ec_launch_bytes` counts that traffic.

Observers.  Each of the ten kernel wrappers (``ec_matmul``, ``ec_rmatmul``,
``ec_group_matmul``, ``ec_group_rmatmul``, ``stencil_denoise``,
``thomas_solve``, ``cg_update``, ``richardson_update``, ``encode_matmul``,
``encode_matmul_rng``) and its ``*_plain`` twin, when the twin is called
directly, tell every observer of :data:`OBSERVERS` ``(event, name, cost)``
at entry (``event`` ``"enter"``) and at exit (``"exit"``), ``name`` the
wrapper's, and run inside a ``torch.profiler.record_function`` range named
:func:`range_name`.  A kernel function called inside another one (a wrapper
running its plain twin on the CPU, a grouped twin running the solo twin
member by member) is part of the outer call: only the outermost is seen.
With no observer registered a call pays one test of an empty list.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple

import torch

__all__ = ["Cost", "OBSERVERS", "KERNEL_FUNCTIONS", "ec_matmul", "ec_rmatmul",
           "ec_group_matmul", "ec_group_rmatmul", "stencil_denoise",
           "thomas_solve", "cg_update", "richardson_update", "encode_matmul",
           "encode_matmul_rng", "ec_launch_bytes", "of_call", "range_name",
           "outermost", "observed"]

#: ``observer(event, name, cost)`` at the entry (``"enter"``) and exit
#: (``"exit"``) of every outermost kernel function call while registered.
OBSERVERS: List[Callable] = []

F32 = 4


class Cost(NamedTuple):
    """A call's floating-point operations and the bytes it must move."""
    flops: int
    bytes: int


def ec_matmul(m: int, k: int, batch: int) -> Cost:
    """``at @ x + da @ x_t``: the two (m, k) images and the two (k, batch)
    panels read, the (m, batch) output written; two products."""
    return Cost(4 * m * k * batch,
                F32 * (2 * m * k + 2 * k * batch + m * batch))


def ec_rmatmul(m: int, k: int, batch: int) -> Cost:
    """``at.T @ y + da.T @ y_t`` on (m, k) images: the images and the two
    (m, batch) panels read, the (k, batch) output written."""
    return Cost(4 * m * k * batch,
                F32 * (2 * m * k + 2 * m * batch + k * batch))


def ec_group_matmul(g: int, m: int, k: int, batch: int) -> Cost:
    """:func:`ec_matmul` for each of g members at ``batch`` columns a
    member: the (g, m, k) stacks, the (k, g batch) panels read, the (m, g
    batch) output written."""
    return Cost(4 * g * m * k * batch,
                F32 * (2 * g * m * k + 2 * k * g * batch + m * g * batch))


def ec_group_rmatmul(g: int, m: int, k: int, batch: int) -> Cost:
    """:func:`ec_rmatmul` for each of g members: the (g, m, k) stacks, the
    (m, g batch) panels read, the (k, g batch) output written."""
    return Cost(4 * g * m * k * batch,
                F32 * (2 * g * m * k + 2 * m * g * batch + k * g * batch))


def stencil_denoise(n: int, batch: int) -> Cost:
    """``p - lam (L^T L) p`` on an (n, batch) panel: p read, y written; 6
    flops an element (the second difference, the scale, the subtraction)."""
    return Cost(6 * n * batch, F32 * 2 * n * batch)


def thomas_solve(n: int, batch: int, lam: float, h: float = -1.0) -> Cost:
    """``(I + lam L^T L)^{-1} p`` on an (n, batch) panel: p read, y
    written, and the two coefficient rows below their fixed point
    (:func:`~repro_torch.kernels.tridiag.thomas_tail`), the only ones the
    kernel reads; 5 flops an element over the two recurrences."""
    from .tridiag import thomas_tail
    head = thomas_tail(n, lam, h)[0]
    return Cost(5 * n * batch, F32 * (2 * n * batch + 2 * head))


def cg_update(n: int, batch: int) -> Cost:
    """``(x + alpha p, r - alpha ap)`` on (n, batch) panels: four panels
    and the batch alphas read, two panels written."""
    return Cost(4 * n * batch, F32 * (6 * n * batch + batch))


def richardson_update(n: int, batch: int) -> Cost:
    """``(x + omega (b - y), b - y)`` on (n, batch) panels: three panels
    and omega read, two panels written."""
    return Cost(3 * n * batch, F32 * (5 * n * batch + 1))


def encode_matmul(m: int, k: int, n: int) -> Cost:
    """``x @ (Q(w) (1 + sigma eps))``: x (m, k), w and eps (k, n) read,
    the (m, n) output written; the product's 2 m k n flops (the encoding's
    k n elementwise work is left out)."""
    return Cost(2 * m * k * n, F32 * (m * k + 2 * k * n + m * n))


def encode_matmul_rng(m: int, k: int, n: int) -> Cost:
    """:func:`encode_matmul` with eps drawn inside the kernel: x and w
    read, the output written; the product's flops (the generator's
    integer work is not a floating-point operation)."""
    return Cost(2 * m * k * n, F32 * (m * k + k * n + m * n))


def ec_launch_bytes(m: int, k: int, batch: int, *, transpose: bool,
                    g: int = 1) -> int:
    """Bytes an ``ec_matmul`` (``transpose`` False) or ``ec_rmatmul`` call
    on (m, k) images moves as launched (with ``g`` > 1, the grouped call on
    (g, m, k) stacks at ``batch`` columns a member): the images read once
    per :data:`~repro_torch.kernels.rram_mvm.MAX_KERNEL_BATCH` columns (one
    launch of ``_launch_ec`` each), the panels once.  Equal to the declared
    bytes up to that many columns; above it the difference is the
    launcher's re-reads of the images."""
    from .rram_mvm import MAX_KERNEL_BATCH
    launches = -(-batch // MAX_KERNEL_BATCH)
    if g == 1:
        declared = (ec_rmatmul if transpose else ec_matmul)(m, k, batch)
    else:
        declared = (ec_group_rmatmul if transpose else ec_group_matmul)(
            g, m, k, batch)
    return declared.bytes + (launches - 1) * F32 * 2 * g * m * k


def _panel(t: torch.Tensor):
    """(rows, columns) of a panel argument (a vector is one column)."""
    n = t.shape[0] if t.ndim else 1
    return n, (t.numel() // n if n else 0)


def _ec(fn):
    return lambda at, da, u, u_t: fn(at.shape[-2], at.shape[-1],
                                     _panel(u)[1])


def _group(fn):
    return lambda at, da, u, u_t: fn(at.shape[0], at.shape[-2],
                                     at.shape[-1],
                                     _panel(u)[1] // at.shape[0])


def _thomas(p, lam, h=-1.0):
    return thomas_solve(*_panel(p), lam, h)


def _encode(fn):
    def cost(x, w, *_, **__):
        return fn(x.shape[0], x.shape[1], w.shape[1])
    return cost


def _encode_rng(seed, x, w, *_, **__):
    return encode_matmul_rng(x.shape[0], x.shape[1], w.shape[1])


#: The ten kernel functions: name -> the cost of a call from its arguments
#: (the wrapper's and its plain twin's, which take the same leading ones).
KERNEL_FUNCTIONS: Dict[str, Callable[..., Cost]] = {
    "ec_matmul": _ec(ec_matmul),
    "ec_rmatmul": _ec(ec_rmatmul),
    "ec_group_matmul": _group(ec_group_matmul),
    "ec_group_rmatmul": _group(ec_group_rmatmul),
    "stencil_denoise": lambda p, *_, **__: stencil_denoise(*_panel(p)),
    "thomas_solve": _thomas,
    "cg_update": lambda x, *_, **__: cg_update(*_panel(x)),
    "richardson_update": lambda x, *_, **__: richardson_update(*_panel(x)),
    "encode_matmul": _encode(encode_matmul),
    "encode_matmul_rng": _encode_rng,
}


def of_call(name: str, *args, **kwargs) -> Cost:
    """The declared cost of the kernel function ``name`` called with
    ``args`` / ``kwargs``."""
    return KERNEL_FUNCTIONS[name](*args, **kwargs)


def range_name(name: str) -> str:
    """The ``torch.profiler.record_function`` range a kernel function's
    call runs in while an observer is registered."""
    return f"repro_torch.kernels.{name}"


_inside = [False]


def outermost() -> bool:
    """True unless a kernel function call is running already."""
    return not _inside[0]


def observed(name: str, fn: Callable, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` (a kernel function, which re-enters
    here no further) as the outermost call of ``name``: tell the observers
    at entry and exit, inside the profiler range :func:`range_name`."""
    cost = of_call(name, *args, **kwargs)
    for observe in OBSERVERS:
        observe("enter", name, cost)
    _inside[0] = True
    try:
        with torch.profiler.record_function(range_name(name)):
            return fn(*args, **kwargs)
    finally:
        _inside[0] = False
        for observe in OBSERVERS:
            observe("exit", name, cost)

