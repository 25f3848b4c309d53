"""Allocation analysis of the port (of :mod:`repro.analysis.memory`): the
largest tensor a call holds, and its allocator peak on the card.

The paper's scalability claim is that a >= 65,536^2 solve never allocates an
A-sized array.  The reference proves it on the jaxpr before anything runs.
Eager PyTorch has no jaxpr, so :func:`max_aval_elements` *runs* the call
once under a :class:`~torch.utils._python_dispatch.TorchDispatchMode` and
records the largest ``numel`` of any tensor an operator of the call reads or
writes, and of the call's arguments and result: the largest tensor of one
eager run, where the reference's number is the largest aval of every path
the trace holds.  The bound a test or benchmark asserts is the same
(``max_aval_elements(mvm_fn, x, key) << m * n``).

What the mode sees: every operator that goes through PyTorch's dispatcher,
on any device, factory functions included.  A hand-written kernel reached
through its ``ctypes`` launcher is not an operator: the launcher's
``torch.empty`` outputs are seen, but the kernel reads its inputs through
``data_ptr()``, which the mode does not see (they were seen where an
operator made them).  A view counts as the tensor it is (a block slice of a
resident image reports the block), but the operator that takes the view
reads the whole image, so a resident image shows at its own size, as the
reference's resident bound expects.

:func:`peak_bytes` is how the card shows what the reference proves
statically: the caching allocator's peak over one call above its start.

The reference's ``jaxpr_max_elements`` (its jaxpr walker, shared with the
invariant passes of ``repro.analysis.verify``) has no counterpart: there is
no jaxpr to walk.  Its role goes to
:func:`repro_torch.analysis.verify.aval_bound`, whose report's
``max_elements`` is :func:`max_aval_elements`' number for the same run,
with the largest tensor, its operator and its line.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["max_aval_elements", "peak_bytes"]


#: the site :meth:`_LargestTensor.finish` names: a call's arguments and
#: result, which no operator of the call need have read or written
ARGUMENTS = "<arguments and result>"


def _largest(tree) -> int:
    """Largest ``numel`` of the tensors in nested lists, tuples and dicts (0
    if none).  Called on every operator, so it walks the structure itself:
    ``torch.utils._pytree`` costs half again the mode's own overhead."""
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    if isinstance(tree, (list, tuple)):
        return max(map(_largest, tree), default=0)
    if isinstance(tree, dict):
        return max(map(_largest, tree.values()), default=0)
    return 0


def _tensors(tree, out: list) -> list:
    """The tensors of nested lists, tuples and dicts, appended to ``out``."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            _tensors(item, out)
    elif isinstance(tree, dict):
        for item in tree.values():
            _tensors(item, out)
    return out


def _describe(t: torch.Tensor) -> str:
    dtype = str(t.dtype).replace("torch.", "")
    return f"{dtype}[{','.join(map(str, t.shape))}]"


class _LargestTensor(TorchDispatchMode):
    """Records the largest tensor any dispatched operator reads or writes,
    and, only when a new maximum is seen, that tensor (``largest``) and
    where it was (``site``: the operator's name; a subclass may say more
    by overriding :meth:`_site`).  :meth:`observe` is the per-operator
    hook a subclass extends; :meth:`finish` adds the call's arguments and
    result."""

    def __init__(self):
        super().__init__()
        self.elements = 0
        self.largest = "?"
        self.site: Any = None

    def _site(self, op: str) -> Any:
        return op

    def see(self, tree, op) -> None:
        n = _largest(tree)
        if n > self.elements:
            t = max(_tensors(tree, []), key=lambda v: v.numel())
            self.elements, self.largest = n, _describe(t)
            self.site = self._site(str(op))

    def observe(self, func, args, kwargs, out) -> None:
        self.see((args, kwargs, out), func)

    def finish(self, args, kwargs, out) -> None:
        self.see((args, kwargs, out), ARGUMENTS)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.observe(func, args, kwargs, out)
        return out


def max_aval_elements(fn, *args: Any, **kwargs: Any) -> int:
    """Largest tensor (in elements) that one run of ``fn(*args, **kwargs)``
    reads or writes, its arguments and result included.  The call runs
    once, as it would without the measurement."""
    with _LargestTensor() as mode:
        out = fn(*args, **kwargs)
    mode.finish(args, kwargs, out)
    return mode.elements


def peak_bytes(fn, *args: Any, **kwargs: Any) -> int:
    """The caching allocator's peak over one run of ``fn(*args, **kwargs)``
    above what was allocated at its start, in bytes, on the CUDA device of
    the call's tensor arguments; raises ``ValueError`` for a call with no
    CUDA tensor argument.  It resets the device's peak statistics, so it
    must not run inside another such window."""
    devs = {t.device for t in _tensors((args, kwargs), []) if t.is_cuda}
    if len(devs) != 1:
        raise ValueError(
            "peak_bytes measures a call on one CUDA device; its tensor "
            f"arguments are on {sorted(map(str, devs)) or 'no CUDA device'}")
    dev = devs.pop()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.memory_allocated(dev)
    fn(*args, **kwargs)
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev) - start
