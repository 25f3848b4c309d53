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
invariant passes of ``repro.analysis.verify``) has no counterpart here; the
audits decide what replaces it.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["max_aval_elements", "peak_bytes"]


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


class _LargestTensor(TorchDispatchMode):
    """Records the largest tensor any dispatched operator reads or writes."""

    def __init__(self):
        super().__init__()
        self.elements = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.elements = max(self.elements, _largest(args), _largest(kwargs),
                            _largest(out))
        return out


def max_aval_elements(fn, *args: Any, **kwargs: Any) -> int:
    """Largest tensor (in elements) that one run of ``fn(*args, **kwargs)``
    reads or writes, its arguments and result included.  The call runs
    once, as it would without the measurement."""
    with _LargestTensor() as mode:
        out = fn(*args, **kwargs)
    return max(mode.elements, _largest((args, kwargs, out)))


def peak_bytes(fn, *args: Any, **kwargs: Any) -> int:
    """The caching allocator's peak over one run of ``fn(*args, **kwargs)``
    above what was allocated at its start, in bytes, on the CUDA device of
    the call's tensor arguments; raises ``ValueError`` for a call with no
    CUDA tensor argument.  It resets the device's peak statistics, so it
    must not run inside another such window."""
    devs = {t.device for t in pytree.tree_leaves((args, kwargs))
            if isinstance(t, torch.Tensor) and t.is_cuda}
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
