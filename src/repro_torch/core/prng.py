"""Key schedule of the port: integer keys, explicit ``torch.Generator`` draws.

``jax.random`` threads immutable keys through ``split`` / ``fold_in``; the
port keeps the same shape of schedule with plain 63-bit integer keys and a
splitmix64 ``fold_in``, and every draw goes through a ``torch.Generator``
seeded from the key it belongs to (:func:`generator`).  The schedule:

  * programming: block (I, J) encodes with ``fold_in(block_key(key, I, J), 0)``
    where ``block_key(key, I, J) = fold_in(fold_in(key, I), J)`` -- a function
    of the global block index only, never of the grid size or placement;
  * execution, reference backend: block (I, J)'s DAC pass draws with
    ``fold_in(block_key(call_key, I, J), 1)``;
  * execution, ``cuda`` backend: one whole-vector DAC pass with
    ``fold_in(call_key, 1)``;
  * call ``c`` of a handle uses ``call_key = key`` for ``c == 0``, else
    ``fold_in(key, c)``;
  * solvers: MVM ``i`` of a solve uses ``fold_in(key, i)`` as its call key.

The numbers differ from ``jax.random``'s; tests that need identical noise
draw it with ``jax.random`` and hand it to the port as ``eta=``.

Every draw of the port goes through :func:`generator`, so it is where the
key audit of :mod:`repro_torch.analysis.verify` observes them: while
:data:`OBSERVERS` is not empty, each call hands every observer the key.
Idle, the hook is one list test.
"""
from __future__ import annotations

from typing import Callable, List

import torch

__all__ = ["fold_in", "block_key", "generator", "OBSERVERS"]

#: ``observer(key)`` for every :func:`generator` call while an audit runs.
OBSERVERS: List[Callable] = []

_MASK64 = (1 << 64) - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and the integer ``data`` (63 bits)."""
    return _splitmix64(_splitmix64(int(key) & _MASK64) ^ (int(data) & _MASK64)) >> 1


def block_key(key: int, i: int, j: int) -> int:
    """The key of capacity block (i, j): global block index only."""
    return fold_in(fold_in(key, i), j)


def generator(key: int, device) -> torch.Generator:
    """A fresh ``torch.Generator`` on ``device`` seeded from ``key``."""
    for observe in OBSERVERS:
        observe(int(key))
    return torch.Generator(device=device).manual_seed(int(key))
