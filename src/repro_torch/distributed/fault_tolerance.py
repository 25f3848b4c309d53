"""Fault tolerance: asynchronous atomic checkpoints, preemption handling and
a straggler watchdog (port of :mod:`repro.distributed.fault_tolerance`).

Checkpoint layout (one directory per step, atomically renamed into place):

    <dir>/step_000000120/
        manifest.json        # step, leaf paths/shapes/dtypes, extra, time
        arrays.npz           # one entry per tree leaf (path-keyed)

A tree is a nested dict / list / tuple (namedtuples and dataclasses too)
of tensors, numpy arrays or scalars; ``None`` holds no leaf.  Leaves are
keyed by their path in JAX's ``keystr`` form (``['x']``, ``[0]``,
``.mvms``) and dict keys are visited sorted, as JAX's pytrees visit them,
so a checkpoint written by either package restores in the other.
:meth:`CheckpointManager.restore` rebuilds a template tree and puts each
leaf on its template tensor's device and dtype, or, given ``shardings``,
on the device of the sharding's mesh (the reference's elastic restore).
Saves snapshot the leaves to host memory synchronously and write them on a
background thread; ``wait()`` joins it.  A SIGTERM handler sets
:data:`PREEMPTED` so a loop can checkpoint and exit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .sharding import check_sharding

__all__ = ["CheckpointManager", "Watchdog", "install_preemption_handler",
           "PREEMPTED"]

PREEMPTED = threading.Event()


def install_preemption_handler() -> None:
    """SIGTERM -> graceful checkpoint-and-exit flag (cluster preemption)."""
    def handler(signum, frame):
        PREEMPTED.set()
    try:
        signal.signal(signal.SIGTERM, handler)
    except ValueError:
        pass  # not in the main thread (tests)


def _children(tree):
    """``(key suffix, child)`` pairs of an inner node in JAX's pytree order,
    or None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):    # namedtuple
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def _leaves(tree, path: str = ""):
    """``(keystr path, leaf)`` of every leaf of ``tree``, in order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    return [leaf for k, v in kids for leaf in _leaves(v, path + k)]


def _rebuild(tree, fn, path: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], fn, f"{path}[{k!r}]") for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), fn, f"{path}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, fn, f"{path}[{i}]") for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else type(tree)(out)
    return dataclasses.replace(tree, **{
        f.name: _rebuild(getattr(tree, f.name), fn, f"{path}.{f.name}")
        for f in dataclasses.fields(tree) if f.init})


def _host(leaf) -> np.ndarray:
    """A host copy of a leaf (a copy even for a CPU tensor, which a later
    in-place update would otherwise change under the writer)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {k: _host(v) for k, v in _leaves(tree)}


class CheckpointManager:
    """Step-numbered checkpoints in ``directory``, the newest ``keep_n``
    kept."""

    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, blocking: bool = False,
             extra: Optional[Dict] = None) -> None:
        """Snapshot ``tree`` now and write it as step ``step`` (on a
        background thread unless ``blocking``); ``extra`` goes into the
        manifest."""
        self.wait()
        arrays = _flatten(tree)          # snapshot now (synchronous copy)
        manifest = {
            "step": int(step),
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in arrays.items()},
            "extra": extra or {},
            "devices": max(1, torch.cuda.device_count()),
            "time": time.time(),
        }

        def write():
            tmp = os.path.join(self.dir, f".tmp_step_{step:09d}")
            final = os.path.join(self.dir, f"step_{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)        # atomic publish
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the background writer, if one runs."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: Optional[int]) -> str:
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return os.path.join(self.dir, f"step_{step:09d}")

    def manifest(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The manifest.json of ``step`` (default: latest): step number,
        leaf shapes/dtypes, the ``extra`` dict passed at save time, device
        count and wall time."""
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f)

    def restore(self, target_tree: Any, step: Optional[int] = None,
                shardings: Any = None) -> Any:
        """Rebuild ``target_tree``-structured state from step ``step``
        (default: latest).  A tensor leaf comes back on its template's
        device and dtype; any other leaf as a numpy array of its
        template's dtype.  ``shardings`` (the target tree's structure, a
        :class:`~repro_torch.distributed.sharding.NamedSharding` a leaf)
        retargets any mesh, the reference's elastic restore: each leaf is
        checked against its sharding and comes back whole on the mesh's
        device (the ranks of a port mesh share it), whatever mesh saved
        it."""
        placed = {} if shardings is None else dict(_leaves(shardings))
        path = os.path.join(self._step_dir(step), "arrays.npz")
        with np.load(path) as data:
            def load(key, leaf):
                arr = data[key]
                sh = placed.get(key)
                if not isinstance(leaf, torch.Tensor):
                    arr = arr.astype(np.asarray(leaf).dtype)
                    if sh is None:
                        return arr
                t = torch.from_numpy(np.array(arr))
                if isinstance(leaf, torch.Tensor):
                    t = t.to(dtype=leaf.dtype)
                if sh is None:
                    return t.to(leaf.device)
                check_sharding(arr.shape, sh)
                return t.to(sh.mesh.lead_device)
            return _rebuild(target_tree, load)


@dataclasses.dataclass
class Watchdog:
    """Step-time straggler detector: flags steps slower than ``threshold``
    x the running median and calls ``on_straggler`` after ``patience``
    consecutive slow steps."""

    threshold: float = 2.5
    patience: int = 3
    on_straggler: Optional[Callable[[int], None]] = None
    _times: List[float] = dataclasses.field(default_factory=list)
    _slow: int = 0
    events: List[int] = dataclasses.field(default_factory=list)

    def record(self, step: int, seconds: float) -> bool:
        self._times.append(seconds)
        hist = sorted(self._times[-50:])
        med = hist[len(hist) // 2]
        if len(self._times) >= 5 and seconds > self.threshold * med:
            self._slow += 1
            self.events.append(step)
            if self._slow >= self.patience and self.on_straggler:
                self.on_straggler(step)
                self._slow = 0
            return True
        self._slow = 0
        return False
