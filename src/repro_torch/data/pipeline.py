"""Deterministic synthetic LM data and a prefetching thread (port of
:mod:`repro.data.pipeline`).

Batches are a pure function of (seed, step, arch): a restart replays the
same data.  They come from numpy's Philox stream keyed ``[seed, step]``,
the reference's, so both packages see the same tokens bit for bit.
Tokens follow a Zipf-flavoured unigram mix with a first-order structure,
so the loss has something to learn.  :class:`Prefetcher` synthesises the
next batches and moves them to a device on a background thread while the
current step runs.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator

import numpy as np
import torch

from ..configs.base import ModelConfig

__all__ = ["synthetic_batch", "Prefetcher", "batches"]


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, step: int,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.Generator(np.random.Philox(key=[seed, step]))
    v = cfg.vocab
    # Zipf unigram + first-order structure: next token correlated with prev.
    base = rng.zipf(1.3, size=(batch, seq)).astype(np.int64)
    tok = (base + np.cumsum(base, axis=1)) % (v - 2) + 1
    tokens = tok.astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((batch, 1), -1, np.int32)],
                            axis=1)
    out: Dict[str, Any] = {"tokens": tokens, "labels": labels}
    if cfg.family == "whisper":
        out["frames"] = rng.standard_normal((batch, seq, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "llama_vision":
        out["patches"] = rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def batches(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
            start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield synthetic_batch(cfg, batch, seq, step, seed)
        step += 1


class Prefetcher:
    """Background thread: synthesise the next batches (up to ``depth``
    ahead) and put each array on ``device`` as a tensor while the current
    step runs."""

    def __init__(self, it: Iterator, device, depth: int = 2):
        self.it = it
        self.device = torch.device(device)
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        for item in self.it:
            if self._stop.is_set():
                return
            item = {k: torch.from_numpy(np.asarray(a)).to(self.device)
                    for k, a in item.items()}
            self.q.put(item)

    def __next__(self):
        return self.q.get()

    def __iter__(self):
        return self

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
