"""Serving of the port (of :mod:`repro.train.serve`): prefill + greedy
decode, digital or on the RRAM analog backend (weights programmed once at
server construction; every linear layer then runs the two-tier-EC analog
product, which pays only the input-DAC cost a token).

Prefill and decode run under ``torch.no_grad()``.  The decode steps run
as an eager host loop, one :func:`decode_step` a token, keyed as the
reference's fused decode scan keys them: prefill runs under ``fold_in(base,
0)`` and decode step ``t`` under ``fold_in(base, t + 1)``, with ``base`` the
runtime key, or ``fold_in(key, 1)`` when the runtime has none.

A :class:`Server` built with already programmed params (``w_tilde`` /
``dw`` present) skips ``program_rram``, so a cache hit pays no write cost.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core.prng import fold_in
from ..engine import AnalogEngine
from ..models.common import Runtime
from ..models.rram import crossbar_cfg, is_programmed, program_rram, \
    programming_dispatch_plan

__all__ = ["Server", "greedy_generate"]


def _device_of(params) -> torch.device:
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


@dataclasses.dataclass
class Server:
    """One deployed model instance: programmed weights + step functions.

    ``key`` seeds both the one-time analog programming draws and, when the
    runtime has no key, the DAC noise schedule.  ``engine`` /
    ``write_stats`` may be supplied by a cache along with pre-programmed
    ``params``; programming runs here only when the params are not yet
    programmed (``program_dispatches`` is then the grouped walk's bucket
    count, else 0).
    """

    mod: Any
    cfg: ModelConfig
    params: Any
    rt: Optional[Runtime] = None
    max_len: int = 512
    write_stats: Any = None     # one-time analog programming cost
    engine: Optional[AnalogEngine] = None   # the programming engine
    key: Optional[int] = None               # programming + DAC noise key

    def __post_init__(self):
        self.rt = self.rt or Runtime()
        if self.key is None:
            self.key = 7
        self.program_dispatches = 0
        if self.rt.rram is not None and self.rt.rram.enabled:
            self.engine = self.engine or AnalogEngine(
                crossbar_cfg(self.rt.rram), device=_device_of(self.params))
            if not is_programmed(self.params):
                self.params, self.write_stats = program_rram(
                    self.params, self.rt.rram, self.key, engine=self.engine)
                self.program_dispatches = \
                    programming_dispatch_plan(self.params)["groups"]

    def _rt_for(self, key: int) -> Runtime:
        """A fresh Runtime carrying ``key``."""
        return dataclasses.replace(self.rt, key=key, _salt=0)

    def _noise_base(self) -> int:
        """Runtime DAC-noise base key (distinct from the programming draws
        taken off ``self.key`` by ``program_rram``)."""
        if self.rt.key is not None:
            return self.rt.key
        return fold_in(self.key, 1)

    @torch.no_grad()
    def prefill(self, batch: Dict) -> Tuple[torch.Tensor, Any]:
        """(first greedy token (B, 1) int32, filled caches)."""
        rt = self._rt_for(fold_in(self._noise_base(), 0))
        logits, caches = self.mod.prefill(self.params, batch, self.cfg, rt,
                                          self.max_len)
        tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
        return tok, caches

    @torch.no_grad()
    def decode_tokens(self, tok: torch.Tensor, caches: Any,
                      n: int) -> Tuple[torch.Tensor, Any]:
        """Greedy-decode ``n`` tokens after ``tok``: ((B, n) int32, caches);
        step ``t`` runs under ``fold_in(base, t + 1)``."""
        base = self._noise_base()
        toks = []
        for t in range(n):
            logits, caches = self.mod.decode_step(
                self.params, tok, caches, self.cfg,
                self._rt_for(fold_in(base, t + 1)))
            tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
            toks.append(tok)
        return torch.cat(toks, dim=1), caches

    def decode_fn(self, n: int):
        """The ``n``-token decode as a ``(tok, caches) -> ((B, n) int32,
        caches)`` callable over this server's params.  The reference's is
        one fused scan; this one is :meth:`decode_tokens`' host loop, one
        ``decode_step`` a token, and it writes ``caches`` in place."""
        return lambda tok, caches: self.decode_tokens(tok, caches, n)

    def dispatches_per_batch(self, n_tokens: int) -> int:
        """Step calls one ``generate(batch, n_tokens)`` makes: a prefill and
        ``n_tokens - 1`` calls to ``decode_step``.  The reference counts 1
        or 2 (its decode is one fused scan); this decode is a host loop."""
        return n_tokens

    def generate(self, batch: Dict, n_tokens: int) -> torch.Tensor:
        """Greedy continuation of ``batch['tokens']`` (B, T) -> (B,
        n_tokens) int32."""
        tok, caches = self.prefill(batch)
        if n_tokens == 1:
            return tok
        toks, _ = self.decode_tokens(tok, caches, n_tokens - 1)
        return torch.cat([tok, toks], dim=1)


def greedy_generate(mod, params, cfg: ModelConfig, batch: Dict,
                    n_tokens: int, rt: Optional[Runtime] = None,
                    max_len: int = 512) -> torch.Tensor:
    return Server(mod, cfg, params, rt=rt, max_len=max_len).generate(
        batch, n_tokens)
