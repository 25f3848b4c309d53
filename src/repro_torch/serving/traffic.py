"""Seeded synthetic traffic: deterministic request traces for the serving
simulator (port of :mod:`repro.serving.traffic`).

A trace is a list of :class:`Request` drawn from three independent processes:

  * **arrivals** -- Poisson at ``rate_rps`` (exponential inter-arrival gaps);
  * **tenant popularity** -- Zipf over the tenant list (rank ``k`` gets mass
    ``(k+1)^-zipf_s``), so a skewed ``zipf_s`` concentrates traffic on a few
    hot images -- the regime where write-cost-aware eviction matters;
  * **lengths** -- prompt/decode lengths drawn from small categorical mixes
    (chat-style short prompts next to document-style long ones).

All randomness comes from one ``numpy.random.Generator(PCG64(seed))``, so the
trace is bit-identical across runs and platforms: same seed -> same requests
in the same order with the same lengths and arrival times (the replay test
asserts this end to end through the simulator).  No tensors here -- the
trace is host-side metadata, drawn as the reference draws it (gaps,
tenants, prompt lengths, decode lengths, token seeds, in that order), so
the two packages give the same trace field for field; token content is
synthesized later from ``Request.token_seed``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

__all__ = ["TenantSpec", "TrafficConfig", "Request", "generate_trace",
           "zipf_weights"]


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant: a name and the zoo model it serves.

    Tenants listed earlier get higher Zipf rank (more traffic).  Two tenants
    may share an ``arch`` -- they still program (and cache) separate analog
    images, under independent PRNG keys."""

    name: str
    arch: str


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Knobs of the synthetic trace (all defaults give a small, mixed load)."""

    n_requests: int = 64
    rate_rps: float = 4.0            # mean Poisson arrival rate, requests/s
    zipf_s: float = 1.1              # tenant popularity skew (0 = uniform)
    prompt_lens: Tuple[int, ...] = (8, 16, 32)
    prompt_mix: Tuple[float, ...] = (0.5, 0.3, 0.2)
    decode_lens: Tuple[int, ...] = (4, 8, 16)
    decode_mix: Tuple[float, ...] = (0.5, 0.3, 0.2)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class Request:
    """One inference request, fully determined at trace-generation time."""

    rid: int
    tenant: str
    arch: str
    arrival_s: float
    prompt_len: int
    decode_len: int
    token_seed: int      # seeds the synthetic prompt-token draw


def zipf_weights(n: int, s: float) -> np.ndarray:
    """Normalized Zipf mass over ``n`` ranks: ``p_k \\propto (k+1)^-s``."""
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-float(s))
    return w / w.sum()


def generate_trace(tenants: Sequence[TenantSpec],
                   cfg: TrafficConfig) -> Tuple[Request, ...]:
    """The deterministic trace: ``cfg.n_requests`` requests, arrival-sorted."""
    if not tenants:
        raise ValueError("need at least one tenant")
    rng = np.random.Generator(np.random.PCG64(cfg.seed))
    pops = zipf_weights(len(tenants), cfg.zipf_s)
    pmix = np.asarray(cfg.prompt_mix, dtype=np.float64)
    dmix = np.asarray(cfg.decode_mix, dtype=np.float64)
    pmix = pmix / pmix.sum()
    dmix = dmix / dmix.sum()

    gaps = rng.exponential(scale=1.0 / cfg.rate_rps, size=cfg.n_requests)
    arrivals = np.cumsum(gaps)
    tenant_idx = rng.choice(len(tenants), size=cfg.n_requests, p=pops)
    prompt_idx = rng.choice(len(cfg.prompt_lens), size=cfg.n_requests, p=pmix)
    decode_idx = rng.choice(len(cfg.decode_lens), size=cfg.n_requests, p=dmix)
    token_seeds = rng.integers(0, 2**31 - 1, size=cfg.n_requests)

    out = []
    for i in range(cfg.n_requests):
        t = tenants[int(tenant_idx[i])]
        out.append(Request(
            rid=i, tenant=t.name, arch=t.arch,
            arrival_s=float(arrivals[i]),
            prompt_len=int(cfg.prompt_lens[int(prompt_idx[i])]),
            decode_len=int(cfg.decode_lens[int(decode_idx[i])]),
            token_seed=int(token_seeds[i])))
    return tuple(out)
