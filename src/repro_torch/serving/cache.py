"""Multi-tenant image cache with write-cost-aware eviction (port of
:mod:`repro.serving.cache`).

An analog deployment's defining asymmetry (the ``SolveLedger`` split in
``solvers/base.py``): programming a conductance image is expensive -- the
full write-verify :class:`~repro_torch.core.write_verify.WriteStats`
energy -- but *executing* against a resident image costs only the per-MVM
input-DAC write.
A multi-tenant server with more programmed images than crossbar capacity must
therefore choose victims by what it will cost to bring them BACK, not just by
when they were last touched.

Three policies, selected by name:

  * ``"lru"``     -- classic: evict the least-recently-used entry.
  * ``"never"``   -- admission beyond capacity raises
    :class:`CacheOverBudgetError` (models a deployment with no eviction:
    useful as the OOM control in tests).
  * ``"write_cost"`` -- the headline policy: each entry's keep-priority is
    ``reprogram_energy_j * recent_hit_rate`` (an exponentially-decayed
    hits-per-second estimate), i.e. the expected write energy per second
    saved by keeping the image resident.  Evict the minimum.  A big, hot
    image survives a burst of small cold tenants that would flush it under
    LRU -- that difference is exactly the benchmark's total-write-energy gap.
    The priority is ranked as the reference ranks it: the product of the
    float32 energy and the hit rate, rounded to float32
    (:func:`keep_priority`), so that near-ties collapse to the same exact
    ties, broken by recency and then key.

The cache is value-agnostic: entries are built by a caller-supplied thunk
returning ``(value, size_bytes, write_stats)``, so the same class caches
programmed param trees (sized by ``models.rram.analog_image_bytes``) or
other programmed handles.  An evicted value is dropped from the cache (after
``release_hook``, when given): its tensors are freed once nothing else holds
them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import numpy as np

from ..core.write_verify import WriteStats

__all__ = ["ImageCache", "CacheEntry", "CacheOutcome", "CacheOverBudgetError",
           "POLICIES"]

POLICIES = ("lru", "never", "write_cost")


def keep_priority(energy_j: float, hit_rate: float) -> float:
    """``write_cost``'s keep-priority, ``energy_j * hit_rate``, as the
    reference computes it: its write energies are float32 scalars and the
    rate a Python float cast to float32, so the product is rounded to
    float32 (a float64 product would split ties that the reference sees)."""
    return float(np.float32(np.float32(energy_j) * np.float32(hit_rate)))


class CacheOverBudgetError(RuntimeError):
    """Raised when admission would exceed capacity and the policy forbids
    eviction (``"never"``), or when a single entry exceeds total capacity."""


@dataclasses.dataclass
class CacheEntry:
    key: Hashable
    value: Any
    size_bytes: int
    write_stats: WriteStats          # cost of the build that produced value
    created_s: float
    last_used_s: float
    hits: int = 0
    _rate: float = 0.0               # decayed hit counter (see hit_rate)
    _rate_t: float = 0.0

    def hit_rate(self, now: float, tau_s: float) -> float:
        """Exponentially-decayed hits-per-second, horizon ``tau_s``."""
        return self._decayed(now, tau_s) / tau_s

    def _decayed(self, now: float, tau_s: float) -> float:
        dt = max(0.0, now - self._rate_t)
        return self._rate * math.exp(-dt / tau_s)

    def touch(self, now: float, tau_s: float) -> None:
        self._rate = self._decayed(now, tau_s) + 1.0
        self._rate_t = now
        self.last_used_s = now
        self.hits += 1


@dataclasses.dataclass(frozen=True)
class CacheOutcome:
    """What one ``get`` did: hit or (re)build, and who got evicted for it."""

    hit: bool
    reprogrammed: bool               # a miss on a key that was resident before
    write_stats: WriteStats          # build cost charged by THIS get (zero on hit)
    evicted: Tuple[Hashable, ...] = ()


class ImageCache:
    """Capacity-budgeted cache of programmed analog images.

    ``get(key, build, now)`` returns ``(value, outcome)``; ``build`` runs only
    on a miss and must return ``(value, size_bytes, write_stats)``.  Evictions
    call ``release_hook(key, value)`` when provided.  All state the policies
    read (recency, decayed hit rates) advances on the caller's simulated
    clock, so a fixed trace produces a fixed eviction sequence."""

    def __init__(self, capacity_bytes: int, policy: str = "write_cost",
                 *, tau_s: float = 30.0,
                 release_hook: Optional[Callable[[Hashable, Any], None]] = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; known: {POLICIES}")
        self.capacity_bytes = int(capacity_bytes)
        self.policy = policy
        self.tau_s = float(tau_s)
        self.release_hook = release_hook
        self.entries: Dict[Hashable, CacheEntry] = {}
        self._ever_built: set = set()
        # aggregate counters, read by metrics/benchmarks
        self.hits = 0
        self.misses = 0
        self.reprograms = 0          # builds beyond the first, per key
        self.evictions = 0
        self.refreshes = 0           # in-place tile refreshes of resident entries
        self.write_energy_j = 0.0    # total build (programming) energy
        self.write_latency_s = 0.0

    @property
    def used_bytes(self) -> int:
        return sum(e.size_bytes for e in self.entries.values())

    def get(self, key: Hashable, build: Callable[[], Tuple[Any, int, WriteStats]],
            now: float) -> Tuple[Any, CacheOutcome]:
        entry = self.entries.get(key)
        if entry is not None:
            entry.touch(now, self.tau_s)
            self.hits += 1
            return entry.value, CacheOutcome(
                hit=True, reprogrammed=False, write_stats=WriteStats.zero())

        self.misses += 1
        reprogrammed = key in self._ever_built
        if reprogrammed:
            self.reprograms += 1
        self._ever_built.add(key)
        value, size_bytes, stats = build()
        self.write_energy_j += float(stats.energy_j)
        self.write_latency_s += float(stats.latency_s)

        if size_bytes > self.capacity_bytes:
            raise CacheOverBudgetError(
                f"entry {key!r} ({size_bytes} B) exceeds cache capacity "
                f"({self.capacity_bytes} B)")
        evicted = self._make_room(size_bytes, now)
        entry = CacheEntry(key=key, value=value, size_bytes=size_bytes,
                           write_stats=stats, created_s=now, last_used_s=now)
        entry.touch(now, self.tau_s)
        self.entries[key] = entry
        return value, CacheOutcome(hit=False, reprogrammed=reprogrammed,
                                   write_stats=stats, evicted=tuple(evicted))

    def _make_room(self, need_bytes: int, now: float) -> List[Hashable]:
        evicted: List[Hashable] = []
        while self.used_bytes + need_bytes > self.capacity_bytes:
            if self.policy == "never":
                raise CacheOverBudgetError(
                    f"cache over budget ({self.used_bytes + need_bytes} B > "
                    f"{self.capacity_bytes} B) and policy is 'never'")
            victim = self._pick_victim(now)
            self._evict(victim)
            evicted.append(victim)
        return evicted

    def _pick_victim(self, now: float) -> Hashable:
        if self.policy == "lru":
            return min(self.entries.values(),
                       key=lambda e: (e.last_used_s, str(e.key))).key
        # write_cost: keep-priority = expected reprogram energy saved per
        # second; ties broken by recency then key for determinism.
        return min(self.entries.values(),
                   key=lambda e: (keep_priority(e.write_stats.energy_j,
                                                e.hit_rate(now, self.tau_s)),
                                  e.last_used_s, str(e.key))).key

    def _evict(self, key: Hashable) -> None:
        entry = self.entries.pop(key)
        self.evictions += 1
        if self.release_hook is not None:
            self.release_hook(key, entry.value)

    def note_refresh(self, key: Hashable, stats: WriteStats) -> None:
        """Bill an in-place tile refresh of a resident entry.

        The entry stays resident (no eviction, no rebuild, no hit-rate
        bump); only the programming ledger moves -- refresh writes are
        real write-verify energy and latency, just amortized to a tile
        subset instead of the full image."""
        if key not in self.entries:
            raise KeyError(f"cannot refresh non-resident entry {key!r}")
        self.refreshes += 1
        self.write_energy_j += float(stats.energy_j)
        self.write_latency_s += float(stats.latency_s)

    def stats(self) -> Dict[str, Any]:
        return {"policy": self.policy, "capacity_bytes": self.capacity_bytes,
                "used_bytes": self.used_bytes, "entries": len(self.entries),
                "hits": self.hits, "misses": self.misses,
                "reprograms": self.reprograms, "evictions": self.evictions,
                "refreshes": self.refreshes,
                "write_energy_j": self.write_energy_j,
                "write_latency_s": self.write_latency_s}
