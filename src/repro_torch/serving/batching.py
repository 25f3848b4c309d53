"""Continuous-batching request queue: pack compatible requests, pad to
buckets (port of :mod:`repro.serving.batching`).

The engine executes one programmed image at a time, so a batch must share a
(tenant, arch) pair; within that, requests are packed up to ``max_batch`` and
padded along three axes to keep the set of executed shapes small:

  * **prompt** -- requests are grouped by prompt bucket (smallest power-of-two
    style bucket >= prompt_len) and the synthetic prompt is materialized at
    bucket length, so prefill shapes come from a fixed small set;
  * **decode** -- the batch decodes to the bucket of its LONGEST member's
    decode_len (shorter members' tails are padding work);
  * **batch** -- the packed group is padded up to the smallest batch bucket
    by repeating the last row.

Padding is never hidden: padded rows/steps execute (and are billed energy by
the cost model) but contribute zero useful tokens, so over-padding shows up
directly in joules-per-token.

Scheduling is head-of-line FIFO: ``form_batch`` always serves the OLDEST
waiting request, packing only requests compatible with it.  That gives a
simple no-starvation bound -- a request's wait is at most the service time of
the batches ahead of it in arrival order, never a function of its tenant's
popularity (the packing-invariant test asserts an explicit deadline bound on
a skewed trace).

The KV-cache layout constrains the design: ``cache["len"]`` is one scalar
shared by the whole batch (see DESIGN.md section 9), so sequences cannot join
mid-flight at per-token granularity.  Batching is therefore *group-level*
continuous batching -- new batches form whenever the engine goes idle, but a
running batch's membership is fixed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from .traffic import Request

__all__ = ["BatchingConfig", "Batch", "RequestQueue", "bucket_for"]


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (buckets must be sorted ascending)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds largest bucket {buckets[-1]}")


@dataclasses.dataclass(frozen=True)
class BatchingConfig:
    max_batch: int = 4
    prompt_buckets: Tuple[int, ...] = (8, 16, 32, 64)
    decode_buckets: Tuple[int, ...] = (4, 8, 16, 32)
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8)

    def __post_init__(self):
        for name in ("prompt_buckets", "decode_buckets", "batch_buckets"):
            b = getattr(self, name)
            if tuple(sorted(b)) != tuple(b):
                raise ValueError(f"{name} must be sorted ascending: {b}")
        if self.max_batch > self.batch_buckets[-1]:
            raise ValueError("max_batch exceeds largest batch bucket")


@dataclasses.dataclass(frozen=True)
class Batch:
    """One packed execution: requests + the padded shapes it will run at."""

    requests: Tuple[Request, ...]
    tenant: str
    arch: str
    prompt_bucket: int      # all members share this prompt bucket
    decode_bucket: int      # bucket of the longest member decode_len
    batch_pad: int          # padded batch size actually executed

    @property
    def size(self) -> int:
        return len(self.requests)

    @property
    def useful_prompt_tokens(self) -> int:
        return sum(r.prompt_len for r in self.requests)

    @property
    def useful_decode_tokens(self) -> int:
        return sum(r.decode_len for r in self.requests)

    @property
    def padded_prompt_tokens(self) -> int:
        return self.batch_pad * self.prompt_bucket

    @property
    def padded_decode_tokens(self) -> int:
        return self.batch_pad * self.decode_bucket


class RequestQueue:
    """FIFO admission + head-of-line compatible packing."""

    def __init__(self, cfg: BatchingConfig):
        self.cfg = cfg
        self._waiting: List[Request] = []

    def add(self, req: Request) -> None:
        self._waiting.append(req)

    def __len__(self) -> int:
        return len(self._waiting)

    @property
    def waiting(self) -> Tuple[Request, ...]:
        return tuple(self._waiting)

    def next_arrival(self, now: float) -> Optional[float]:
        """Earliest arrival time strictly after ``now`` among queued
        requests (the simulator advances its clock here when idle)."""
        future = [r.arrival_s for r in self._waiting if r.arrival_s > now]
        return min(future) if future else None

    def form_batch(self, now: float) -> Optional[Batch]:
        """Pack a batch around the oldest arrived request, or None if no
        request has arrived by ``now``."""
        arrived = [r for r in self._waiting if r.arrival_s <= now]
        if not arrived:
            return None
        arrived.sort(key=lambda r: (r.arrival_s, r.rid))
        head = arrived[0]
        head_bucket = bucket_for(head.prompt_len, self.cfg.prompt_buckets)
        picked = [head]
        for r in arrived[1:]:
            if len(picked) >= self.cfg.max_batch:
                break
            if (r.tenant == head.tenant and r.arch == head.arch
                    and bucket_for(r.prompt_len, self.cfg.prompt_buckets)
                    == head_bucket):
                picked.append(r)
        for r in picked:
            self._waiting.remove(r)
        decode_bucket = bucket_for(max(r.decode_len for r in picked),
                                   self.cfg.decode_buckets)
        batch_pad = bucket_for(len(picked), self.cfg.batch_buckets)
        return Batch(requests=tuple(picked), tenant=head.tenant,
                     arch=head.arch, prompt_bucket=head_bucket,
                     decode_bucket=decode_bucket, batch_pad=batch_pad)
