"""repro_torch.serving -- analog LM serving under synthetic traffic (port of
:mod:`repro.serving`).

The paper's "LLM/generative-AI" claim made measurable: a multi-tenant serving
stack over the program-once analog engine.  ``traffic`` draws deterministic
request traces (Poisson arrivals, Zipf tenant skew); ``cache`` keeps
programmed images under a capacity budget with write-cost-aware eviction (the
``SolveLedger`` one-time-write vs per-MVM split as the eviction signal);
``batching`` packs compatible requests at padded bucket shapes; ``metrics``
accounts tokens/sec, tail latency, and joules-per-token on the simulated
clock; ``simulator`` ties them into one deterministic event loop driving real
``Server`` prefill + decode, on the card unless told ``device="cpu"``.  See
docs/serving.md.  Imports ``torch`` and ``numpy`` only.
"""
from .batching import Batch, BatchingConfig, RequestQueue, bucket_for
from .cache import CacheEntry, CacheOutcome, CacheOverBudgetError, \
    ImageCache, POLICIES
from .metrics import DIGITAL_FLOPS_PER_S, DIGITAL_J_PER_FLOP, \
    MetricsAccumulator, RequestRecord, digital_cost, percentile
from .simulator import ReliabilityConfig, ServingConfig, SimResult, simulate
from .traffic import Request, TenantSpec, TrafficConfig, generate_trace, \
    zipf_weights

__all__ = [
    "Batch", "BatchingConfig", "RequestQueue", "bucket_for",
    "CacheEntry", "CacheOutcome", "CacheOverBudgetError", "ImageCache",
    "POLICIES",
    "DIGITAL_FLOPS_PER_S", "DIGITAL_J_PER_FLOP", "MetricsAccumulator",
    "RequestRecord", "digital_cost", "percentile",
    "ReliabilityConfig", "ServingConfig", "SimResult", "simulate",
    "Request", "TenantSpec", "TrafficConfig", "generate_trace",
    "zipf_weights",
]
