"""Data of the port: the deterministic synthetic LM pipeline
(:mod:`.pipeline`)."""
from .pipeline import Prefetcher, batches, synthetic_batch

__all__ = ["synthetic_batch", "Prefetcher", "batches"]
