"""Deterministic event-loop serving simulator: traffic -> cache -> batcher ->
prefill/decode (port of :mod:`repro.serving.simulator`).

One simulated analog engine serves a multi-tenant request trace.  The loop:

  1. if nothing has arrived, jump the clock to the next arrival;
  2. pack a batch around the oldest waiting request
     (:class:`~repro_torch.serving.batching.RequestQueue` -- head-of-line
     FIFO);
  3. acquire the tenant's programmed image from the
     :class:`~repro_torch.serving.cache.ImageCache` -- a miss runs
     ``program_rram`` under a fresh per-build key and stalls the engine for
     the write-verify latency;
  4. execute the batch through the REAL :class:`~repro_torch.train.serve.
     Server` numerics (a prefill, then one decode step a token, every analog
     linear layer through the EC kernels on the card) at the padded bucket
     shapes, while the analytic cost model
     (:func:`~repro_torch.models.rram.forward_input_stats` /
     :func:`~repro_torch.serving.metrics.digital_cost`) advances the
     simulated clock and energy ledgers;
  5. record each member's finish at its OWN last token (shorter members of a
     batch finish before the batch's padded decode completes).

Everything observable -- request order, eviction sequence, latencies, joules
-- is a pure function of the config; the replay test runs ``simulate`` twice
in one process and asserts identical records and summaries.  The clock and
the ledgers are host arithmetic on shapes, so they are the same on the card
and on the CPU, and equal the reference's up to the float32 sums the
reference bills its write costs in (~1e-7 relative).

Model execution can be disabled (``run_model=False``) for policy sweeps where
only the clock/energy trajectory matters; metrics are identical either way
because service costs are analytic (the numerics validate the pipeline and
return the actual greedy tokens).

``simulate`` runs on the card unless it is given ``device="cpu"``; without a
GPU it raises rather than run on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import RRAMBackendConfig
from ..configs.registry import get_arch, model_module
from ..core.devices import get_device
from ..core.prng import fold_in
from ..core.write_verify import WriteStats
from ..models import params as P
from ..models.common import Runtime
from ..models.rram import analog_image_bytes, forward_input_stats, \
    strip_rram
from ..reliability.aging import predicted_residual
from ..train.serve import Server

from .batching import Batch, BatchingConfig, RequestQueue
from .cache import ImageCache
from .metrics import MetricsAccumulator, RequestRecord, digital_cost
from .traffic import TenantSpec, TrafficConfig, generate_trace

__all__ = ["ReliabilityConfig", "ServingConfig", "SimResult", "simulate"]


@dataclasses.dataclass(frozen=True)
class ReliabilityConfig:
    """Online-refresh scheduling for long-lived serving deployments.

    Cached images age on the simulated clock (conductance drift) and with
    every token served (read-disturb faults).  Before serving a resident
    image the scheduler evaluates the analytic health proxy
    :func:`repro_torch.reliability.aging.predicted_residual` and refreshes
    in place when the AGING EXCESS -- ``sqrt(predicted^2 - fresh^2)``, the
    quadrature contribution of drift + stuck cells over the fresh
    programming floor -- exceeds ``refresh_threshold``.  Thresholding the
    excess (not the total) makes the knob device-independent and prevents
    a refresh storm when the threshold is set below a device's noise floor
    (refresh cannot go below the floor, so comparing the total would
    re-trigger on every batch forever).  A refresh stalls the engine for
    ``refresh_fraction`` of the tenant's full build latency and bills the
    same fraction of its write energy (the tile-selective amortization
    measured numerically in ``repro_torch.reliability.refresh``)."""

    refresh_threshold: float = 0.05
    refresh_fraction: float = 0.25   # tile-selective cost vs full reprogram


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """One serving scenario: who sends traffic, on what backend, under which
    cache policy.  ``rram=None`` is the digital fp32 baseline (no programming,
    no cache pressure -- weights live in DRAM)."""

    tenants: Tuple[TenantSpec, ...]
    traffic: TrafficConfig
    batching: BatchingConfig = BatchingConfig()
    rram: Optional[RRAMBackendConfig] = None
    cache_capacity_bytes: int = 1 << 30
    policy: str = "write_cost"
    seed: int = 0
    max_len: int = 128
    run_model: bool = True
    reliability: Optional[ReliabilityConfig] = None


@dataclasses.dataclass
class SimResult:
    summary: Dict[str, Any]
    records: Tuple[RequestRecord, ...]
    cache_stats: Optional[Dict[str, Any]]


def _digital_params(arch_name: str, seed: int, device: torch.device):
    """(cfg, mod, digital params, n_params) for one zoo arch, reduced."""
    cfg = get_arch(arch_name).reduced()
    mod = model_module(cfg)
    prm = P.materialize(mod.init_specs(cfg), seed, torch.float32, device)
    n_params = sum(t.numel() for _, t in P.tree_paths(prm)
                   if isinstance(t, torch.Tensor))
    return cfg, mod, prm, n_params


def _batch_inputs(batch: Batch, cfg,
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """Synthesize the padded model inputs for one batch, deterministically
    from each request's ``token_seed`` (pad rows repeat the last member):
    the reference's numpy rows, as int32 tokens on ``device``."""
    rows = []
    for r in batch.requests:
        rng = np.random.Generator(np.random.PCG64(r.token_seed))
        rows.append(rng.integers(0, cfg.vocab, size=batch.prompt_bucket))
    while len(rows) < batch.batch_pad:
        rows.append(rows[-1])
    out: Dict[str, torch.Tensor] = {"tokens": torch.as_tensor(
        np.stack(rows).astype(np.int32), device=device)}
    if cfg.family == "whisper":
        out["frames"] = _extra_feature(
            batch, (batch.prompt_bucket, cfg.d_model), device)
    elif cfg.family == "llama_vision":
        out["patches"] = _extra_feature(
            batch, (cfg.n_patches, cfg.d_model), device)
    return out


def _extra_feature(batch: Batch, shape: Tuple[int, ...],
                   device: torch.device) -> torch.Tensor:
    rows = []
    for r in batch.requests:
        rng = np.random.Generator(np.random.PCG64(r.token_seed + 1))
        rows.append(rng.standard_normal(size=shape) * 0.1)
    while len(rows) < batch.batch_pad:
        rows.append(rows[-1])
    return torch.as_tensor(np.stack(rows).astype(np.float32), device=device)


class _Fleet:
    """Per-tenant Server acquisition through the image cache.

    Digital weights are materialized ONCE per arch and shared by every tenant
    of that arch (``strip_rram`` shares the tensors); each (tenant, build)
    programs its own analog image under ``fold_in(fold_in(seed,
    tenant_index), build_count)`` -- independent device draws per tenant and
    per reprogram.  An evicted tenant's Server is held by nothing here, so
    its image is freed once the caller drops it."""

    def __init__(self, cfg: ServingConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        self._arch: Dict[str, Tuple[Any, Any, Any, int]] = {}
        self._builds: Dict[str, int] = {}
        self._tenant_ix = {t.name: i for i, t in enumerate(cfg.tenants)}
        self._tenant_arch = {t.name: t.arch for t in cfg.tenants}
        self._digital_servers: Dict[str, Server] = {}
        self.cache: Optional[ImageCache] = None
        if cfg.rram is not None:
            self.cache = ImageCache(cfg.cache_capacity_bytes, cfg.policy)
        # per-tenant age of the CURRENT resident image: (programmed-at
        # sim-time, tokens served since).  Reset on build and on refresh.
        self._age: Dict[str, Tuple[float, float]] = {}

    def note_programmed(self, tenant: str, now: float) -> None:
        self._age[tenant] = (now, 0.0)

    def note_served(self, tenant: str, tokens: int) -> None:
        t0, mvms = self._age.get(tenant, (0.0, 0.0))
        self._age[tenant] = (t0, mvms + float(tokens))

    def predicted(self, tenant: str, now: float) -> float:
        """Analytic health of the tenant's resident image at sim-time now."""
        rram = self.cfg.rram
        assert rram is not None
        t0, mvms = self._age.get(tenant, (now, 0.0))
        return predicted_residual(get_device(rram.device),
                                  k_iters=rram.k_iters,
                                  seconds=max(0.0, now - t0), mvms=mvms,
                                  n=rram.cell_rows)

    def aging_excess(self, tenant: str, now: float) -> float:
        """Drift + stuck-cell contribution over the fresh programming floor
        (quadrature residue) -- what a refresh can actually remove."""
        rram = self.cfg.rram
        assert rram is not None
        fresh = predicted_residual(get_device(rram.device),
                                   k_iters=rram.k_iters, seconds=0.0,
                                   mvms=0.0, n=rram.cell_rows)
        pred = self.predicted(tenant, now)
        return max(0.0, pred * pred - fresh * fresh) ** 0.5

    def refresh_stats(self, tenant: str, fraction: float) -> WriteStats:
        """Tile-selective refresh cost: ``fraction`` of the tenant's full
        build write-verify cost (energy AND latency scale with tiles)."""
        assert self.cache is not None
        full = self.cache.entries[tenant].write_stats
        return WriteStats(energy_j=full.energy_j * fraction,
                          latency_s=full.latency_s * fraction,
                          iterations=full.iterations,
                          final_delta=full.final_delta)

    def arch_state(self, arch: str):
        if arch not in self._arch:
            self._arch[arch] = _digital_params(arch, self.cfg.seed,
                                               self.device)
        return self._arch[arch]

    def n_params(self, arch: str) -> int:
        return self.arch_state(arch)[3]

    def acquire(self, tenant: str, now: float) -> Tuple[Server, Any]:
        """(server, cache outcome or None).  Analog: through the cache, a
        miss programs (stalling for write latency is the caller's job, via
        the outcome's write_stats)."""
        arch = self._tenant_arch[tenant]
        cfg, mod, prm, _ = self.arch_state(arch)
        if self.cache is None:
            srv = self._digital_servers.get(tenant)
            if srv is None:
                srv = Server(mod, cfg, prm, rt=Runtime(),
                             max_len=self.cfg.max_len, key=self.cfg.seed)
                self._digital_servers[tenant] = srv
            return srv, None

        def build():
            n = self._builds.get(tenant, 0)
            self._builds[tenant] = n + 1
            key = fold_in(fold_in(self.cfg.seed, self._tenant_ix[tenant]), n)
            srv = Server(mod, cfg, strip_rram(prm),
                         rt=Runtime(rram=self.cfg.rram),
                         max_len=self.cfg.max_len, key=key)
            return srv, analog_image_bytes(srv.params), srv.write_stats

        return self.cache.get(tenant, build, now)


def simulate(cfg: ServingConfig, *, device="cuda") -> SimResult:
    """Run the trace to completion; returns summary + per-request records.
    Weights, images and model inputs live on ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "simulate runs on the card: no CUDA device is available "
            "(torch.cuda.is_available() is False); pass device='cpu' to run "
            "it on the CPU")
    trace = generate_trace(cfg.tenants, cfg.traffic)
    queue = RequestQueue(cfg.batching)
    for r in trace:
        queue.add(r)
    fleet = _Fleet(cfg, dev)
    metrics = MetricsAccumulator()
    now = 0.0

    while len(queue):
        batch = queue.form_batch(now)
        if batch is None:
            nxt = queue.next_arrival(now)
            assert nxt is not None, "queue non-empty but nothing arriving"
            now = nxt
            continue

        server, outcome = fleet.acquire(batch.tenant, now)
        if outcome is not None and not outcome.hit:
            # reprogramming stalls the engine for the write-verify latency
            now += float(outcome.write_stats.latency_s)
            fleet.note_programmed(batch.tenant, now)
            metrics.add_program_dispatches(server.program_dispatches)
        elif outcome is not None and cfg.reliability is not None:
            # resident image: check analytic health before serving from it
            if fleet.aging_excess(batch.tenant, now) \
                    > cfg.reliability.refresh_threshold:
                rs = fleet.refresh_stats(batch.tenant,
                                         cfg.reliability.refresh_fraction)
                now += float(rs.latency_s)          # refresh stalls the engine
                fleet.cache.note_refresh(batch.tenant, rs)
                metrics.add_refresh(float(rs.energy_j), float(rs.latency_s))
                fleet.note_programmed(batch.tenant, now)
        if outcome is not None and cfg.reliability is not None:
            # the health this batch is actually served at (post any refresh)
            metrics.add_health(fleet.predicted(batch.tenant, now))

        start = now
        if cfg.run_model:
            toks = server.generate(_batch_inputs(batch, server.cfg, dev),
                                   batch.decode_bucket)
            assert tuple(toks.shape) == (batch.batch_pad,
                                         batch.decode_bucket)

        # analytic service cost at the PADDED shapes
        if cfg.rram is not None:
            pre = forward_input_stats(server.params, cfg.rram,
                                      batch=batch.padded_prompt_tokens)
            step = forward_input_stats(server.params, cfg.rram,
                                       batch=batch.batch_pad)
            pre_j, pre_s = float(pre.energy_j), float(pre.latency_s)
            step_j, step_s = float(step.energy_j), float(step.latency_s)
        else:
            n_params = fleet.n_params(batch.arch)
            pre_c = digital_cost(n_params, batch.padded_prompt_tokens)
            step_c = digital_cost(n_params, batch.batch_pad)
            pre_j, pre_s = pre_c["energy_j"], pre_c["latency_s"]
            step_j, step_s = step_c["energy_j"], step_c["latency_s"]

        exec_j = pre_j + step_j * batch.decode_bucket
        useful = batch.useful_prompt_tokens + batch.useful_decode_tokens
        padded = batch.padded_prompt_tokens + batch.padded_decode_tokens
        metrics.add_batch(exec_j, useful, padded,
                          dispatches=server.dispatches_per_batch(
                              batch.decode_bucket))

        for r in batch.requests:
            r_useful = r.prompt_len + r.decode_len
            metrics.add_record(RequestRecord(
                rid=r.rid, tenant=r.tenant, arch=r.arch,
                arrival_s=r.arrival_s, start_s=start,
                finish_s=start + pre_s + step_s * r.decode_len,
                prompt_len=r.prompt_len, decode_len=r.decode_len,
                energy_j=exec_j * r_useful / max(useful, 1)))
        # the engine is busy until the padded decode completes
        now = start + pre_s + step_s * batch.decode_bucket
        if cfg.rram is not None:
            # every padded token is a physical read against the image
            fleet.note_served(batch.tenant, batch.padded_prompt_tokens
                              + batch.batch_pad * batch.decode_bucket)

    cache_stats = fleet.cache.stats() if fleet.cache is not None else None
    return SimResult(summary=metrics.summary(cache_stats),
                     records=tuple(sorted(metrics.records,
                                          key=lambda r: r.rid)),
                     cache_stats=cache_stats)
