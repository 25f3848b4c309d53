"""Per-request and aggregate serving metrics on the simulated clock (port of
:mod:`repro.serving.metrics`).

Latency here is SIMULATED time: arrivals come from the traffic trace, service
times from the analytic cost models below -- never from wall-clock, so every
number is deterministic under a fixed seed.

Energy accounting follows the program-once split end to end:

  * analog service cost = per-MVM input-DAC writes
    (:func:`repro_torch.models.rram.forward_input_stats` -- prefill bills
    ``batch * prompt_bucket`` DAC vectors, each decode step bills ``batch``),
    billed at PADDED shapes: padding waste is real work and shows up in
    joules-per-token;
  * analog write cost = the one-time (re)programming :class:`WriteStats`
    accumulated by the image cache, reported separately AND folded into
    total joules-per-token (the amortization the eviction policy optimizes);
  * the digital fp32 baseline prices the same padded token stream at
    ``2 * n_params`` FLOPs per token against the reference's per-FLOP energy
    and sustained-throughput constants (DIGITAL_J_PER_FLOP /
    DIGITAL_FLOPS_PER_S).  They are a MODELLED yardstick, kept at the
    reference's values so that both packages bill the same joules: an
    A100-class fp32 envelope, neither a TPU's figure nor a measurement of
    the card this package runs on.

``joules_per_token`` divides by USEFUL tokens (requested prompt+decode
lengths), so both padding and reprogram churn degrade it honestly.

The accumulator's dispatch counts are what the simulator hands it: a
batch's ``exec_dispatches`` is :meth:`repro_torch.train.serve.Server.
dispatches_per_batch`, the port's step calls (a prefill and one a decode
step), where the reference counts one fused decode scan.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

__all__ = ["RequestRecord", "MetricsAccumulator", "percentile",
           "digital_cost", "DIGITAL_J_PER_FLOP", "DIGITAL_FLOPS_PER_S"]

# The reference's modelled fp32 digital baseline (A100-class): ~19.5 TFLOP/s
# peak derated to a sustained 10 TFLOP/s at ~250 W -> 2.5e-11 J/FLOP.  Not a
# measurement of any device; kept equal to the reference's for parity.
DIGITAL_J_PER_FLOP = 2.5e-11
DIGITAL_FLOPS_PER_S = 1.0e13


@dataclasses.dataclass(frozen=True)
class RequestRecord:
    """One finished request on the simulated clock."""

    rid: int
    tenant: str
    arch: str
    arrival_s: float
    start_s: float         # service start (after queueing + any reprogram)
    finish_s: float        # last decoded token emitted
    prompt_len: int
    decode_len: int
    energy_j: float        # this request's share of its batches' exec energy

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s

    @property
    def queue_s(self) -> float:
        return self.start_s - self.arrival_s


def percentile(values: List[float], q: float) -> float:
    """Deterministic linear-interpolation percentile (q in [0, 100])."""
    if not values:
        return 0.0
    vs = sorted(values)
    if len(vs) == 1:
        return vs[0]
    pos = (q / 100.0) * (len(vs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(vs) - 1)
    frac = pos - lo
    return vs[lo] * (1.0 - frac) + vs[hi] * frac


class MetricsAccumulator:
    """Collects request records + execution energy; emits the summary dict."""

    def __init__(self) -> None:
        self.records: List[RequestRecord] = []
        self.exec_energy_j = 0.0     # all executed work incl. padding
        self.padded_tokens = 0
        self.useful_tokens = 0
        self.n_batches = 0
        # dispatch accounting: execution step calls (a prefill + one per
        # decode step a batch) and one-time programming dispatches (grouped
        # program_rram: O(distinct kernel shapes) per build, not
        # O(kernels)).
        self.exec_dispatches = 0
        self.program_dispatches = 0
        # device-lifetime reliability (repro_torch.reliability): populated
        # only when the simulator runs with a ReliabilityConfig.
        self.refreshes = 0
        self.refresh_energy_j = 0.0
        self.refresh_stall_s = 0.0
        self.predicted_residuals: List[float] = []

    def add_batch(self, energy_j: float, useful_tokens: int,
                  padded_tokens: int, dispatches: int = 0) -> None:
        self.exec_energy_j += float(energy_j)
        self.useful_tokens += int(useful_tokens)
        self.padded_tokens += int(padded_tokens)
        self.n_batches += 1
        self.exec_dispatches += int(dispatches)

    def add_program_dispatches(self, dispatches: int) -> None:
        """One (re)program's device-launch count (a cache-miss build)."""
        self.program_dispatches += int(dispatches)

    def add_record(self, rec: RequestRecord) -> None:
        self.records.append(rec)

    def add_health(self, predicted_residual: float) -> None:
        """Record the analytic image-health estimate at service time."""
        self.predicted_residuals.append(float(predicted_residual))

    def add_refresh(self, energy_j: float, stall_s: float) -> None:
        self.refreshes += 1
        self.refresh_energy_j += float(energy_j)
        self.refresh_stall_s += float(stall_s)

    def summary(self, cache_stats: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
        lats = [r.latency_s for r in self.records]
        t0 = min((r.arrival_s for r in self.records), default=0.0)
        t1 = max((r.finish_s for r in self.records), default=0.0)
        makespan = max(t1 - t0, 1e-12)
        write_j = float(cache_stats["write_energy_j"]) if cache_stats else 0.0
        total_j = self.exec_energy_j + write_j
        useful = max(self.useful_tokens, 1)
        out = {
            "n_requests": len(self.records),
            "n_batches": self.n_batches,
            "useful_tokens": self.useful_tokens,
            "padded_tokens": self.padded_tokens,
            "padding_overhead": (self.padded_tokens / max(self.useful_tokens, 1)
                                 ) - 1.0,
            "makespan_s": makespan,
            "tokens_per_s": self.useful_tokens / makespan,
            "p50_latency_s": percentile(lats, 50.0),
            "p99_latency_s": percentile(lats, 99.0),
            "p999_latency_s": percentile(lats, 99.9),
            "mean_queue_s": (sum(r.queue_s for r in self.records)
                             / max(len(self.records), 1)),
            "exec_energy_j": self.exec_energy_j,
            "write_energy_j": write_j,
            "total_energy_j": total_j,
            "joules_per_token": total_j / useful,
            "exec_dispatches": self.exec_dispatches,
            "dispatches_per_batch": (self.exec_dispatches
                                     / max(self.n_batches, 1)),
            "program_dispatches": self.program_dispatches,
        }
        if cache_stats:
            out["cache"] = dict(cache_stats)
        if self.refreshes or self.predicted_residuals:
            preds = self.predicted_residuals
            out["reliability"] = {
                "refreshes": self.refreshes,
                "refresh_energy_j": self.refresh_energy_j,
                "refresh_stall_s": self.refresh_stall_s,
                "mean_predicted_residual": (sum(preds) / len(preds)
                                            if preds else 0.0),
                "max_predicted_residual": max(preds, default=0.0),
            }
        return out


def digital_cost(n_params: int, tokens: int) -> Dict[str, float]:
    """Energy/latency of pushing ``tokens`` positions through an
    ``n_params``-parameter model on the fp32 digital baseline."""
    flops = 2.0 * float(n_params) * float(tokens)
    return {"energy_j": flops * DIGITAL_J_PER_FLOP,
            "latency_s": flops / DIGITAL_FLOPS_PER_S}
