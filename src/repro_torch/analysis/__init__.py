"""Analysis of the port (of :mod:`repro.analysis`): the largest tensor a
call holds and its allocator peak on the card
(:mod:`~repro_torch.analysis.memory`), the analytic model FLOPs a step's
rate is read against (:mod:`~repro_torch.analysis.model_flops`:
``param_count``, ``active_param_count``, ``model_flops``), the five
invariant audits (:mod:`~repro_torch.analysis.verify`: ``aval_bound``,
``dispatch_count``, ``key_reuse``, ``precision_lint``,
``collective_audit``, ``run_all``), each of which runs the call once and
audits that run, and the registry of pipelines they run over
(:mod:`~repro_torch.analysis.pipelines`), and the cost model and roofline
of one run: :mod:`~repro_torch.analysis.cost` (``RunCost``,
``measure_cost``: flops, bytes and wire bytes of one counted run, each
kernel function by its declared cost), :mod:`~repro_torch.analysis.wire`
(``collective_wire``, the ring model, over the run's psums and joins) and
:mod:`~repro_torch.analysis.roofline` (``HW``, the card's rates;
``roofline_terms``, ``format_row``, ``analyze_run``: the three terms, and
on the card the run's device time against them).

The reference's ``jaxpr_max_elements`` and ``trace`` have no counterpart:
eager PyTorch has no jaxpr, and :func:`aval_bound`'s report (the largest
tensor of one run, with its operator and line) takes the place of
``jaxpr_max_elements``.  Nor have its ``_cpu_bf16_artifact_bytes``,
``peak_bytes_tpu`` and ``fits_hbm_raw_cpu``, which exist only for the
float32 twins XLA's CPU backend makes of bfloat16 weights; and its HLO text
parser, whose place the run's observers take.
"""
from . import model_flops
from .cost import RunCost, measure_cost
from .memory import max_aval_elements, peak_bytes
from .roofline import HW, analyze_run, format_row, roofline_terms
from .wire import collective_wire, collective_wire_bytes, count_op
from .verify import (CallCounter, Report, Site, Violation, aval_bound,
                     collective_audit, dispatch_count, key_reuse,
                     precision_lint, run_all)

__all__ = [
    "Site", "Violation", "Report", "CallCounter", "aval_bound",
    "dispatch_count", "key_reuse", "precision_lint", "collective_audit",
    "run_all", "max_aval_elements", "peak_bytes", "model_flops", "RunCost",
    "measure_cost", "collective_wire", "collective_wire_bytes", "count_op",
    "HW", "roofline_terms", "format_row", "analyze_run",
]
