"""Analysis of the port (of :mod:`repro.analysis`): the largest tensor a
call holds and its allocator peak on the card
(:mod:`~repro_torch.analysis.memory`), the analytic model FLOPs a step's
rate is read against (:mod:`~repro_torch.analysis.model_flops`:
``param_count``, ``active_param_count``, ``model_flops``), the five
invariant audits (:mod:`~repro_torch.analysis.verify`: ``aval_bound``,
``dispatch_count``, ``key_reuse``, ``precision_lint``,
``collective_audit``, ``run_all``), each of which runs the call once and
audits that run, and the registry of pipelines they run over
(:mod:`~repro_torch.analysis.pipelines`).

The reference's ``jaxpr_max_elements`` and ``trace`` have no counterpart:
eager PyTorch has no jaxpr, and :func:`aval_bound`'s report (the largest
tensor of one run, with its operator and line) takes the place of
``jaxpr_max_elements``.  The reference's roofline and HLO cost modules are
not ported yet.
"""
from . import model_flops
from .memory import max_aval_elements, peak_bytes
from .verify import (CallCounter, Report, Site, Violation, aval_bound,
                     collective_audit, dispatch_count, key_reuse,
                     precision_lint, run_all)

__all__ = [
    "Site", "Violation", "Report", "CallCounter", "aval_bound",
    "dispatch_count", "key_reuse", "precision_lint", "collective_audit",
    "run_all", "max_aval_elements", "peak_bytes", "model_flops",
]
