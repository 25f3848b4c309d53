"""Analysis of the port (of :mod:`repro.analysis`): the largest tensor a
call holds and its allocator peak on the card
(:mod:`~repro_torch.analysis.memory`), and the analytic model FLOPs a
step's rate is read against (:mod:`~repro_torch.analysis.model_flops`:
``param_count``, ``active_param_count``, ``model_flops``).  The reference's
jaxpr invariant passes (``verify``, ``pipelines``) and its roofline and HLO
cost modules are not ported yet.
"""
from . import model_flops
from .memory import max_aval_elements, peak_bytes

__all__ = ["max_aval_elements", "model_flops", "peak_bytes"]
