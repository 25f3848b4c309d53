"""Distributed helpers of the port (of :mod:`repro.distributed`): the
logical-axis sharding rules and per-rank views (:mod:`.sharding`), int8
and ring collectives (:mod:`.collectives`), and checkpoints, preemption
and the straggler watchdog (:mod:`.fault_tolerance`)."""
from .sharding import (batch_pspec, cache_pspecs, data_axes, param_pspecs,
                       param_shardings)
from .collectives import compressed_psum, int8_quantize, ring_collective_matmul
from .fault_tolerance import (PREEMPTED, CheckpointManager, Watchdog,
                              install_preemption_handler)

__all__ = [
    "batch_pspec", "cache_pspecs", "data_axes", "param_pspecs",
    "param_shardings",
    "compressed_psum", "int8_quantize", "ring_collective_matmul",
    "CheckpointManager", "Watchdog", "install_preemption_handler",
    "PREEMPTED",
]
