"""Distributed helpers of the port: checkpoints, preemption and the straggler
watchdog (:mod:`.fault_tolerance`).  The sharding rules and collectives of
:mod:`repro.distributed` serve the model layers and are not ported yet."""
from .fault_tolerance import (PREEMPTED, CheckpointManager, Watchdog,
                              install_preemption_handler)

__all__ = ["CheckpointManager", "Watchdog", "install_preemption_handler",
           "PREEMPTED"]
