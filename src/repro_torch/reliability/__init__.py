"""Device-lifetime reliability (port of :mod:`repro.reliability`): what a
programmed image becomes over a device lifetime, and the loop that keeps
it useful.

  * :mod:`.aging` -- conductance drift and replayable stuck-at faults,
    applied by the engine's ``reference`` backend to a handle with an
    :class:`~.aging.AgeLedger` attached;
  * :mod:`.probes` -- per-tile health from one batched corrected MVM
    against known test vectors;
  * :mod:`.refresh` -- re-programming of the worst tiles only, billed
    against a full reprogram;
  * :mod:`.ft_solve` -- segmented CG / PDHG with digital divergence
    detection and checkpoint restore.

Imports ``torch`` only.
"""
from .aging import (AgeLedger, aged_blocks, attach_age, attach_group_age,
                    fault_probability, predicted_residual)
from .ft_solve import FaultEvent, ft_cg, ft_pdhg
from .probes import ProbeReport, probe_tile_scores, probe_vectors
from .refresh import (RefreshPolicy, RefreshReport, refresh_tiles,
                      select_tiles)

__all__ = [
    "AgeLedger", "aged_blocks", "attach_age", "fault_probability",
    "predicted_residual",
    "ProbeReport", "probe_tile_scores", "probe_vectors",
    "RefreshPolicy", "RefreshReport", "refresh_tiles", "select_tiles",
    "FaultEvent", "ft_cg", "ft_pdhg",
]
