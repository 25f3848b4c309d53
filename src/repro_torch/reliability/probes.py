"""Health probes: estimate per-tile degradation without reading the array
(port of :mod:`repro.reliability.probes`).

One batched corrected MVM against known test vectors localizes damage to
capacity tiles: probe column ``j`` is a fixed cosine ramp supported only on
column block ``j``, so output rows of row block ``i`` respond only to tile
``(i, j)``, and the ``(n, nb)`` batch yields the whole (mb, nb) map.  Probe
executions are real executions: they take the handle's key schedule, are
billed as input writes and age an attached ledger by ``nb`` read disturbs.
The scores feed :mod:`repro_torch.reliability.refresh`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.write_verify import WriteStats

__all__ = ["ProbeReport", "probe_vectors", "probe_tile_scores"]

_TINY = 1e-12


@dataclasses.dataclass(frozen=True)
class ProbeReport:
    """One probe pass: the (mb, nb) per-tile residual map and its cost."""

    scores: torch.Tensor       # (mb, nb) relative per-tile residuals
    input_stats: WriteStats    # DAC/EC input-write cost of the probe batch
    n_probes: int              # probe columns executed (== nb)

    @property
    def worst(self) -> float:
        return float(torch.max(self.scores))


def probe_vectors(n: int, nb: int, cap_n: int, *,
                  device="cuda") -> torch.Tensor:
    """The (n, nb) probe panel on ``device``: column ``j`` is a unit-norm
    cosine ramp on column block ``j``, zero elsewhere (a fixed pattern, so
    the same probes serve the whole lifetime)."""
    x = torch.zeros(n, nb, dtype=torch.float32, device=device)
    for j in range(nb):
        lo, hi = j * cap_n, min((j + 1) * cap_n, n)
        ramp = torch.cos(math.pi * (torch.arange(
            hi - lo, dtype=torch.float32, device=device) + 0.5) / (hi - lo))
        x[lo:hi, j] = ramp / torch.clamp(torch.linalg.vector_norm(ramp),
                                         min=_TINY)
    return x


def probe_tile_scores(A, *, key: Optional[int] = None,
                      eta: Optional[torch.Tensor] = None) -> ProbeReport:
    """Run the probe batch against handle ``A``; returns per-tile scores.

    ``scores[i, j]`` is the relative l2 error of row block ``i`` under probe
    ``j``: the health of tile ``(i, j)``.  The digital reference is
    ``A.dense() @ x`` on the image's device (tier-1 keeps the source as
    ``A_tilde + dA``, untouched by aging).  The probe call is one ordinary
    execute (``key`` and ``eta`` as for ``engine.mvm``), so an attached
    ledger both shapes the answer and advances: one read disturb from the
    call and ``nb - 1`` more here, for the ``nb`` columns read.
    """
    engine = A.engine
    m, n = A.shape
    mb, nb = A._grid()
    cap_m, cap_n = engine.cfg.geom.capacity
    x = probe_vectors(n, nb, cap_n, device=engine.device)
    y = engine.mvm(A, x, key=key, eta=eta)
    y_ref = A.dense() @ x
    if A.age is not None:
        A.age = A.age.advanced(nb - 1)
    pad = mb * cap_m - m
    y_pad = F.pad(y, (0, 0, 0, pad)).view(mb, cap_m, nb)
    r_pad = F.pad(y_ref, (0, 0, 0, pad)).view(mb, cap_m, nb)
    err = torch.sqrt(torch.sum((y_pad - r_pad) ** 2, dim=1))
    ref = torch.sqrt(torch.sum(r_pad ** 2, dim=1))
    scores = err / torch.clamp(ref, min=_TINY)
    return ProbeReport(scores=scores,
                       input_stats=engine.input_write_stats(A, batch=nb),
                       n_probes=nb)
