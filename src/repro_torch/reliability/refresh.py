"""Online refresh: re-program only the tiles the probes flag (port of
:mod:`repro.reliability.refresh`).

Rank tiles by probe score, re-run closed-loop write-and-verify
(:func:`~repro_torch.core.write_verify.refresh_write_and_verify`) on the
worst few, and bill the actual :class:`WriteStats` against the cost of a
full reprogram: ``k`` tiles cost at most ``k * tile_write_cost(cfg)``, so a
refresh pays off whenever ``k < mb * nb``, the regime of sparse, tile-local
stuck-at damage.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import crossbar
from ..core.prng import fold_in
from ..core.write_verify import WriteStats, refresh_write_and_verify

__all__ = ["RefreshPolicy", "RefreshReport", "refresh_tiles", "select_tiles",
           "REFRESH_SALT"]

#: The refresh key stream's salt: apart from the program-time block keys,
#: the DAC draws and the aging stream.
REFRESH_SALT = 0xF5E5


@dataclasses.dataclass(frozen=True)
class RefreshPolicy:
    """``threshold``: probe score above which a tile is a candidate (compare
    with the fresh image's ``effective_sigma``); ``max_tiles``: cap on the
    tiles re-programmed a pass (None: every candidate)."""

    threshold: float = 0.05
    max_tiles: Optional[int] = None


@dataclasses.dataclass
class RefreshReport:
    """What one refresh pass did and what it cost."""

    tiles: Tuple[Tuple[int, int], ...]   # (i, j) re-programmed, worst first
    write_stats: WriteStats              # actual verify-loop cost (summed)
    full_rewrite_stats: WriteStats       # cost of reprogramming everything
    scores_before: np.ndarray            # the (mb, nb) probe map acted on

    @property
    def energy_saving(self) -> float:
        """Fraction of a full reprogram's energy avoided by selection."""
        full = float(self.full_rewrite_stats.energy_j)
        return 1.0 - float(self.write_stats.energy_j) / full if full else 0.0


def _host(scores) -> np.ndarray:
    if isinstance(scores, torch.Tensor):
        return scores.detach().cpu().numpy()
    return np.asarray(scores)


def select_tiles(scores, policy: RefreshPolicy) -> Tuple[Tuple[int, int], ...]:
    """Candidate tiles, worst score first, thresholded and capped."""
    s = _host(scores)
    idx = np.argwhere(s > policy.threshold)
    ranked = sorted(map(tuple, idx), key=lambda ij: -s[ij])
    if policy.max_tiles is not None:
        ranked = ranked[: policy.max_tiles]
    return tuple((int(i), int(j)) for i, j in ranked)


def refresh_tiles(A, scores, policy: RefreshPolicy = RefreshPolicy(), *,
                  key: Optional[int] = None,
                  eta: Optional[Sequence[torch.Tensor]] = None
                  ) -> RefreshReport:
    """Re-program the worst tiles of local handle ``A`` in place.

    Each selected tile's source ``A_tilde + dA`` (tier-1 keeps it exactly)
    goes through the closed verify loop; the new image and correction are
    written into the ``at_pad`` / ``da_pad`` block views, and an attached
    ledger is reset on those tiles (bumping ``refresh_count``, so the fault
    process redraws).  Tile (i, j) is keyed ``fold_in(fold_in(fold_in(base,
    REFRESH_SALT), i * nb + j), refresh_count)`` with ``base`` the handle's
    key or ``key``; ``eta[t]`` ((k_iters + 1, cap_m, cap_n)) replaces the
    verify draws of the ``t``-th selected tile.
    """
    if A.streamed or A.mesh_sharded:
        raise ValueError(
            "refresh_tiles needs resident at/da blocks (execution='local'); "
            "streamed and producer handles re-materialize instead of "
            "refreshing")
    cfg = A.engine.cfg
    mb, nb = A._grid()
    tiles = select_tiles(scores, policy)
    full = crossbar.matrix_write_cost(*A.shape, cfg)
    if not tiles:
        return RefreshReport(tiles=(), write_stats=WriteStats.zero(),
                             full_rewrite_stats=full,
                             scores_before=_host(scores))
    stream = fold_in(A.base_key if key is None else key, REFRESH_SALT)
    at, da = A.at_blocks, A.da_blocks
    total = WriteStats.zero()
    mask = np.zeros((mb, nb), bool)
    for t, (i, j) in enumerate(tiles):
        src = at[i, j] + da[i, j]
        rc = int(A.age.refresh_count[i, j]) if A.age is not None else 0
        new_at, st = refresh_write_and_verify(
            src, fold_in(fold_in(stream, i * nb + j), rc), cfg.device,
            k_iters=cfg.k_iters, eta=None if eta is None else eta[t])
        at[i, j] = new_at
        da[i, j] = src.sub_(new_at)
        total = total + st
        mask[i, j] = True
    if A.age is not None:
        A.age = A.age.reset(mask)
    return RefreshReport(tiles=tiles, write_stats=total,
                         full_rewrite_stats=full,
                         scores_before=_host(scores))
