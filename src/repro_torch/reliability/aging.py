"""Device aging: conductance drift and stuck-at faults on a programmed image
(port of :mod:`repro.reliability.aging`).

What a programmed image becomes after ``N`` MVM read disturbs and ``t``
seconds of retention:

  * **Drift** -- every stored conductance decays by ``(1 + t/t0)^-nu``
    (:func:`repro_torch.core.devices.drift_factor`), per capacity block.
    The tier-1 operand ``dA`` was measured at program time, so the
    corrected MVM's error grows with age.
  * **Stuck-at faults** -- each cell latches with probability ``1 - (1 -
    fault_rate)^N``, at zero (G_off) or at the G_on rail ``sign(w) *
    max|block|`` of its stored block.  The per-cell uniforms of block (i,
    j) come from a ``torch.Generator`` under ``fold_in(fault_keys[i, j],
    refresh_count[i, j])``, so the faulted set replays exactly on one
    device (CUDA and CPU generators differ) and only grows with ``N``.

An :class:`AgeLedger` attached to a handle (``attach_age``) holds the
per-block counts; the engine's ``reference`` backend applies
:func:`aged_blocks` inside every execute of an aged handle.  A solve holds
the age fixed: its MVMs go through the solver's operator, which does not
advance the ledger, as the reference's jitted solve does not; a
host-dispatched ``A @ x`` adds one read disturb.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..core.devices import (DeviceModel, drift_factor, drift_factor_py,
                            effective_sigma_py)
from ..core.prng import block_key, fold_in, generator

__all__ = ["AgeLedger", "attach_age", "attach_group_age", "aged_blocks",
           "fault_probability", "predicted_residual", "FAULT_SALT"]

#: fold_in salt separating the fault-process key stream from the
#: programming and DAC streams derived from the same base key.
FAULT_SALT = 0x0FA17


@dataclasses.dataclass
class AgeLedger:
    """Per-capacity-block age of one programmed handle, as CPU tensors.

    ``mvms`` (read disturbs, float32), ``seconds`` (retention since the
    last (re)program, float32), ``refresh_count`` (int32) and
    ``fault_keys`` (the blocks' fault-process keys, int64) are (mb, nb); a
    group's stacked ledger has a leading member axis.  ``draws``, when
    given, replaces the generators' uniforms: (mb, nb, 2, cap_m, cap_n)
    (tests inject the reference's); it stands for every refresh count.
    Updates are functional, so a ledger checkpoints and restores through
    :class:`~repro_torch.distributed.CheckpointManager` like any tree.
    """

    mvms: torch.Tensor
    seconds: torch.Tensor
    refresh_count: torch.Tensor
    fault_keys: torch.Tensor
    draws: Optional[torch.Tensor] = None

    @classmethod
    def fresh(cls, base_key: int, mb: int, nb: int) -> "AgeLedger":
        """Age zero: the state of an image the instant verify completes."""
        fault_base = fold_in(base_key, FAULT_SALT)
        keys = [[block_key(fault_base, i, j) for j in range(nb)]
                for i in range(mb)]
        return cls(mvms=torch.zeros(mb, nb),
                   seconds=torch.zeros(mb, nb),
                   refresh_count=torch.zeros(mb, nb, dtype=torch.int32),
                   fault_keys=torch.tensor(keys, dtype=torch.int64))

    @property
    def grid(self):
        return tuple(self.mvms.shape)

    def advanced(self, n_mvms: int = 1) -> "AgeLedger":
        """``n_mvms`` more read disturbs on every block."""
        return dataclasses.replace(self, mvms=self.mvms + float(n_mvms))

    def elapsed(self, dt_s: float) -> "AgeLedger":
        """``dt_s`` more seconds of retention on every block."""
        return dataclasses.replace(self, seconds=self.seconds + float(dt_s))

    def reset(self, mask) -> "AgeLedger":
        """Per-block refresh: zero the age where ``mask`` (mb, nb) is True
        and bump the refresh count, so the next fault draws of those blocks
        come from a fresh fold of their keys."""
        mask = torch.as_tensor(np.asarray(mask, dtype=bool))
        return dataclasses.replace(
            self, mvms=torch.where(mask, 0.0, self.mvms),
            seconds=torch.where(mask, 0.0, self.seconds),
            refresh_count=self.refresh_count + mask.to(torch.int32))

    def member(self, g: int) -> "AgeLedger":
        """Member ``g`` of a group's stacked ledger."""
        return AgeLedger(mvms=self.mvms[g], seconds=self.seconds[g],
                         refresh_count=self.refresh_count[g],
                         fault_keys=self.fault_keys[g],
                         draws=None if self.draws is None else self.draws[g])


def attach_age(A, *, draws: Optional[torch.Tensor] = None) -> AgeLedger:
    """Attach a fresh :class:`AgeLedger` to a local handle and return it.
    Streamed and distributed handles are refused, as the reference refuses
    them (their faults are injected into ``at_ranks`` between segments
    instead).  ``draws`` replaces the fault draws (see :class:`AgeLedger`).
    """
    if A.streamed or A.mesh_sharded:
        raise ValueError(
            "attach_age needs a local handle with resident at/da blocks; "
            "streamed and distributed handles age via host-side injection")
    mb, nb = A._grid()
    A.age = dataclasses.replace(AgeLedger.fresh(A.base_key, mb, nb),
                                draws=draws)
    return A.age


def attach_group_age(G, *, draws: Optional[torch.Tensor] = None
                     ) -> AgeLedger:
    """Attach a stacked :class:`AgeLedger` to a local group: member ``g``'s
    ledger is seeded from ``member_keys[g]``, so its faults are those of a
    solo handle aged from that key.  ``draws`` (size, mb, nb, 2, cap_m,
    cap_n) replaces the fault draws."""
    if G.streamed or G.mesh_sharded:
        raise ValueError(
            "attach_group_age needs a local group with resident at/da "
            "blocks; streamed and distributed groups age via host-side "
            "injection")
    cap_m, cap_n = G.engine.cfg.geom.capacity
    mb, nb = -(-G.m // cap_m), -(-G.n // cap_n)
    members = [AgeLedger.fresh(k, mb, nb) for k in G.member_keys]
    G.ages = AgeLedger(*(torch.stack([getattr(led, f) for led in members])
                         for f in ("mvms", "seconds", "refresh_count",
                                   "fault_keys")), draws=draws)
    return G.ages


def fault_probability(device: DeviceModel, mvms) -> torch.Tensor:
    """P(cell stuck) after ``mvms`` read disturbs, ``1 - (1 - rate)^N``,
    computed in float32 as ``-expm1(N * log1p(-rate))``: the naive form
    rounds ``1 - 1e-9`` to 1.0 and gives exactly 0."""
    n = torch.as_tensor(mvms, dtype=torch.float32)
    return -torch.expm1(n * torch.log1p(
        torch.tensor(-device.fault_rate, dtype=torch.float32)))


def aged_blocks(at_blocks: torch.Tensor, age: AgeLedger,
                device: DeviceModel, *,
                u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The physical image after aging, a new (mb, nb, cap_m, cap_n) tensor
    on ``at_blocks``' device.

    Each block is the stored block times its drift factor, then cell (r,
    c) of block (i, j) latches where ``u[i, j, 0, r, c] <
    fault_probability(device, mvms[i, j])``: to 0 where ``u[i, j, 1, r, c]
    < 0.5``, else to ``sign(w) * max|stored block|``.  ``u`` (or
    ``age.draws``) replaces the draws, which are otherwise made one block
    at a time from ``fold_in(fault_keys[i, j], refresh_count[i, j])``, so
    the peak is the aged copy plus one block's draws.  A device with
    ``fault_rate == 0`` skips the fault pass, and a block at zero MVMs
    cannot latch.  ``torch.rand`` draws on a 2^-24 grid (``jax.random.
    uniform`` on 2^-23), so below p ~ 1e-7 the latch probability is
    ``ceil(p * 2^24) / 2^24`` (the reference's: ``ceil(p * 2^23) / 2^23``).
    """
    u = age.draws if u is None else u
    decay = drift_factor(device, age.seconds).to(at_blocks.device)
    out = at_blocks * decay[:, :, None, None]
    if device.fault_rate <= 0.0:
        return out
    p = fault_probability(device, age.mvms)
    mb, nb = age.grid
    for i in range(mb):
        for j in range(nb):
            p_ij = float(p[i, j])
            if p_ij == 0.0:
                continue
            blk = at_blocks[i, j]
            if u is None:
                gen = generator(fold_in(int(age.fault_keys[i, j]),
                                        int(age.refresh_count[i, j])),
                                blk.device)
                u_ij = torch.rand((2,) + tuple(blk.shape), generator=gen,
                                  device=blk.device)
            else:
                u_ij = torch.as_tensor(u[i, j], dtype=torch.float32,
                                       device=blk.device)
            # Faults are sparse: only the latched cells are read and set.
            stuck = torch.nonzero(u_ij[0] < p_ij, as_tuple=True)
            if stuck[0].numel():
                rail = torch.sign(blk[stuck]) * torch.linalg.vector_norm(
                    blk, float("inf"))
                out[i, j][stuck] = torch.where(u_ij[1][stuck] < 0.5, 0.0,
                                               rail)
            del u_ij
    return out


def predicted_residual(device: DeviceModel, *, k_iters: int, seconds: float,
                       mvms: float, n: int) -> float:
    """Analytic health proxy: the predicted relative MVM error at this age
    (host math, no tensor): the programming noise after ``k_iters`` verify
    passes, the uncorrected drift ``1 - (1 + t/t0)^-nu`` and the expected
    stuck-cell term ``sqrt(P_fault * n)``, in quadrature.  Equal to
    ``effective_sigma`` at age zero."""
    sigma_k = effective_sigma_py(device, k_iters)
    drift = 1.0 - drift_factor_py(device, seconds)
    p = -math.expm1(float(mvms) * math.log1p(-device.fault_rate)) \
        if device.fault_rate > 0.0 else 0.0
    return math.sqrt(sigma_k ** 2 + drift ** 2 + p * float(n))
