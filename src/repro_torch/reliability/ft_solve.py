"""Fault-tolerant solves: segmented CG / PDHG with checkpoint restore (port
of :mod:`repro.reliability.ft_solve`).

A device fault in the middle of a solve (a stuck cell flipping at iteration
k) poisons a Krylov recurrence: CG's residual is kept recursively, so once
the operator changes it no longer tracks ``b - A x``.  The wrappers here
survive that:

  * the solve runs in segments; for CG each is one refinement step (the
    digital residual ``r = b - A x`` against the healthy matrix captured
    at entry, an analog inner CG on ``A d = r`` of at most ``segment``
    iterations, ``x += d``), which also converges below the analog noise
    floor;
  * a NaN, or a residual worse than the healthy contraction, declares a
    fault: the iterate is rolled back to the last good checkpoint on disk
    (:class:`~repro_torch.distributed.CheckpointManager`), ``on_fault`` may
    repair the operator, and the next segment runs;
  * inside a segment the solver's own detector (``divergence=`` of
    :func:`~repro_torch.solvers.cg` / ``pdhg``) exits early, so a faulted
    segment costs a few MVMs.

The healthy reference ``a_ref = op.dense()`` stays a float32 tensor on the
operator's device and the digital residuals are plain products there.  A
solve holds an attached ledger's age fixed; each segment's MVMs are billed
to it once, after the segment.
"""
from __future__ import annotations

import dataclasses
import math
import tempfile
from typing import Callable, List, Optional

import torch

from ..core.prng import fold_in
from ..distributed.fault_tolerance import CheckpointManager
from ..solvers.base import (SolveLedger, SolveResult, as_operator, as_panel,
                            col_norms)
from ..solvers.krylov import cg
from ..solvers.pdhg import pdhg

__all__ = ["FaultEvent", "ft_cg", "ft_pdhg"]

_TINY = 1e-30


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One detected divergence: which segment, how it showed, where to."""

    segment: int        # segment index that tripped the detector
    kind: str           # "nan" | "residual-spike"
    residual: float     # the offending digital residual
    restored_step: int  # checkpoint step rolled back to


def _col_rel(a_ref: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
             bn: torch.Tensor) -> torch.Tensor:
    """Per-column digital relative residual ||b - A_ref x|| / ||b||."""
    return col_norms(b - a_ref @ x) / bn


def _bill_age(A, mvms: int) -> None:
    """Add a segment's MVMs to an attached ledger (the solve held it)."""
    if getattr(A, "age", None) is not None:
        A.age = A.age.advanced(mvms)


def _history(seg_hist: List[torch.Tensor], batch: int, device) -> torch.Tensor:
    if seg_hist:
        return torch.stack(seg_hist)
    return torch.full((1, batch), float("nan"), device=device)


def ft_cg(
    A,
    b,
    *,
    tol: float = 1e-6,
    maxiter: int = 400,
    segment: int = 30,
    inner_tol: float = 1e-2,
    manager: Optional[CheckpointManager] = None,
    key: int = 0,
    spike_factor: float = 10.0,
    max_restores: int = 8,
    on_fault: Optional[Callable[[FaultEvent, object], None]] = None,
    segment_hook: Optional[Callable[[int, object], None]] = None,
    backend: Optional[str] = None,
    device=None,
) -> SolveResult:
    """Fault-tolerant CG for SPD ``A`` (anything :func:`as_operator` takes
    that has a ``dense()``: analog handles of every placement qualify).

    ``segment_hook(seg, A)`` runs before every segment (a fault injector);
    ``on_fault(event, A)`` after every detected fault, before the retry --
    repair the handle there.  On a fault the iterate is reloaded from the
    last good checkpoint on disk, not from memory.  ``manager`` defaults to
    a fresh temp-dir :class:`CheckpointManager`; ``backend`` is passed to
    the inner :func:`cg`.  The result's ``residuals`` hold one digital
    relative residual per accepted segment (``iterations`` counts accepted
    segments), ``restores`` the rollbacks and ``fault_events`` the faults.
    """
    op = as_operator(A, device=device)
    if op.dense is None:
        raise ValueError("ft_cg needs an operator with dense() for the "
                         "digital outer residual check")
    # The healthy reference, captured at entry: faults injected during the
    # solve are judged against the matrix the caller asked to solve with.
    a_ref = op.dense().to(torch.float32)
    bb, squeeze = as_panel(b, op.device)
    bn = torch.clamp(col_norms(bb), min=_TINY)
    if manager is None:
        manager = CheckpointManager(tempfile.mkdtemp(prefix="ft_cg_"))

    x = torch.zeros(op.shape[1], bb.shape[1], device=op.device)
    rel = _col_rel(a_ref, x, bb, bn)
    entry_rel = float(torch.max(rel))
    manager.save(0, {"x": x}, blocking=True,
                 extra={"segment": -1, "rel": entry_rel})
    good_step = seg = restores = stalls = mvms = total_iters = 0
    seg_hist: List[torch.Tensor] = []
    events: List[FaultEvent] = []

    while total_iters < maxiter and float(torch.max(rel)) > tol:
        if segment_hook is not None:
            segment_hook(seg, A)
        # One refinement step: digital residual, a crude analog inner solve
        # of A d = r, a tentative update judged by its true residual.
        r = bb - a_ref @ x
        res = cg(A, r, tol=inner_tol, maxiter=segment,
                 key=fold_in(key, 101 + seg), backend=backend,
                 divergence=spike_factor, device=device)
        mvms += res.ledger.mvms
        _bill_age(A, res.ledger.mvms)
        x_try = x + res.x
        rel_try = _col_rel(a_ref, x_try, bb, bn)
        worst = float(torch.max(rel_try))
        # Three fault signatures, all against the healthy reference: the
        # inner core's own early exit, anything non-finite, and a correction
        # that makes the residual equation worse (a healthy inner solve
        # contracts ||r - A_ref d|| / ||r|| to about its tolerance).
        d_rel = float(torch.max(_col_rel(
            a_ref, res.x, r, torch.clamp(col_norms(r), min=_TINY))))
        early_div = (not res.converged) and int(res.iterations) < segment
        nan_like = not (math.isfinite(worst) and math.isfinite(d_rel))
        if early_div or nan_like or d_rel > 1.0:
            event = FaultEvent(
                segment=seg, kind="nan" if nan_like else "residual-spike",
                residual=d_rel if math.isfinite(d_rel) else worst,
                restored_step=good_step)
            events.append(event)
            restores += 1
            x = manager.restore({"x": x}, step=good_step)["x"]
            if on_fault is not None:
                on_fault(event, A)
            seg += 1
            if restores > max_restores:
                break
            continue
        if worst >= float(torch.max(rel)):
            stalls += 1
            if stalls >= 2:
                break  # the refinement floor: two non-contracting steps
            seg += 1
            continue
        stalls = 0
        x, rel = x_try, rel_try
        seg_hist.append(rel_try)
        total_iters += max(int(res.iterations), 1)
        good_step += 1
        manager.save(good_step, {"x": x}, blocking=True,
                     extra={"segment": seg, "rel": worst})
        seg += 1

    hist = _history(seg_hist, bb.shape[1], op.device)
    result = SolveResult(
        x=x[:, 0] if squeeze else x,
        residuals=hist[:, 0] if squeeze else hist,
        iterations=len(seg_hist),
        converged=bool(float(torch.max(rel)) <= tol),
        ledger=SolveLedger(write_stats=op.write_stats,
                           input_stats=op.input_stats(bb.shape[1]),
                           mvms=int(mvms)),
        solver="ft-cg",
        initial_residual=entry_rel,
        restores=restores,
    )
    result.fault_events = tuple(events)
    return result


def ft_pdhg(
    A,
    b,
    c,
    *,
    tol: float = 1e-4,
    maxiter: int = 2000,
    segment: int = 200,
    manager: Optional[CheckpointManager] = None,
    key: int = 0,
    spike_factor: float = 10.0,
    max_restores: int = 8,
    on_fault: Optional[Callable[[FaultEvent, object], None]] = None,
    segment_hook: Optional[Callable[[int, object], None]] = None,
    eta: float = 0.9,
    power_iters: int = 16,
    device=None,
) -> SolveResult:
    """Fault-tolerant PDHG for ``min c'x s.t. Ax = b, x >= 0``.

    The segmented analogue of :func:`ft_cg`: checkpoints carry the pair
    ``(x, y)``, and the outer health check is the digital KKT residual
    (the max of primal and dual infeasibility and the relative gap) against
    the healthy ``A`` captured at entry.
    """
    op = as_operator(A, device=device)
    if op.dense is None or op.rmatvec is None:
        raise ValueError("ft_pdhg needs an operator with dense() and rmatvec")
    a_ref = op.dense().to(torch.float32)
    bb, squeeze = as_panel(b, op.device)
    cc, _ = as_panel(c, op.device)
    bn = 1.0 + col_norms(bb)
    cn = 1.0 + col_norms(cc)
    if manager is None:
        manager = CheckpointManager(tempfile.mkdtemp(prefix="ft_pdhg_"))

    def kkt(x, y) -> torch.Tensor:
        primal = col_norms(a_ref @ x - bb) / bn
        slack = torch.clamp(-(cc + a_ref.T @ y), min=0.0)
        dual = col_norms(slack) / cn
        pobj = torch.sum(cc * x, dim=0)
        dobj = -torch.sum(bb * y, dim=0)
        gap = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj)
                                        + torch.abs(dobj))
        return torch.maximum(torch.maximum(primal, dual), gap)

    x = torch.zeros(op.shape[1], bb.shape[1], device=op.device)
    y = torch.zeros(op.shape[0], bb.shape[1], device=op.device)
    rel = kkt(x, y)
    entry_rel = float(torch.max(rel))
    best = max(entry_rel, tol)
    manager.save(0, {"x": x, "y": y}, blocking=True,
                 extra={"segment": -1, "rel": entry_rel})
    good_step = seg = restores = stalls = total_iters = 0
    mvms = mvms_t = mvms_single = 0
    seg_hist: List[torch.Tensor] = []
    events: List[FaultEvent] = []

    while total_iters < maxiter and float(torch.max(rel)) > tol:
        if segment_hook is not None:
            segment_hook(seg, A)
        # PDHG's KKT residual is not monotone in its transient, so the
        # in-core margin is wider: its job is the immediate NaN exit, spike
        # detection is the wrapper's.
        res = pdhg(A, bb, cc, tol=tol, maxiter=segment, x0=x, y0=y,
                   key=fold_in(key, 211 + seg), eta=eta,
                   power_iters=power_iters,
                   divergence=max(spike_factor, 50.0), device=device)
        mvms += res.ledger.mvms
        mvms_t += res.ledger.mvms_t
        mvms_single += res.ledger.mvms_single
        _bill_age(A, res.ledger.mvms + res.ledger.mvms_t)
        rel_try = kkt(res.x, res.dual)
        worst = float(torch.max(rel_try))
        early_div = (not res.converged) and int(res.iterations) < segment
        nan_like = not math.isfinite(worst)
        if early_div or nan_like or worst > spike_factor * best:
            event = FaultEvent(
                segment=seg, kind="nan" if nan_like else "residual-spike",
                residual=worst, restored_step=good_step)
            events.append(event)
            restores += 1
            state = manager.restore({"x": x, "y": y}, step=good_step)
            x, y = state["x"], state["y"]
            if on_fault is not None:
                on_fault(event, A)
            seg += 1
            if restores > max_restores:
                break
            continue
        if worst >= float(torch.max(rel)):
            stalls += 1
            if stalls >= 2:
                break  # the noise floor: two non-contracting segments
            seg += 1
            continue
        stalls = 0
        x, y = res.x, res.dual
        rel = rel_try
        best = min(best, max(worst, tol))
        seg_hist.append(rel_try)
        total_iters += max(int(res.iterations), 1)
        good_step += 1
        manager.save(good_step, {"x": x, "y": y}, blocking=True,
                     extra={"segment": seg, "rel": worst})
        seg += 1

    hist = _history(seg_hist, bb.shape[1], op.device)
    batch = bb.shape[1]
    stats_t = op.input_stats_t or op.input_stats
    result = SolveResult(
        x=x[:, 0] if squeeze else x,
        residuals=hist[:, 0] if squeeze else hist,
        iterations=len(seg_hist),
        converged=bool(float(torch.max(rel)) <= tol),
        ledger=SolveLedger(write_stats=op.write_stats,
                           input_stats=op.input_stats(batch),
                           mvms=int(mvms),
                           input_stats_single=op.input_stats(1),
                           mvms_single=int(mvms_single),
                           input_stats_t=stats_t(batch),
                           mvms_t=int(mvms_t),
                           input_stats_single_t=stats_t(1),
                           mvms_single_t=int(mvms_single)),
        solver="ft-pdhg",
        initial_residual=entry_rel,
        restores=restores,
        dual=y[:, 0] if squeeze else y,
    )
    result.fault_events = tuple(events)
    return result
