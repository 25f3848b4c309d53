"""Solver plumbing: operators, results and the energy/latency ledger (port of
:mod:`repro.solvers.base`).

:func:`as_operator` adapts an :class:`~repro_torch.engine.AnalogMatrix` (each
matvec a corrected analog execution whose input-write cost lands in the
ledger, and ``rmatvec`` the corrected transposed execution against the same
image), a :class:`~repro_torch.engine.TransposedAnalogMatrix` view, a dense
tensor (exact digital matvec and rmatvec, zero ledger) or a bare
``matvec(v, key)`` callable (``rmatvec=`` optional) into one
:class:`LinearOperator`.  ``key`` is the integer key of that MVM
(:mod:`repro_torch.core.prng`): the analog matvec seeds its
``torch.Generator`` from it, a digital one ignores it.

The solvers' loops are driven from the host; each solver checks its
convergence test once per iteration, as the reference's ``lax.while_loop``
does, so the two take the same number of iterations.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core.write_verify import WriteStats
from ..engine import AnalogMatrix, TransposedAnalogMatrix

__all__ = ["LinearOperator", "SolveLedger", "SolveResult", "as_operator",
           "col_norms", "diverged", "init_history", "use_cuda", "pack_result",
           "as_panel"]

_TINY = 1e-30


def use_cuda(backend: Optional[str]) -> bool:
    """Validate a solver ``backend=`` switch (None -> reference path)."""
    if backend is None:
        return False
    if backend not in ("reference", "cuda"):
        raise ValueError(f"unknown solver backend {backend!r}")
    return backend == "cuda"


def col_norms(v: torch.Tensor) -> torch.Tensor:
    """Column-wise l2 norms of an (n, batch) panel -> (batch,)."""
    return torch.sqrt(torch.sum(v * v, dim=0))


def diverged(rel: torch.Tensor, best: torch.Tensor,
             divergence: Optional[float], tol: float) -> bool:
    """The in-loop fault detector of CG and PDHG (``divergence=``): a NaN
    column, or one above ``divergence`` x its best residual (floored at
    ``tol``); always False when ``divergence`` is None."""
    if divergence is None:
        return False
    return bool(torch.any(torch.isnan(rel)) or torch.any(
        rel > divergence * torch.clamp(best, min=tol)))


def init_history(maxiter: int, batch: int, device) -> torch.Tensor:
    """NaN-filled (maxiter, batch) relative-residual history."""
    return torch.full((maxiter, batch), math.nan, dtype=torch.float32,
                      device=device)


@dataclasses.dataclass(frozen=True)
class LinearOperator:
    """Matvec-only view of a matrix: ``matvec(v, key)`` maps (n, batch) to
    (m, batch) on ``device``; ``rmatvec(u, key)``, where there is one, maps
    (m, batch) to (n, batch) through the transposed MVM against the same
    image, billed per call at ``input_stats_t``."""

    matvec: Callable[[torch.Tensor, int], torch.Tensor]
    shape: Tuple[int, int]
    write_stats: WriteStats                      # one-time programming cost
    input_stats: Callable[[int], WriteStats]     # per-MVM cost, fn of batch
    dense: Optional[Callable[[], torch.Tensor]]  # digital reconstruction
    analog: bool
    device: torch.device
    rmatvec: Optional[Callable[[torch.Tensor, int], torch.Tensor]] = None
    input_stats_t: Optional[Callable[[int], WriteStats]] = None

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def T(self) -> "LinearOperator":
        """The transposed operator (matvec/rmatvec and shapes swapped); it
        shares the parent's write_stats."""
        if self.rmatvec is None:
            raise ValueError("operator has no rmatvec; cannot transpose")
        dense = self.dense
        return LinearOperator(
            matvec=self.rmatvec, rmatvec=self.matvec,
            shape=(self.shape[1], self.shape[0]),
            write_stats=self.write_stats,
            input_stats=self.input_stats_t or self.input_stats,
            input_stats_t=self.input_stats,
            dense=(lambda: dense().T) if dense is not None else None,
            analog=self.analog, device=self.device)


def _zero_stats(_batch: int = 1) -> WriteStats:
    return WriteStats.zero()


def as_operator(A, *, shape: Optional[Tuple[int, int]] = None,
                rmatvec: Optional[Callable] = None,
                device=None) -> LinearOperator:
    """Adapt ``A`` into a :class:`LinearOperator`.

    ``A`` may be an :class:`AnalogMatrix` (runs on its engine's device;
    ``rmatvec`` is its transposed execution), a
    :class:`~repro_torch.engine.TransposedAnalogMatrix` view (``A.T``:
    matvec and rmatvec swapped), a dense tensor (exact digital matvec and
    ``a.T @ u`` on ``device``, default the tensor's own), a numpy array or
    nested list (on ``device``, default ``"cuda"``), or a callable
    ``matvec(v, key)`` with ``shape=(m, n)`` and optionally ``rmatvec=``
    (on ``device``, default ``"cuda"``).
    """
    if isinstance(A, LinearOperator):
        return A
    if isinstance(A, TransposedAnalogMatrix):
        return as_operator(A.parent).T
    if isinstance(A, AnalogMatrix):
        # A solve holds an attached AgeLedger fixed (advance_age=False), as
        # the reference's jitted solve does; wrappers bill its MVMs after.
        eng = A.engine
        return LinearOperator(
            matvec=lambda v, k: eng.mvm(A, v, key=k, advance_age=False),
            rmatvec=lambda u, k: eng.rmvm(A, u, key=k, advance_age=False),
            shape=A.shape,
            write_stats=A.write_stats,
            input_stats=lambda batch: eng.input_write_stats(A, batch),
            input_stats_t=lambda batch: eng.input_write_stats(
                A, batch, transpose=True),
            dense=A.dense, analog=True, device=eng.device)
    if callable(A) and not hasattr(A, "shape"):
        if shape is None:
            raise ValueError("as_operator(matvec, ...) requires shape=(m, n)")
        return LinearOperator(matvec=A, rmatvec=rmatvec, shape=tuple(shape),
                              write_stats=WriteStats.zero(),
                              input_stats=_zero_stats, dense=None,
                              analog=False,
                              device=torch.device(device or "cuda"))
    if isinstance(A, torch.Tensor):
        a = A.to(device=device or A.device, dtype=torch.float32)
    else:   # numpy array or list: carries no device
        a = torch.as_tensor(np.asarray(A, dtype=np.float32),
                            device=torch.device(device or "cuda"))
    if a.ndim != 2:
        raise ValueError(f"expected a matrix, got shape {tuple(a.shape)}")
    return LinearOperator(matvec=lambda v, _k: a @ v,
                          rmatvec=lambda u, _k: a.T @ u, shape=tuple(a.shape),
                          write_stats=WriteStats.zero(),
                          input_stats=_zero_stats, dense=lambda: a,
                          analog=False, device=a.device)


def as_panel(v, device) -> Tuple[torch.Tensor, bool]:
    """(n, batch) float32 panel of ``v`` on ``device`` and whether ``v`` was a
    vector."""
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(np.ascontiguousarray(v))
    v = torch.as_tensor(v).to(device=device, dtype=torch.float32)
    squeeze = v.ndim == 1
    return (v[:, None] if squeeze else v).contiguous(), squeeze


@dataclasses.dataclass(frozen=True)
class SolveLedger:
    """Energy/latency split of one solve under the program-once model:
    ``write_stats`` once, ``mvms`` full-batch MVMs at ``input_stats`` and
    ``mvms_single`` batch-1 setup MVMs (power iteration) at
    ``input_stats_single``; transposed MVMs against the same image are
    ``mvms_t`` at ``input_stats_t`` and ``mvms_single_t`` at
    ``input_stats_single_t`` (each rate defaults to its forward twin)."""

    write_stats: WriteStats
    input_stats: WriteStats
    mvms: int
    input_stats_single: Optional[WriteStats] = None
    mvms_single: int = 0
    input_stats_t: Optional[WriteStats] = None
    mvms_t: int = 0
    input_stats_single_t: Optional[WriteStats] = None
    mvms_single_t: int = 0

    @property
    def write_energy_j(self) -> float:
        return float(self.write_stats.energy_j)

    def _rates(self):
        single = self.input_stats_single or self.input_stats
        transposed = self.input_stats_t or self.input_stats
        single_t = self.input_stats_single_t or transposed
        return ((self.input_stats, self.mvms), (single, self.mvms_single),
                (transposed, self.mvms_t), (single_t, self.mvms_single_t))

    @property
    def iteration_energy_j(self) -> float:
        return sum(float(rate.energy_j) * count
                   for rate, count in self._rates())

    @property
    def total_energy_j(self) -> float:
        return self.write_energy_j + self.iteration_energy_j

    @property
    def total_latency_s(self) -> float:
        return float(self.write_stats.latency_s) + sum(
            float(rate.latency_s) * count for rate, count in self._rates())


@dataclasses.dataclass
class SolveResult:
    """What every solver returns (see :class:`repro.solvers.SolveResult`).

    ``residuals`` is the per-iteration relative residual ``||r_k|| / ||b||``
    (least squares: the normal-equations residual; PDHG: the KKT residual),
    (maxiter,) for a vector RHS or (maxiter, batch); entries past
    ``iterations`` are NaN.  ``initial_residual`` is the worst-column
    relative residual at entry (NaN for solvers without an init MVM).
    ``dual`` is PDHG's dual variable y (None for the other solvers);
    ``restores`` the checkpoint rollbacks of a fault-tolerant wrapper
    (``ft_cg`` / ``ft_pdhg``, which also set ``fault_events``);
    ``eigenvalues`` the eigen solvers' estimates, ascending, matching the
    columns of ``x`` (None for the other solvers).
    """

    x: torch.Tensor
    residuals: torch.Tensor
    iterations: int
    converged: bool
    ledger: SolveLedger
    solver: str
    initial_residual: float = float("nan")
    dual: Optional[torch.Tensor] = None
    # Checkpoint restores a fault-tolerant wrapper made to finish this solve
    # (repro_torch.reliability.ft_solve); 0 for a clean run.
    restores: int = 0
    eigenvalues: Optional[torch.Tensor] = None

    @property
    def final_residual(self) -> float:
        """Worst-column relative residual at the last recorded iteration (the
        entry residual when the solve converged before iterating)."""
        if self.iterations == 0:
            return self.initial_residual
        r = self.residuals if self.residuals.ndim == 2 \
            else self.residuals[:, None]
        row = r[self.iterations - 1]
        if bool(torch.all(torch.isnan(row))):
            return float("nan")
        return float(torch.max(row[~torch.isnan(row)]))

    def __repr__(self) -> str:  # keep large tensors out of logs
        b = self.residuals.shape[1] if self.residuals.ndim == 2 else 1
        return (f"SolveResult(solver={self.solver!r}, n={self.x.shape[0]}, "
                f"batch={b}, iterations={self.iterations}, "
                f"converged={self.converged}, "
                f"final_residual={self.final_residual:.3e}, "
                f"mvms={self.ledger.mvms}, "
                f"energy_j={self.ledger.total_energy_j:.3e})")


def pack_result(op: LinearOperator, solver: str, x: torch.Tensor,
                hist: torch.Tensor, iterations: int, mvms: int, tol: float,
                squeeze: bool, mvms_single: int = 0,
                rel0: Optional[torch.Tensor] = None, mvms_t: int = 0,
                mvms_single_t: int = 0) -> SolveResult:
    """Assemble a :class:`SolveResult`.  ``mvms_t`` / ``mvms_single_t`` are
    the full-batch / batch-1 transposed MVMs, billed at the transposed
    rates.  ``rel0`` (per-column relative residual at entry) makes
    iteration-0 convergence honest: a zero RHS or an exact ``x0`` reports
    ``converged=True`` with ``final_residual == rel0`` instead of
    ``False``."""
    batch = x.shape[1]
    initial = float(torch.max(rel0)) if rel0 is not None else float("nan")
    stats_t = op.input_stats_t or op.input_stats
    res = SolveResult(
        x=x[:, 0] if squeeze else x,
        residuals=hist[:, 0] if squeeze else hist,
        iterations=int(iterations),
        converged=False,
        ledger=SolveLedger(write_stats=op.write_stats,
                           input_stats=op.input_stats(batch),
                           mvms=int(mvms),
                           input_stats_single=op.input_stats(1),
                           mvms_single=int(mvms_single),
                           input_stats_t=stats_t(batch),
                           mvms_t=int(mvms_t),
                           input_stats_single_t=stats_t(1),
                           mvms_single_t=int(mvms_single_t)),
        solver=solver,
        initial_residual=initial,
    )
    # A NaN final residual compares False and stays not-converged.
    res.converged = bool(res.final_residual <= tol)
    return res
