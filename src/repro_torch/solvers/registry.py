"""The solver registry: one metadata record per solver (port of
:mod:`repro.solvers.registry`).

Every solver declares in one place how to build a random problem it should
solve, how to run it, and how to recompute digitally the residual it
reports, so one contract suite can hold all of them to the same four
invariants: residual honesty (the recorded ``final_residual`` tracks the
digital recompute), ``converged <=> final_residual <= tol``, iteration-0
honesty on trivial problems, and the ledger's arithmetic.

Each :class:`SolverSpec` works on problem dicts of tensors,

  ``{"a": dense matrix, "b": rhs, ...family extras...}``

built by ``spec.make_problem(seed, n, batch, cond, device=)`` (SPD for the
linear and eigen families, rectangular for least squares, LP / QP with
known optima for the primal-dual families) and ``spec.make_trivial(n,
batch, device=)`` (the zero-RHS instance for entry honesty; ``None`` when
the family has none).  ``spec.solve(A, problem, tol=, maxiter=, key=)``
takes the operator apart from the problem, so a programmed image can stand
in for the dense ``a``.  The makers draw from ``torch.Generator``s keyed
``fold_in(seed, i)`` on ``device`` (default ``"cuda"``), not from
``jax.random``: tests carry the reference's problems across as arrays.
The adapters pass no solver ``backend=``, as the reference's do.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from ..core.crossbar import CrossbarConfig
from ..core.devices import get_device
from ..core.prng import fold_in, generator
from ..core.virtualization import MCAGeometry
from .admm import admm, random_box_qp
from .base import col_norms
from .eigen import lanczos, lobpcg
from .krylov import bicgstab, cg, gmres
from .lstsq import lsmr, lsqr
from .pdhg import pdhg, random_feasible_lp
from .refinement import refine
from .stationary import jacobi, richardson

__all__ = ["RUN", "SolverSpec", "contract_config", "registry"]

_TINY = 1e-30

# The contract suite's run budget for each family (the reference suite's
# ``RUN``, tests/test_solver_contracts.py).
RUN = {
    "linear": dict(tol=1e-5, maxiter=400),
    "lstsq": dict(tol=1e-5, maxiter=200),
    "lp": dict(tol=1e-4, maxiter=6000),
    "qp": dict(tol=1e-4, maxiter=2000),
    "eigen": dict(tol=1e-3, maxiter=32),
}


def contract_config(n: int, cell: int = 32) -> CrossbarConfig:
    """The contract suite's analog configuration (epiram, EC on, k = 5),
    with a grid of ``cell``-square MCAs covering an (n, n) matrix."""
    tiles = max(n // (2 * cell), 1)
    return CrossbarConfig(device=get_device("epiram"),
                          geom=MCAGeometry(tiles, tiles, cell, cell),
                          k_iters=5, ec=True)


def _panel(v: torch.Tensor) -> torch.Tensor:
    return v if v.ndim == 2 else v[:, None]


def _normal(seed: int, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator(seed, device),
                       device=device, dtype=torch.float32)


# --------------------------------------------------------------------------- #
# Problem makers
# --------------------------------------------------------------------------- #

def _spd(seed: int, n: int, cond: float = 50.0, *,
         device="cuda") -> torch.Tensor:
    """Random SPD with eigenvalues log-spaced over ``cond`` (a rotated
    diagonal, so the conditioning is exact, not a sample statistic)."""
    q, _ = torch.linalg.qr(_normal(seed, (n, n), device))
    lam = torch.logspace(0.0, math.log10(cond), n, dtype=torch.float32,
                         device=device)
    return (q * lam[None, :]) @ q.T


def _linear_problem(seed: int, n: int, batch: int, cond: float = 50.0, *,
                    device="cuda"):
    return {"a": _spd(fold_in(seed, 0), n, cond, device=device),
            "b": _normal(fold_in(seed, 1), (n, batch), device)}


def _linear_trivial(n: int, batch: int, *, device="cuda"):
    return {"a": torch.eye(n, dtype=torch.float32, device=device) * 2.0,
            "b": torch.zeros(n, batch, dtype=torch.float32, device=device)}


def _diag_dominant_problem(seed: int, n: int, batch: int,
                           cond: float = 50.0, *, device="cuda"):
    """Jacobi needs strict diagonal dominance, not just SPD."""
    off = _normal(fold_in(seed, 0), (n, n), device) / float(n)
    a = 0.5 * (off + off.T) + torch.eye(n, dtype=torch.float32,
                                        device=device) * 2.0
    return {"a": a, "b": _normal(fold_in(seed, 1), (n, batch), device)}


def _lstsq_rows(n: int) -> int:
    return n + max(n // 2, 4)


def _lstsq_problem(seed: int, n: int, batch: int, cond: float = 50.0, *,
                   device="cuda"):
    """Rectangular m > n with singular values log-spaced over sqrt(cond)
    (the normal equations then see ``cond``), plus an inconsistent RHS."""
    m = _lstsq_rows(n)
    u, _ = torch.linalg.qr(_normal(fold_in(seed, 0), (m, n), device))
    v, _ = torch.linalg.qr(_normal(fold_in(seed, 2), (n, n), device))
    sig = torch.logspace(0.0, 0.5 * math.log10(cond), n,
                         dtype=torch.float32, device=device)
    return {"a": (u * sig[None, :]) @ v.T,
            "b": _normal(fold_in(seed, 1), (m, batch), device)}


def _stacked_eye(n: int, device) -> torch.Tensor:
    """``[I; ones]`` of the least-squares shape."""
    m = _lstsq_rows(n)
    return torch.cat([torch.eye(n, dtype=torch.float32, device=device),
                      torch.ones(m - n, n, dtype=torch.float32,
                                 device=device)])


def _lstsq_trivial(n: int, batch: int, *, device="cuda"):
    return {"a": _stacked_eye(n, device),
            "b": torch.zeros(_lstsq_rows(n), batch, dtype=torch.float32,
                             device=device)}


def _lp_problem(seed: int, n: int, batch: int, cond: float = 50.0, *,
                device="cuda"):
    a, b, c, x_star, y_star = random_feasible_lp(seed, max(n // 2, 2), n,
                                                 batch, device=device)
    return {"a": a, "b": b, "c": c, "x_star": x_star, "y_star": y_star}


def _lp_trivial(n: int, batch: int, *, device="cuda"):
    m = max(n // 2, 2)
    return {"a": torch.eye(m, n, dtype=torch.float32, device=device),
            "b": torch.zeros(m, batch, dtype=torch.float32, device=device),
            "c": torch.zeros(n, batch, dtype=torch.float32, device=device)}


def _qp_problem(seed: int, n: int, batch: int, cond: float = 50.0, *,
                device="cuda"):
    a, b, q, lo, hi, x_star = random_box_qp(seed, _lstsq_rows(n), n, batch,
                                            device=device)
    return {"a": a, "b": b, "q": q, "lo": lo, "hi": hi, "x_star": x_star}


def _qp_trivial(n: int, batch: int, *, device="cuda"):
    return {"a": _stacked_eye(n, device),
            "b": torch.zeros(_lstsq_rows(n), batch, dtype=torch.float32,
                             device=device),
            "q": torch.zeros(n, batch, dtype=torch.float32, device=device),
            "lo": -torch.ones(n, dtype=torch.float32, device=device),
            "hi": torch.ones(n, dtype=torch.float32, device=device)}


def _eigen_problem(seed: int, n: int, batch: int, cond: float = 50.0, *,
                   device="cuda"):
    return {"a": _spd(seed, n, cond, device=device)}


def _eigen_trivial(n: int, batch: int, *, device="cuda"):
    # Every vector of the identity is an eigenvector: any starting block is
    # exact, so a block method must report entry convergence.
    return {"a": torch.eye(n, dtype=torch.float32, device=device)}


# --------------------------------------------------------------------------- #
# Digital residual recomputation (the contract's ground truth)
# --------------------------------------------------------------------------- #

def _recompute_linear(problem, result) -> float:
    a, b = problem["a"], _panel(problem["b"])
    x = _panel(result.x)
    rel = col_norms(b - a @ x) / torch.clamp(col_norms(b), min=_TINY)
    return float(torch.max(rel))


def _recompute_lstsq(problem, result) -> float:
    a, b = problem["a"], _panel(problem["b"])
    x = _panel(result.x)
    num = col_norms(a.T @ (b - a @ x))
    den = torch.clamp(col_norms(a.T @ b), min=_TINY)
    return float(torch.max(num / den))


def _recompute_lp(problem, result) -> float:
    """PDHG's KKT residual, digitally: the max of primal and dual
    infeasibility and the relative duality gap at (result.x, result.dual)."""
    a = problem["a"]
    b, c = _panel(problem["b"]), _panel(problem["c"])
    x = _panel(result.x)
    y = _panel(result.dual)
    primal = col_norms(a @ x - b) / (1.0 + col_norms(b))
    dual = col_norms(torch.clamp(-(c + a.T @ y), min=0.0)) \
        / (1.0 + col_norms(c))
    pobj = torch.sum(c * x, dim=0)
    dobj = -torch.sum(b * y, dim=0)
    gap = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj) + torch.abs(dobj))
    return float(torch.max(torch.maximum(torch.maximum(primal, dual), gap)))


def _recompute_qp(problem, result) -> float:
    """ADMM's KKT measure, digitally: projected-gradient stationarity plus
    the consensus gap to the feasible split copy in ``result.dual``."""
    a = problem["a"]
    b, q = _panel(problem["b"]), _panel(problem["q"])
    lo, hi = problem["lo"][:, None], problem["hi"][:, None]
    x = _panel(result.x)
    z = _panel(result.dual)
    grad = a.T @ (a @ x - b) + q
    stat = col_norms(x - torch.clamp(x - grad, lo, hi))
    feas = col_norms(x - z)
    return float(torch.max((stat + feas) / (1.0 + col_norms(x))))


def _recompute_eigen(problem, result) -> float:
    """Relative Ritz residual of every returned (eigenvalue, column) pair."""
    a = problem["a"]
    x = _panel(result.x)
    theta = result.eigenvalues
    resid = col_norms(a @ x - x * theta[None, :])
    return float(torch.max(resid / torch.clamp(torch.abs(theta), min=_TINY)))


# --------------------------------------------------------------------------- #
# Spec + registry
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """Everything the contract and parity suites need to run one solver.

    ``solve(A, problem, *, tol, maxiter, key)`` runs the solver with ``A``
    standing in for ``problem["a"]`` (the dense tensor in the digital
    contracts, a programmed handle elsewhere).  ``recompute(problem,
    result)`` is the family's residual evaluated digitally at the returned
    iterates, the quantity the recorded ``final_residual`` must track:
    ``recompute <= max(slack * recorded, floor)`` (``floor`` absorbs the
    float32 noise floor once a recurrence has converged below what a
    digital recompute resolves).
    """

    name: str
    family: str                 # linear | lstsq | lp | qp | eigen
    solve: Callable
    make_problem: Callable
    recompute: Callable
    make_trivial: Optional[Callable] = None
    needs_rmatvec: bool = False
    multi_rhs: bool = True
    slack: float = 3.0
    floor: float = 5e-4
    # Residuals recorded one step behind the returned iterate (the
    # stationary methods) get a one-sided comparison.
    lagged_history: bool = False


def _s_richardson(A, p, *, tol, maxiter, key):
    return richardson(A, p["b"], tol=tol, maxiter=maxiter, key=key)


def _s_jacobi(A, p, *, tol, maxiter, key):
    return jacobi(A, p["b"], tol=tol, maxiter=maxiter, key=key,
                  diag=torch.diagonal(p["a"]))


def _s_cg(A, p, *, tol, maxiter, key):
    return cg(A, p["b"], tol=tol, maxiter=maxiter, key=key)


def _s_bicgstab(A, p, *, tol, maxiter, key):
    return bicgstab(A, p["b"], tol=tol, maxiter=maxiter, key=key)


def _s_gmres(A, p, *, tol, maxiter, key):
    return gmres(A, p["b"], tol=tol, maxiter=maxiter, key=key)


def _s_refine(A, p, *, tol, maxiter, key):
    return refine(A, p["b"], tol=tol, maxiter=maxiter, key=key,
                  a_digital=p["a"])


def _s_pdhg(A, p, *, tol, maxiter, key):
    return pdhg(A, p["b"], p["c"], tol=tol, maxiter=maxiter, key=key)


def _s_lsqr(A, p, *, tol, maxiter, key):
    return lsqr(A, p["b"], tol=tol, maxiter=maxiter, key=key)


def _s_lsmr(A, p, *, tol, maxiter, key):
    return lsmr(A, p["b"], tol=tol, maxiter=maxiter, key=key)


def _s_lanczos(A, p, *, tol, maxiter, key):
    return lanczos(A, tol=tol, maxiter=max(maxiter, 2), key=key)


def _s_lobpcg(A, p, *, tol, maxiter, key):
    return lobpcg(A, 2, which="smallest", tol=tol, maxiter=maxiter, key=key)


def _s_admm(A, p, *, tol, maxiter, key):
    return admm(A, p["b"], p["q"], lo=p["lo"], hi=p["hi"], tol=tol,
                maxiter=maxiter, key=key)


_REGISTRY = (
    SolverSpec("richardson", "linear", _s_richardson, _linear_problem,
               _recompute_linear, lagged_history=True),
    SolverSpec("jacobi", "linear", _s_jacobi, _diag_dominant_problem,
               _recompute_linear, lagged_history=True),
    SolverSpec("cg", "linear", _s_cg, _linear_problem, _recompute_linear,
               make_trivial=_linear_trivial),
    SolverSpec("bicgstab", "linear", _s_bicgstab, _linear_problem,
               _recompute_linear, make_trivial=_linear_trivial),
    SolverSpec("gmres", "linear", _s_gmres, _linear_problem,
               _recompute_linear, make_trivial=_linear_trivial),
    SolverSpec("refine", "linear", _s_refine, _linear_problem,
               _recompute_linear, make_trivial=_linear_trivial),
    SolverSpec("pdhg", "lp", _s_pdhg, _lp_problem, _recompute_lp,
               make_trivial=_lp_trivial, needs_rmatvec=True),
    SolverSpec("lsqr", "lstsq", _s_lsqr, _lstsq_problem, _recompute_lstsq,
               make_trivial=_lstsq_trivial, needs_rmatvec=True),
    SolverSpec("lsmr", "lstsq", _s_lsmr, _lstsq_problem, _recompute_lstsq,
               make_trivial=_lstsq_trivial, needs_rmatvec=True),
    # The |beta_k s_k| estimate collapses once the Krylov space exhausts
    # (k ~ n) while float32 orthogonality loss keeps the true Ritz residual
    # near 1e-3: the honesty floor is the float32 Lanczos floor.
    SolverSpec("lanczos", "eigen", _s_lanczos, _eigen_problem,
               _recompute_eigen, multi_rhs=False, floor=5e-3),
    SolverSpec("lobpcg", "eigen", _s_lobpcg, _eigen_problem,
               _recompute_eigen, make_trivial=_eigen_trivial,
               multi_rhs=False),
    SolverSpec("admm", "qp", _s_admm, _qp_problem, _recompute_qp,
               make_trivial=_qp_trivial, needs_rmatvec=True),
)


def registry() -> tuple:
    """All registered solvers, in the reference's order.  The contract
    suite parametrizes over this tuple, so a solver added here is held to
    the residual, convergence and ledger invariants."""
    return _REGISTRY
