"""Benchmark matrices (numpy half of :mod:`repro.core.matrices`, copied).

Surrogates with the published dimensions and condition numbers of the
paper's SuiteSparse matrices (Supplementary Table 2).  Pure numpy, so both
packages build the same matrix from the same seed.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = [
    "make_spd_with_condition",
    "make_iperturb",
    "PAPER_MATRICES",
    "paper_matrix",
]


def make_spd_with_condition(n: int, kappa: float, seed: int = 0,
                            norm2: float = 1.0) -> np.ndarray:
    """Symmetric positive-definite n x n with condition number ~= kappa."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.geomspace(norm2 / kappa, norm2, n)
    return (q * lam) @ q.T


def make_iperturb(n: int, scale: float = 0.05, seed: int = 1) -> np.ndarray:
    """The paper's Iperturb: identity + small perturbation, kappa ~= 1.23."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((n, n)) * scale / np.sqrt(n)
    return np.eye(n) + 0.5 * (p + p.T)


# Supplementary Table 2: (dim, kappa, ||A||_2).  Dubcova2's stats are not
# published; Dubcova1's conditioning is the surrogate target.
_PAPER_SPECS: Dict[str, Tuple[int, float, float]] = {
    "bcsstk02": (66, 4.324971e3, 1.822575e4),
    "wang2": (2903, 2.305543e4, 4.138078),
    "add32": (4960, 1.366769e2, 5.749318e-2),
    "c-38": (8127, 1.530683e4, 6.083484e2),
    "dubcova1": (16129, 9.971199, 4.796329),
    "helm3d01": (32226, 2.451897e5, 5.052177e-1),
    "dubcova2": (65025, 9.971199, 4.796329),
}
PAPER_MATRICES = dict(_PAPER_SPECS)


def paper_matrix(name: str, seed: int = 0) -> np.ndarray:
    """Materialize a surrogate of a published matrix (small/medium sizes)."""
    key = name.lower()
    if key == "iperturb":
        return make_iperturb(66)
    if key not in _PAPER_SPECS:
        raise KeyError(f"unknown paper matrix {name!r}")
    n, kappa, norm2 = _PAPER_SPECS[key]
    if n > 20000:
        raise ValueError(
            f"{name} ({n}^2) should not be materialized; the implicit banded "
            "producer is not ported yet (ROADMAP Queue A1)")
    return make_spd_with_condition(n, kappa, seed=seed, norm2=norm2)
