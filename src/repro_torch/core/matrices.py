"""Benchmark matrices (port of :mod:`repro.core.matrices`).

Surrogates with the published dimensions and condition numbers of the
paper's SuiteSparse matrices (Supplementary Table 2), pure numpy, so both
packages build the same matrix from the same seed.  For the strong-scaling
sizes (up to 65,025^2) :class:`ImplicitBandedMatrix` produces
capacity-sized blocks on demand so the matrix never materializes (fed to
``AnalogEngine(cfg, execution="streamed")``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .prng import fold_in, generator

__all__ = [
    "make_spd_with_condition",
    "make_iperturb",
    "PAPER_MATRICES",
    "paper_matrix",
    "ImplicitBandedMatrix",
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
            f"{name} ({n}^2) should not be materialized; use "
            "ImplicitBandedMatrix")
    return make_spd_with_condition(n, kappa, seed=seed, norm2=norm2)


@dataclasses.dataclass(frozen=True)
class ImplicitBandedMatrix:
    """Procedurally generated banded-plus-noise matrix for huge problems.

    A = diagonally dominant band + seeded pseudo-random texture within three
    bandwidths of the diagonal, defined blockwise: :meth:`block` returns the
    ``(cap_m, cap_n)`` block at block index (i, j) on ``device`` without
    ever forming A.  Deterministic in (seed, i, j): the texture of block
    (i, j) is drawn from ``fold_in(fold_in(seed, i), j)``.
    """

    n: int
    cap_m: int
    cap_n: int
    seed: int = 0
    bandwidth: int = 8
    diag: float = 4.0
    device: Union[str, torch.device] = "cuda"

    def _grid(self) -> Tuple[int, int]:
        return -(-self.n // self.cap_m), -(-self.n // self.cap_n)

    def block(self, i: int, j: int, *,
              eta: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Block (i, j), float32 on ``device``.  ``eta`` ((cap_m, cap_n))
        replaces the texture draw.

        The reference's operations in its order: ``0.05 * eta``, masked to
        ``|row - col| <= 3 * bandwidth``, plus ``1 / (1 + |row - col|)``
        within the bandwidth, plus ``diag`` on the diagonal, zero outside
        ``(n, n)``.  A block that lies wholly outside three bandwidths of
        the diagonal, or outside ``(n, n)``, is zero and draws nothing.
        """
        i, j = int(i), int(j)
        dev = torch.device(self.device)
        cm, cn, bw = self.cap_m, self.cap_n, self.bandwidth
        r0, c0 = i * cm, j * cn
        gap = max(0, c0 - (r0 + cm - 1), r0 - (c0 + cn - 1))
        if gap > 3 * bw or r0 >= self.n or c0 >= self.n:
            return torch.zeros(cm, cn, dtype=torch.float32, device=dev)
        if eta is None:
            blk = torch.randn(cm, cn, generator=generator(
                fold_in(fold_in(self.seed, i), j), dev), device=dev)
            blk.mul_(0.05)
        else:
            blk = torch.as_tensor(eta, dtype=torch.float32, device=dev) * 0.05
        # |row - col| from broadcast int32 aranges: one int32 block, and the
        # masks and the band are made in place over it and one float block.
        rows = torch.arange(r0, r0 + cm, dtype=torch.int32, device=dev)
        cols = torch.arange(c0, c0 + cn, dtype=torch.int32, device=dev)
        dist = (rows[:, None] - cols[None, :]).abs_()
        blk.mul_(dist <= 3 * bw)
        band = dist.to(torch.float32).add_(1.0).reciprocal_()
        band.masked_fill_(dist > bw, 0.0)
        del dist
        blk.add_(band)
        del band
        blk.diagonal(r0 - c0).add_(self.diag)
        blk[max(0, self.n - r0):].zero_()
        blk[:, max(0, self.n - c0):].zero_()
        return blk

    def matvec(self, x) -> torch.Tensor:
        """Exact blockwise ground truth A @ x, in float32 as the reference
        computes it."""
        mb, nb = self._grid()
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        xc = F.pad(x, (0, nb * self.cap_n - self.n)).view(nb, self.cap_n)
        out = []
        for i in range(mb):
            acc = torch.zeros(self.cap_m, dtype=torch.float32,
                              device=x.device)
            for j in range(nb):
                acc = acc + self.block(i, j) @ xc[j]
            out.append(acc)
        return torch.cat(out)[:self.n]

    def rmatvec(self, y) -> torch.Tensor:
        """Exact blockwise ground truth A.T @ y (the transposed-MVM
        oracle)."""
        mb, nb = self._grid()
        y = torch.as_tensor(y, dtype=torch.float32, device=self.device)
        yc = F.pad(y, (0, mb * self.cap_m - self.n)).view(mb, self.cap_m)
        out = []
        for j in range(nb):
            acc = torch.zeros(self.cap_n, dtype=torch.float32,
                              device=y.device)
            for i in range(mb):
                acc = acc + self.block(i, j).T @ yc[i]
            out.append(acc)
        return torch.cat(out)[:self.n]
