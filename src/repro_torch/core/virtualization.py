"""Virtualization layer (port of :mod:`repro.core.virtualization`).

Maps a matrix of any size onto a fixed ``R x C`` tile of ``r x c`` MCAs
(capacity ``(R*r) x (C*c)``): zero-pad to whole capacity blocks, cut into
blocks, reassign each MCA once per block.  Shape arithmetic and views only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "MCAGeometry",
    "zero_padding",
    "block_partition",
    "blocks_view",
    "generate_mat_chunks",
    "generate_vec_chunks",
    "reassemble",
    "reassignment_count",
]


@dataclasses.dataclass(frozen=True)
class MCAGeometry:
    """Physical system: R x C tile of MCAs, each r x c cells."""

    tile_rows: int = 8      # R
    tile_cols: int = 8      # C
    cell_rows: int = 512    # r
    cell_cols: int = 512    # c

    @property
    def capacity(self) -> Tuple[int, int]:
        return (self.tile_rows * self.cell_rows, self.tile_cols * self.cell_cols)

    @property
    def n_mcas(self) -> int:
        return self.tile_rows * self.tile_cols

    @property
    def cells_per_mca(self) -> int:
        return self.cell_rows * self.cell_cols


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def zero_padding(a: torch.Tensor, geom: MCAGeometry) -> torch.Tensor:
    """Pad a (m, n) matrix or (n,) vector up to whole-capacity multiples."""
    cap_m, cap_n = geom.capacity
    if a.ndim == 1:
        return F.pad(a, (0, _ceil_to(a.shape[0], cap_n) - a.shape[0]))
    m, n = a.shape
    return F.pad(a, (0, _ceil_to(n, cap_n) - n, 0, _ceil_to(m, cap_m) - m))


def blocks_view(a_pad: torch.Tensor, geom: MCAGeometry) -> torch.Tensor:
    """(mb, nb, cap_m, cap_n) block view of an already padded (M, N) matrix:
    no copy, block [i, j] aliases rows ``i*cap_m:`` and columns ``j*cap_n:``."""
    cap_m, cap_n = geom.capacity
    m, n = a_pad.shape
    if m % cap_m or n % cap_n:
        raise ValueError(f"{tuple(a_pad.shape)} is not a multiple of the "
                         f"capacity {geom.capacity}")
    return a_pad.view(m // cap_m, cap_m, n // cap_n, cap_n).permute(0, 2, 1, 3)


def block_partition(a: torch.Tensor, geom: MCAGeometry) -> torch.Tensor:
    """blockPartition (Alg. 3): padded (mb, nb, cap_m, cap_n) blocks."""
    return blocks_view(zero_padding(a, geom), geom)


def generate_mat_chunks(a: torch.Tensor, geom: MCAGeometry) -> torch.Tensor:
    """generateMatChunksSet (Alg. 8): blocks -> per-MCA chunks, shape
    (mb, nb, R, C, r, c): block [i, j], MCA [p, q], cells [l, h]."""
    blocks = block_partition(a, geom)
    mb, nb = blocks.shape[:2]
    return blocks.reshape(mb, nb, geom.tile_rows, geom.cell_rows,
                          geom.tile_cols, geom.cell_cols) \
        .permute(0, 1, 2, 4, 3, 5)


def generate_vec_chunks(x: torch.Tensor, geom: MCAGeometry) -> torch.Tensor:
    """generateVecChunksSet (Alg. 9): x -> (nb, C, c) chunks matching the
    column blocks."""
    x = zero_padding(x, geom)
    return x.reshape(-1, geom.tile_cols, geom.cell_cols)


def reassemble(y_blocks: torch.Tensor, m: int) -> torch.Tensor:
    """(mb, cap_m) column-summed block outputs -> the first ``m`` entries."""
    return y_blocks.reshape(-1)[:m]


def reassignment_count(m: int, n: int, geom: MCAGeometry) -> int:
    """How many times each physical MCA is (re)assigned for an (m, n) problem."""
    cap_m, cap_n = geom.capacity
    return math.ceil(m / cap_m) * math.ceil(n / cap_n)
