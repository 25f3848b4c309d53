"""Multi-MCA crossbar simulation, local stages (port of :mod:`repro.core.crossbar`).

The program-once dataflow in two stages: :func:`program_blocks` encodes the
zero-padded matrix one capacity block at a time (per-MCA-tile quantization
plus residual programming noise) and keeps ``A_tilde`` and ``dA = A - A_tilde``;
:func:`programmed_block_mvm` executes a corrected MVM against that image with
only the input vector passing through the DAC, and
:func:`programmed_block_rmvm` the transposed ``A.T @ y`` against the same
image.

Layout: the image lives as two dense padded ``(Mp, Np)`` float32 tensors;
the ``(mb, nb, cap_m, cap_n)`` block layout of the reference is a view
(:func:`repro_torch.core.virtualization.blocks_view`), never a second copy.
Keys and generators follow :mod:`repro_torch.core.prng`.  Every noisy stage
takes an optional pre-drawn ``eta`` so tests can inject the reference's
draws.

Write-cost accounting is the reference's analytic model, pure Python.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .devices import DeviceModel, apply_noise, effective_sigma, \
    effective_sigma_py, quantize
from .error_correction import denoise_least_square
from .prng import block_key, fold_in, generator
from .virtualization import MCAGeometry, blocks_view
from .write_verify import WriteStats

__all__ = [
    "CrossbarConfig",
    "encode_tiled",
    "write_cost",
    "matrix_write_cost",
    "input_write_cost",
    "tile_write_cost",
    "assemble_blocks",
    "program_blocks",
    "programmed_block_mvm",
    "programmed_block_rmvm",
]


@dataclasses.dataclass(frozen=True)
class CrossbarConfig:
    """Everything needed to run one corrected MVM on a multi-MCA system."""

    device: DeviceModel
    geom: MCAGeometry = MCAGeometry()
    k_iters: int = 5                    # fixed write-verify iterations
    ec: bool = True                     # two-tier error correction on/off
    ec_mode: str = "fused"              # "faithful" (3 products) | "fused" (2)
    denoise_method: str = "neumann"     # "dense" | "thomas" | "neumann"
    lam: float = 1e-12
    h: float = -1.0
    encode_inputs: bool = True          # inputs (x) also pass through the DAC
    skip_zero_pad_writes: bool = False  # don't bill all-zero padding writes


# --------------------------------------------------------------------------- #
# Encoding
# --------------------------------------------------------------------------- #

def encode_tiled(a: torch.Tensor, cfg: CrossbarConfig, *,
                 gen: Optional[torch.Generator] = None,
                 eta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encode a padded (M, N) matrix with per-MCA-tile quantization scales.

    Each (r x c) tile gets its own max-abs scale, quantization to the
    device's levels and residual noise after ``k_iters`` verify passes.
    ``eta`` (any shape with M*N elements, row-major) replaces the draw from
    ``gen``.
    """
    r_, c_ = cfg.geom.cell_rows, cfg.geom.cell_cols
    m, n = a.shape
    if m % r_ or n % c_:
        raise ValueError(f"{tuple(a.shape)} is not a multiple of the cell "
                         f"size {(r_, c_)}")
    tiles = a.reshape(m // r_, r_, n // c_, c_)
    q = quantize(tiles, cfg.device.levels, axis=(1, 3))
    sigma = effective_sigma(cfg.device, cfg.k_iters)
    return apply_noise(q, sigma, gen=gen, eta=eta).reshape(m, n)


def _encode_vec(x: torch.Tensor, cfg: CrossbarConfig, *,
                gen: Optional[torch.Generator] = None,
                eta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The input DAC pass: ONE max-abs scale over the whole ``(n, batch)``
    panel, then residual noise."""
    q = quantize(x, cfg.device.levels, axis=None)
    sigma = effective_sigma(cfg.device, cfg.k_iters)
    return apply_noise(q, sigma, gen=gen, eta=eta)


# --------------------------------------------------------------------------- #
# Analytic write cost (paper Figs. 2-5 accounting), pure Python
# --------------------------------------------------------------------------- #

def write_cost(m: int, n: int, cfg: CrossbarConfig, batch: int = 1, *,
               include_matrix: bool = True,
               include_inputs: bool = True,
               transpose: bool = False) -> WriteStats:
    """Analytic write energy/latency for one corrected MVM of an (m, n) problem.

    The matrix part (programming the image, paid once) and the input part
    (the x DAC write plus the EC X^T replica, per call and per column) are
    selected by the ``include_*`` switches; :func:`matrix_write_cost` and
    :func:`input_write_cost` are the named halves.  ``transpose=True`` bills
    the input part of ``A.T @ y``: the DAC vector has the padded row count
    and the EC replica is r x r per MCA assignment instead of c x c; the
    matrix part is the same image, never paid again.
    """
    dev, geom = cfg.device, cfg.geom
    cap_m, cap_n = geom.capacity
    mb = -(-m // cap_m)
    nb = -(-n // cap_n)
    reass = mb * nb
    passes = float(cfg.k_iters + 1)

    energy = 0.0
    latency = 0.0
    if include_matrix:
        if cfg.skip_zero_pad_writes:
            cells_a = float(m) * float(n)
            rows_a_per_mca = reass * min(geom.cell_rows, max(1, m))
        else:
            cells_a = float(mb * cap_m) * float(nb * cap_n)
            rows_a_per_mca = reass * geom.cell_rows
        energy += cells_a * dev.e_write
        latency += rows_a_per_mca * dev.t_write

    c_ = geom.cell_rows if transpose else geom.cell_cols
    n_pad = mb * cap_m if transpose else nb * cap_n
    if include_inputs:
        if cfg.encode_inputs:
            energy += float(n_pad) * batch * dev.e_write        # x vector write
            latency += 1.0 * batch * dev.t_write
        if cfg.ec:
            # The replicated X^T array (c x c per MCA assignment, paper sec. 2).
            energy += float(reass * geom.n_mcas) * (c_ * c_) * batch * dev.e_write
            latency += reass * c_ * batch * dev.t_write
    return WriteStats(
        energy_j=energy * passes,
        latency_s=latency * passes,
        iterations=cfg.k_iters,
        final_delta=effective_sigma_py(dev, cfg.k_iters),
    )


def matrix_write_cost(m: int, n: int, cfg: CrossbarConfig) -> WriteStats:
    """One-time programming cost of the (m, n) conductance image."""
    return write_cost(m, n, cfg, include_inputs=False)


def tile_write_cost(cfg: CrossbarConfig) -> WriteStats:
    """Programming cost of ONE capacity block (cap_m x cap_n)."""
    cap_m, cap_n = cfg.geom.capacity
    return matrix_write_cost(cap_m, cap_n, cfg)


def input_write_cost(m: int, n: int, cfg: CrossbarConfig,
                     batch: int = 1, *, transpose: bool = False) -> WriteStats:
    """Per-execution cost: x-vector DAC write + EC X^T replica, per column
    (``transpose=True``: the m-length y pass and the row-dimension replica)."""
    return write_cost(m, n, cfg, batch=batch, include_matrix=False,
                      transpose=transpose)


# --------------------------------------------------------------------------- #
# Program stage / execute stage
# --------------------------------------------------------------------------- #

def assemble_blocks(image: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """The dense unpadded (m, n) view of a padded (Mp, Np) image."""
    return image[:m, :n]


def program_blocks(a: torch.Tensor, key: int, cfg: CrossbarConfig, *,
                   eta: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Program stage: encode ``a`` onto the (virtual) MCAs, once.

    Returns the padded ``(A_tilde, dA)`` images, each ``(Mp, Np)`` float32 on
    ``a``'s device.  Blocks are encoded one at a time, so the peak memory is
    ``a`` + the two images + O(one capacity block).  Block (I, J) draws from
    ``fold_in(block_key(key, I, J), 0)``; ``eta`` of shape
    ``(mb, nb, cap_m, cap_n)`` replaces those draws.
    """
    m, n = a.shape
    cap_m, cap_n = cfg.geom.capacity
    mb, nb = -(-m // cap_m), -(-n // cap_n)
    a = a.to(torch.float32)
    at = torch.empty(mb * cap_m, nb * cap_n, dtype=torch.float32,
                     device=a.device)
    da = torch.empty_like(at)
    at_b, da_b = blocks_view(at, cfg.geom), blocks_view(da, cfg.geom)
    for i in range(mb):
        for j in range(nb):
            src = a[i * cap_m:(i + 1) * cap_m, j * cap_n:(j + 1) * cap_n]
            blk = torch.zeros(cap_m, cap_n, dtype=torch.float32,
                              device=a.device)
            blk[:src.shape[0], :src.shape[1]] = src
            if eta is None:
                gen = generator(fold_in(block_key(key, i, j), 0), a.device)
                enc = encode_tiled(blk, cfg, gen=gen)
            else:
                enc = encode_tiled(blk, cfg, eta=eta[i, j])
            at_b[i, j] = enc
            da_b[i, j] = blk.sub_(enc)
    return at, da


def _block_product(at_blk: torch.Tensor, da_blk: torch.Tensor,
                   u: torch.Tensor, u_t: torch.Tensor, cfg: CrossbarConfig,
                   use_kernel: bool, transpose: bool) -> torch.Tensor:
    """Tier-1 product of one capacity block, forward (``A_tilde u + dA
    u_tilde``) or transposed (``A_tilde^T u + dA^T u_tilde``); ``ec=False``
    is the raw ``A_tilde u_tilde``."""
    if not cfg.ec:
        return (at_blk.T if transpose else at_blk) @ u_t
    if use_kernel:
        # The fused kernel on the block view itself (no copy of the block).
        from .. import kernels
        run = kernels.ec_rmatmul if transpose else kernels.ec_matmul
        return run(at_blk, da_blk, u, u_t)
    if transpose:
        at_blk, da_blk = at_blk.T, da_blk.T
    if cfg.ec_mode == "faithful":
        # The paper's three analog products, with A = A_tilde + dA.
        return at_blk @ u + (at_blk + da_blk) @ u_t - at_blk @ u_t
    return at_blk @ u + da_blk @ u_t


def _block_execute(at, da, ub, key, cfg, *, m, n, tier2, use_kernel, eta,
                   transpose):
    """The execute stage in either direction: the input is chunked along
    the contraction axis (columns forward, rows transposed), block (I, J)'s
    chunk passes the DAC with ``fold_in(block_key(key, I, J), 1)`` (or
    ``eta[I, J]``) in both directions, partials are summed over the
    contraction blocks and tier-2 runs on the assembled output."""
    if cfg.ec and cfg.ec_mode not in ("fused", "faithful"):
        raise ValueError(f"unknown first-order EC mode {cfg.ec_mode!r}")
    at_b, da_b = blocks_view(at, cfg.geom), blocks_view(da, cfg.geom)
    mb, nb, cap_m, cap_n = at_b.shape
    # (output blocks, contraction blocks, their sizes, true lengths)
    if transpose:
        n_out, n_in, cap_out, cap_in, len_out, len_in = nb, mb, cap_n, cap_m, n, m
    else:
        n_out, n_in, cap_out, cap_in, len_out, len_in = mb, nb, cap_m, cap_n, m, n
    batch = ub.shape[1]
    u_pad = torch.zeros(n_in * cap_in, batch, dtype=torch.float32,
                        device=at.device)
    u_pad[:len_in] = ub
    chunks = u_pad.view(n_in, cap_in, batch)
    outs = []
    for o in range(n_out):
        acc = torch.zeros(cap_out, batch, dtype=torch.float32, device=at.device)
        for c in range(n_in):
            i, j = (c, o) if transpose else (o, c)
            u_blk = chunks[c]
            if not cfg.encode_inputs:
                u_t = u_blk
            elif eta is None:
                gen = generator(fold_in(block_key(key, i, j), 1), at.device)
                u_t = _encode_vec(u_blk, cfg, gen=gen)
            else:
                u_t = _encode_vec(u_blk, cfg, eta=eta[i, j])
            acc += _block_product(at_b[i, j], da_b[i, j], u_blk, u_t, cfg,
                                  use_kernel, transpose)
        outs.append(acc)
    p = torch.cat(outs)[:len_out]
    if cfg.ec and tier2:
        p = denoise_least_square(p, lam=cfg.lam, h=cfg.h,
                                 method=cfg.denoise_method)
    return p


def programmed_block_mvm(at: torch.Tensor, da: torch.Tensor, xb: torch.Tensor,
                         key: int, cfg: CrossbarConfig, *, m: int, n: int,
                         tier2: bool = True, use_kernel: bool = False,
                         eta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Execute stage (the ``reference`` backend): corrected MVM against an
    already-programmed padded image, zero matrix-encode work.

    ``xb`` is (n, batch).  Each block's input chunk passes through its own
    DAC draw (``fold_in(block_key(key, I, J), 1)``; ``eta`` of shape
    ``(mb, nb, cap_n, batch)`` replaces the draws), tier-1 is assembled from
    the stored operands as ``p = A_tilde x + dA x_tilde``, column-block
    partials are summed and tier-2 runs on the assembled output
    (``tier2=False`` skips it).  ``use_kernel=True`` runs each block's
    tier-1 product through the :func:`~repro_torch.kernels.ec_matmul` kernel
    on the block view.  Returns (m, batch).
    """
    return _block_execute(at, da, xb, key, cfg, m=m, n=n, tier2=tier2,
                          use_kernel=use_kernel, eta=eta, transpose=False)


def programmed_block_rmvm(at: torch.Tensor, da: torch.Tensor, yb: torch.Tensor,
                          key: int, cfg: CrossbarConfig, *, m: int, n: int,
                          tier2: bool = True, use_kernel: bool = False,
                          eta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transposed execute stage: corrected ``A.T @ y`` against the same
    programmed image, zero re-encode.

    ``yb`` is (m, batch), chunked by ROW blocks; block (I, J)'s chunk passes
    the DAC with the same ``fold_in(block_key(key, I, J), 1)`` draw a forward
    execution uses (``eta`` of shape ``(mb, nb, cap_m, batch)`` replaces
    them); tier-1 is ``A_tilde^T y + dA^T y_tilde``, row-block partials are
    summed and tier-2 runs over the (n, batch) output.  ``use_kernel=True``
    runs each block's product through :func:`~repro_torch.kernels.ec_rmatmul`.
    Returns (n, batch).
    """
    return _block_execute(at, da, yb, key, cfg, m=m, n=n, tier2=tier2,
                          use_kernel=use_kernel, eta=eta, transpose=True)
