"""Multi-MCA crossbar simulation (port of :mod:`repro.core.crossbar`).

The program-once dataflow in two stages: :func:`program_blocks` encodes the
zero-padded matrix one capacity block at a time (per-MCA-tile quantization
plus residual programming noise) and keeps ``A_tilde`` and ``dA = A - A_tilde``;
:func:`programmed_block_mvm` executes a corrected MVM against that image with
only the input vector passing through the DAC, and
:func:`programmed_block_rmvm` the transposed ``A.T @ y`` against the same
image; :func:`corrected_mvm` is the one-shot composition of the two, with
its write cost.  The grouped stages (:func:`group_program_blocks`,
:func:`grouped_block_mvm`, :func:`grouped_block_rmvm`) run a stack of
same-shape members, member ``g`` exactly as its solo stage under ``keys[g]``.
The streamed stages (:func:`streamed_program_blocks`,
:func:`streamed_block_mvm`, :func:`streamed_block_rmvm`, their grouped forms
and the one-shot :func:`streamed_corrected_mvm`) take a ``block_fn(i, j)``
producer in place of the matrix and keep only ``A_tilde``; ``dA`` is derived
again per block at execute time.

Layout: a local image lives as two dense padded ``(Mp, Np)`` float32
tensors, and the ``(mb, nb, cap_m, cap_n)`` block layout of the reference is
a view (:func:`repro_torch.core.virtualization.blocks_view`), never a second
copy; a streamed image is one contiguous ``(mb, nb, cap_m, cap_n)`` block
stack, as the reference keeps it.  All stages run through one block loop
(:func:`_sweep`).
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
    "group_program_blocks",
    "grouped_block_mvm",
    "grouped_block_rmvm",
    "produce_blocks",
    "streamed_program_blocks",
    "streamed_block_mvm",
    "streamed_block_rmvm",
    "grouped_streamed_program_blocks",
    "grouped_streamed_block_mvm",
    "grouped_streamed_block_rmvm",
    "corrected_mvm",
    "streamed_corrected_mvm",
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


def _encode_block(blk: torch.Tensor, key: int, i: int, j: int,
                  cfg: CrossbarConfig,
                  eta: Optional[torch.Tensor]) -> torch.Tensor:
    """Program capacity block (i, j) (GLOBAL indices): :func:`encode_tiled`
    with ``fold_in(block_key(key, i, j), 0)``, or ``eta`` when given."""
    if eta is not None:
        return encode_tiled(blk, cfg, eta=eta)
    gen = generator(fold_in(block_key(key, i, j), 0), blk.device)
    return encode_tiled(blk, cfg, gen=gen)


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
            enc = _encode_block(blk, key, i, j, cfg,
                                None if eta is None else eta[i, j])
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


def _denoise_output(p: torch.Tensor, cfg: CrossbarConfig, *,
                    use_kernel: bool) -> torch.Tensor:
    """Tier-2 of an execute's output, column by column: ``p`` is (rows,
    columns), or (g, rows, batch) taken as one (rows, g * batch) panel;
    through the ``stencil_denoise`` / ``thomas_solve`` kernel when
    ``use_kernel`` (their plain versions on CPU tensors), else the plain
    pipeline's; nothing with ``ec=False``."""
    if not cfg.ec:
        return p
    if p.ndim == 3:
        g, rows, batch = p.shape
        panel = p.permute(1, 0, 2).reshape(rows, g * batch)
        return _denoise_output(panel, cfg, use_kernel=use_kernel) \
            .view(rows, g, batch).permute(1, 0, 2).contiguous()
    if use_kernel and cfg.denoise_method in ("neumann", "thomas"):
        from .. import kernels
        run = kernels.stencil_denoise if cfg.denoise_method == "neumann" \
            else kernels.thomas_solve
        return run(p.contiguous(), cfg.lam, cfg.h)
    return denoise_least_square(p, lam=cfg.lam, h=cfg.h,
                                method=cfg.denoise_method)


def _sweep(block, grid, ub, key, cfg, *, m, n, tier2, use_kernel, eta,
           transpose, block_offset=(0, 0)):
    """The execute stage in either direction, over any block source: the
    one block loop of the port.

    ``block(i, j)`` gives local block (i, j)'s ``(A_tilde, dA)`` (``dA``
    may be None with ``ec=False``) and ``grid`` is ``(mb, nb, cap_m,
    cap_n)``.  The input is chunked along the contraction axis (columns
    forward, rows transposed); block (I, J)'s chunk passes the DAC with
    ``fold_in(block_key(key, I, J), 1)`` at the GLOBAL index ``(I, J) =
    block_offset + (i, j)`` (``eta[i, j]`` replaces the draw) in both
    directions; partials are summed over the contraction blocks in fp32,
    each block's operands dropped before the next is made, and tier-2 runs
    on the assembled output.
    """
    if cfg.ec and cfg.ec_mode not in ("fused", "faithful"):
        raise ValueError(f"unknown first-order EC mode {cfg.ec_mode!r}")
    mb, nb, cap_m, cap_n = grid
    i0, j0 = block_offset
    # (output blocks, contraction blocks, their sizes, true lengths)
    if transpose:
        n_out, n_in, cap_out, cap_in, len_out, len_in = nb, mb, cap_n, cap_m, n, m
    else:
        n_out, n_in, cap_out, cap_in, len_out, len_in = mb, nb, cap_m, cap_n, m, n
    batch = ub.shape[1]
    u_pad = torch.zeros(n_in * cap_in, batch, dtype=torch.float32,
                        device=ub.device)
    u_pad[:len_in] = ub
    chunks = u_pad.view(n_in, cap_in, batch)
    outs = []
    for o in range(n_out):
        acc = torch.zeros(cap_out, batch, dtype=torch.float32,
                          device=ub.device)
        for c in range(n_in):
            i, j = (c, o) if transpose else (o, c)
            u_blk = chunks[c]
            if not cfg.encode_inputs:
                u_t = u_blk
            elif eta is None:
                gen = generator(fold_in(block_key(key, i0 + i, j0 + j), 1),
                                ub.device)
                u_t = _encode_vec(u_blk, cfg, gen=gen)
            else:
                u_t = _encode_vec(u_blk, cfg, eta=eta[i, j])
            at_blk, da_blk = block(i, j)
            acc += _block_product(at_blk, da_blk, u_blk, u_t, cfg,
                                  use_kernel, transpose)
            del at_blk, da_blk
        outs.append(acc)
    p = torch.cat(outs)[:len_out]
    if cfg.ec and tier2:
        p = denoise_least_square(p, lam=cfg.lam, h=cfg.h,
                                 method=cfg.denoise_method)
    return p


def _block_execute(at, da, ub, key, cfg, *, m, n, tier2, use_kernel, eta,
                   transpose):
    """:func:`_sweep` over the block views of a padded local image."""
    at_b, da_b = blocks_view(at, cfg.geom), blocks_view(da, cfg.geom)
    return _sweep(lambda i, j: (at_b[i, j], da_b[i, j]), at_b.shape, ub,
                  key, cfg, m=m, n=n, tier2=tier2, use_kernel=use_kernel,
                  eta=eta, transpose=transpose)


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


# --------------------------------------------------------------------------- #
# Grouped stages: a stack of same-shape images, member by member
# --------------------------------------------------------------------------- #
# Member ``g`` of a grouped stage is its solo stage under ``keys[g]``, so a
# grouped image and every grouped draw equal the solo ones; the stacked
# layout is a leading member axis on the padded images, (g, Mp, Np).

def group_program_blocks(a_stack, keys, cfg: CrossbarConfig, *,
                         eta: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Program a stack of same-shape matrices: ``a_stack`` is a (g, m, n)
    tensor or a sequence of g (m, n) tensors, ``keys`` one base key per
    member.  Returns the padded ``(A_tilde, dA)`` stacks, each (g, Mp, Np);
    member ``g`` is ``program_blocks(a_stack[g], keys[g], cfg)``
    exactly.  ``eta`` of shape (g, mb, nb, cap_m, cap_n) replaces the
    draws."""
    at = da = None
    for g, a in enumerate(a_stack):
        at_g, da_g = program_blocks(a, keys[g], cfg,
                                    eta=None if eta is None else eta[g])
        if at is None:
            at = at_g.new_empty((len(a_stack),) + tuple(at_g.shape))
            da = torch.empty_like(at)
        at[g], da[g] = at_g, da_g
        del at_g, da_g
    return at, da


def _grouped(run, at, da, ub, keys, cfg, m, n, tier2, use_kernel, eta):
    return torch.stack([
        run(at[g], da[g], ub[g], keys[g], cfg, m=m, n=n, tier2=tier2,
            use_kernel=use_kernel, eta=None if eta is None else eta[g])
        for g in range(at.shape[0])])


def grouped_block_mvm(at: torch.Tensor, da: torch.Tensor, xb: torch.Tensor,
                      keys, cfg: CrossbarConfig, *, m: int, n: int,
                      tier2: bool = True, use_kernel: bool = False,
                      eta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Corrected MVM of every member: (g, Mp, Np) image stacks, ``xb`` one
    (n, batch) panel per member (g, n, batch), one execute key per member.
    Member ``g`` is :func:`programmed_block_mvm` under ``keys[g]``, tier-2
    included; ``eta`` (g, mb, nb, cap_n, batch) replaces the DAC draws.
    Returns (g, m, batch)."""
    return _grouped(programmed_block_mvm, at, da, xb, keys, cfg, m, n, tier2,
                    use_kernel, eta)


def grouped_block_rmvm(at: torch.Tensor, da: torch.Tensor, yb: torch.Tensor,
                       keys, cfg: CrossbarConfig, *, m: int, n: int,
                       tier2: bool = True, use_kernel: bool = False,
                       eta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transposed grouped execute: member ``g`` is
    :func:`programmed_block_rmvm` under ``keys[g]``; ``yb`` is (g, m, batch),
    ``eta`` (g, mb, nb, cap_m, batch); returns (g, n, batch)."""
    return _grouped(programmed_block_rmvm, at, da, yb, keys, cfg, m, n, tier2,
                    use_kernel, eta)


# --------------------------------------------------------------------------- #
# Streamed stages: a block producer instead of a resident source matrix
# --------------------------------------------------------------------------- #
# A producer ``block_fn(i, j)`` returns capacity block (i, j) of the padded
# source, (cap_m, cap_n), for GLOBAL block indices.  Any callable is taken:
# eager PyTorch has no trace to fuse, so every producer runs in the one block
# loop of :func:`_sweep`, once per block per sweep.  The programmed image is
# a contiguous (mb, nb, cap_m, cap_n) block stack, so every block of it and
# every derived ``dA = block_fn(i, j) - A_tilde[i, j]`` share the row stride
# cap_n that the EC kernels require of their two images.  Block (I, J) is
# keyed as in :func:`program_blocks` / :func:`_sweep` (fold 0 programs,
# fold 1 drives its DAC), so a streamed image and its MVMs equal the local
# ones under the same key.

def _produce(block_fn, i: int, j: int, cfg: CrossbarConfig,
             device) -> torch.Tensor:
    """Producer block (i, j) as a float32 tensor on ``device``, checked
    against the capacity."""
    blk = torch.as_tensor(block_fn(i, j), dtype=torch.float32, device=device)
    if tuple(blk.shape) != cfg.geom.capacity:
        raise ValueError(f"block_fn({i}, {j}) returned {tuple(blk.shape)}, "
                         f"not a capacity block {cfg.geom.capacity}")
    return blk


def _check_window(mb: int, nb: int, block_offset, grid) -> Tuple[int, int]:
    i0, j0 = (int(v) for v in block_offset)
    if i0 < 0 or j0 < 0 or grid is not None and (
            i0 + mb > grid[0] or j0 + nb > grid[1]):
        raise ValueError(f"window {(mb, nb)} at {(i0, j0)} does not fit the "
                         f"global block grid {grid}")
    return i0, j0


def produce_blocks(block_fn, mb: int, nb: int, *, device) -> torch.Tensor:
    """All (mb, nb) producer blocks as one (mb, nb, cap_m, cap_n) stack on
    ``device``, the materializing sweep behind the streamed ``da`` /
    ``dense()`` views."""
    out = None
    for i in range(mb):
        for j in range(nb):
            blk = torch.as_tensor(block_fn(i, j), dtype=torch.float32,
                                  device=device)
            if out is None:
                out = torch.empty((mb, nb) + tuple(blk.shape),
                                  dtype=torch.float32, device=device)
            out[i, j] = blk
            del blk
    return out


def _stream_encode(out: torch.Tensor, block_fn, key: int,
                   cfg: CrossbarConfig, i0: int, j0: int,
                   eta: Optional[torch.Tensor]) -> None:
    """Encode every block of the (mb, nb) window at ``(i0, j0)`` into the
    stack ``out``, one producer block live at a time."""
    mb, nb = out.shape[:2]
    for i in range(mb):
        for j in range(nb):
            blk = _produce(block_fn, i0 + i, j0 + j, cfg, out.device)
            out[i, j] = _encode_block(blk, key, i0 + i, j0 + j, cfg,
                                      None if eta is None else eta[i, j])
            del blk


def streamed_program_blocks(block_fn, key: int, cfg: CrossbarConfig,
                            mb: int, nb: int, *, block_offset=(0, 0),
                            grid: Optional[Tuple[int, int]] = None,
                            eta: Optional[torch.Tensor] = None,
                            device) -> torch.Tensor:
    """Program stage over a producer: returns the programmed image as a
    contiguous (mb, nb, cap_m, cap_n) block stack on ``device``, where the
    producer's blocks are moved to.  ``dA`` is NOT kept: streamed executes
    derive it again per block, so the source is never resident twice.

    ``grid=(MB, NB)`` / ``block_offset=(i0, j0)`` program only the (mb, nb)
    window of a larger global grid at that origin: the producer and the keys
    see GLOBAL block indices, so the window equals the matching blocks of
    the full sweep.  ``eta`` ((mb, nb, cap_m, cap_n), the window's) replaces
    the programming draws.
    """
    i0, j0 = _check_window(mb, nb, block_offset, grid)
    out = torch.empty((mb, nb) + cfg.geom.capacity, dtype=torch.float32,
                      device=device)
    _stream_encode(out, block_fn, key, cfg, i0, j0, eta)
    return out


def _streamed_execute(block_fn, at_blocks, ub, key, cfg, *, m, n,
                      use_kernel, tier2, block_offset, grid, eta,
                      program_eta, program_key, transpose):
    if not isinstance(ub, torch.Tensor):
        raise TypeError(f"the streamed execute takes a torch.Tensor input, "
                        f"not {type(ub).__name__}: it runs on the input's "
                        f"device")
    cap_m, cap_n = cfg.geom.capacity
    if at_blocks is None:
        mb, nb = -(-m // cap_m), -(-n // cap_n)
    else:
        mb, nb = at_blocks.shape[:2]
        if tuple(at_blocks.shape[2:]) != (cap_m, cap_n):
            raise ValueError(f"image blocks {tuple(at_blocks.shape)} do not "
                             f"match the capacity {(cap_m, cap_n)}")
    i0, j0 = _check_window(mb, nb, block_offset, grid)

    def block(i, j):
        if at_blocks is not None:
            at_blk = at_blocks[i, j]
            if not cfg.ec:
                return at_blk, None
            # Out of place: a producer may hand out views of its source.
            return at_blk, torch.sub(_produce(block_fn, i0 + i, j0 + j, cfg,
                                              ub.device), at_blk)
        # One-shot: encode here with the block's programming draw and
        # consume at once; no image is ever resident.
        a_blk = _produce(block_fn, i0 + i, j0 + j, cfg, ub.device)
        at_blk = _encode_block(a_blk, key if program_key is None
                               else program_key, i0 + i, j0 + j, cfg,
                               None if program_eta is None
                               else program_eta[i, j])
        return at_blk, (torch.sub(a_blk, at_blk) if cfg.ec else None)

    return _sweep(block, (mb, nb, cap_m, cap_n), ub, key, cfg, m=m, n=n,
                  tier2=tier2, use_kernel=use_kernel, eta=eta,
                  transpose=transpose, block_offset=(i0, j0))


def streamed_block_mvm(block_fn, at_blocks: Optional[torch.Tensor],
                       xb: torch.Tensor, key: int, cfg: CrossbarConfig, *,
                       m: int, n: int, use_kernel: bool = False,
                       tier2: bool = True, block_offset=(0, 0),
                       grid: Optional[Tuple[int, int]] = None,
                       eta: Optional[torch.Tensor] = None,
                       program_eta: Optional[torch.Tensor] = None,
                       program_key: Optional[int] = None) -> torch.Tensor:
    """Execute stage over a producer: ``dA = block_fn(i, j) - A_tilde[i,
    j]`` is derived per block and dropped before the next, so the extra
    memory is O(one capacity block) over the image.  Keys and draws are
    those of :func:`programmed_block_mvm` (``eta`` (mb, nb, cap_n, batch)
    replaces the DAC draws); ``use_kernel=True`` runs each block's tier-1
    product through :func:`~repro_torch.kernels.ec_matmul`.  ``xb`` is
    (n, batch); returns (m, batch).

    ``at_blocks`` is the resident (mb, nb, cap_m, cap_n) image from
    :func:`streamed_program_blocks`; ``at_blocks=None`` selects the one-shot
    variant, where each block is encoded in the loop with its programming
    draw under ``program_key`` (default ``key``: a program and its first
    MVM; ``program_eta`` (mb, nb, cap_m, cap_n) replaces the draws) and
    consumed at once, so no image is ever resident.  ``grid`` / ``block_offset``
    select a window of a global grid as in :func:`streamed_program_blocks`;
    ``m`` / ``n`` / ``xb`` are then the window's own footprint, and tier-2
    belongs to the caller (``tier2=False``).
    """
    return _streamed_execute(block_fn, at_blocks, xb, key, cfg, m=m, n=n,
                             use_kernel=use_kernel, tier2=tier2,
                             block_offset=block_offset, grid=grid, eta=eta,
                             program_eta=program_eta, program_key=program_key,
                             transpose=False)


def streamed_block_rmvm(block_fn, at_blocks: Optional[torch.Tensor],
                        yb: torch.Tensor, key: int, cfg: CrossbarConfig, *,
                        m: int, n: int, use_kernel: bool = False,
                        tier2: bool = True, block_offset=(0, 0),
                        grid: Optional[Tuple[int, int]] = None,
                        eta: Optional[torch.Tensor] = None,
                        program_eta: Optional[torch.Tensor] = None,
                        program_key: Optional[int] = None) -> torch.Tensor:
    """Transposed execute over a producer, the mirror of
    :func:`streamed_block_mvm`: ``yb`` (m, batch) chunked by row blocks,
    block (I, J)'s chunk with the same fold-1 DAC draw as forward (``eta``
    (mb, nb, cap_m, batch)), ``A_tilde^T y + dA^T y_tilde`` through
    :func:`~repro_torch.kernels.ec_rmatmul` when ``use_kernel``; returns
    (n, batch)."""
    return _streamed_execute(block_fn, at_blocks, yb, key, cfg, m=m, n=n,
                             use_kernel=use_kernel, tier2=tier2,
                             block_offset=block_offset, grid=grid, eta=eta,
                             program_eta=program_eta, program_key=program_key,
                             transpose=True)


def grouped_streamed_program_blocks(block_fns, keys, cfg: CrossbarConfig,
                                    mb: int, nb: int, *,
                                    eta: Optional[torch.Tensor] = None,
                                    device) -> torch.Tensor:
    """Program a group of producers, member by member: member ``g`` is
    :func:`streamed_program_blocks` of ``block_fns[g]`` under ``keys[g]``
    (``eta[g]`` replaces its draws).  Returns (g, mb, nb, cap_m, cap_n) on
    ``device``."""
    out = torch.empty((len(block_fns), mb, nb) + cfg.geom.capacity,
                      dtype=torch.float32, device=device)
    for g, fn in enumerate(block_fns):
        _stream_encode(out[g], fn, keys[g], cfg, 0, 0,
                       None if eta is None else eta[g])
    return out


def _grouped_streamed(run, block_fns, at_blocks, ub, keys, cfg, m, n,
                      use_kernel, tier2, eta):
    return torch.stack([
        run(block_fns[g], at_blocks[g], ub[g], keys[g], cfg, m=m, n=n,
            use_kernel=use_kernel, tier2=tier2,
            eta=None if eta is None else eta[g])
        for g in range(len(block_fns))])


def grouped_streamed_block_mvm(block_fns, at_blocks: torch.Tensor,
                               xb: torch.Tensor, keys, cfg: CrossbarConfig,
                               *, m: int, n: int, use_kernel: bool = False,
                               tier2: bool = True,
                               eta: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Grouped streamed execute, member by member and block by block:
    member ``g`` is :func:`streamed_block_mvm` of ``block_fns[g]`` on
    ``at_blocks[g]`` under ``keys[g]`` (``eta[g]`` replaces its DAC draws).
    ``xb`` is (g, n, batch); returns (g, m, batch)."""
    return _grouped_streamed(streamed_block_mvm, block_fns, at_blocks, xb,
                             keys, cfg, m, n, use_kernel, tier2, eta)


def grouped_streamed_block_rmvm(block_fns, at_blocks: torch.Tensor,
                                yb: torch.Tensor, keys, cfg: CrossbarConfig,
                                *, m: int, n: int, use_kernel: bool = False,
                                tier2: bool = True,
                                eta: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Transposed grouped streamed execute: member ``g`` is
    :func:`streamed_block_rmvm`; ``yb`` (g, m, batch) -> (g, n, batch)."""
    return _grouped_streamed(streamed_block_rmvm, block_fns, at_blocks, yb,
                             keys, cfg, m, n, use_kernel, tier2, eta)


# --------------------------------------------------------------------------- #
# One-shot entry point: program, execute once, bill
# --------------------------------------------------------------------------- #

def corrected_mvm(a: torch.Tensor, x: torch.Tensor, key: int,
                  cfg: CrossbarConfig, *,
                  eta: Optional[torch.Tensor] = None,
                  dac_eta: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, WriteStats]:
    """``y ~= A @ x`` on the simulated multi-MCA system in one shot (paper
    Algorithm 6 + 4): :func:`program_blocks` under ``key``, one
    :func:`programmed_block_mvm` under the same ``key`` (per-block DAC,
    tier-2 on the assembled output) and the analytic :func:`write_cost` of
    the whole thing, matrix and inputs.

    It re-programs ``a`` on every call; a matrix used more than once belongs
    in :class:`repro_torch.engine.AnalogEngine`.  ``x`` is (n,) or (n,
    batch), and ``y`` has its rank.  ``eta`` ((mb, nb, cap_m, cap_n))
    replaces the programming draws and ``dac_eta`` ((mb, nb, cap_n, batch))
    the DAC draws.
    """
    m, n = a.shape
    squeeze = x.ndim == 1
    xb = x[:, None] if squeeze else x
    at, da = program_blocks(a, key, cfg, eta=eta)
    p = programmed_block_mvm(at, da, xb, key, cfg, m=m, n=n, eta=dac_eta)
    stats = write_cost(m, n, cfg, batch=xb.shape[1])
    return (p[:, 0] if squeeze else p), stats


def streamed_corrected_mvm(block_fn, x: torch.Tensor, m: int, n: int,
                           key: int, cfg: CrossbarConfig, *,
                           eta: Optional[torch.Tensor] = None,
                           dac_eta: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, WriteStats]:
    """Large-problem one-shot ``y ~= A @ x``: ``A`` comes block by block from
    ``block_fn(i, j)`` and each block is encoded, consumed and dropped in
    the loop (the one-shot :func:`streamed_block_mvm`), so neither the
    matrix nor its image ever materializes: O(one capacity block) of memory
    at the paper's 65,025^2.  Draws are those of a streamed program + first
    MVM under ``key``; ``eta`` ((mb, nb, cap_m, cap_n)) and ``dac_eta``
    ((mb, nb, cap_n, batch)) replace them.  Plain PyTorch (the
    ``reference`` stages), as the one-shot :func:`corrected_mvm` is.  ``x``
    is (n,) or (n, batch) on the device the work runs on; returns ``y`` and
    the write cost of the whole thing, matrix and inputs.
    """
    squeeze = x.ndim == 1
    xb = x[:, None] if squeeze else x
    p = streamed_block_mvm(block_fn, None, xb, key, cfg, m=m, n=n,
                           eta=dac_eta, program_eta=eta)
    stats = write_cost(m, n, cfg, batch=xb.shape[1])
    return (p[:, 0] if squeeze else p), stats
