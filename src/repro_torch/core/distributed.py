"""Distributed corrected MVM over a mesh of ranks (port of
:mod:`repro.core.distributed`, the paper's Algorithm 4).

Each rank of a :class:`~repro_torch.launch.mesh.Mesh` owns a 2-D window of
the global matrix: rows over ``row_axes`` (row-major), contraction columns
over ``col_axis``.  One process drives every rank in rank order, as the JAX
package's ``shard_map`` is one program; each rank's operands are its own
tensors on its own device.  A rank runs the SAME local stages as the local
and streamed placements (:mod:`repro_torch.core.crossbar`); the partials are
added over the contraction axis with :func:`~repro_torch.launch.mesh.psum`
(in rank order), and tier-2 denoises each output segment on its own -- the
paper's "on-node" error correction, so with more than one segment the
stencil or Thomas system is cut at the segment edges.  The row segments are
then joined in rank order on the mesh's lead device: a caller gets one
global tensor.

  * **Dense placement** (:func:`make_distributed_program`,
    :func:`make_distributed_programmed_mvm`, :func:`make_distributed_rmvm`):
    the global matrix is cut into windows (:func:`shard_matrix`, m % R == 0
    and n % C == 0); rank (r, c) programs its window with
    :func:`~repro_torch.core.crossbar.program_blocks` under its device key
    (``fold_in`` of its axis indices in ``row_axes + (col_axis,)`` order),
    so each window is padded and keyed on its own.
  * **Producer placement** (:func:`make_distributed_streamed_program`,
    :func:`make_distributed_streamed_mvm`, :func:`make_distributed_streamed_rmvm`):
    rank (r, c) programs and sweeps its ``(mb / R, nb / C)`` window of the
    global block grid through the streamed stages with GLOBAL block indices
    and keys, so the image and every draw equal the streamed placement's
    block for block (a 1 x 1 mesh is the streamed engine bit for bit).
    ``resident=False`` keeps no image: each block is encoded, consumed and
    dropped inside the sweep.
  * **Grouped placement** (:func:`make_distributed_group_program`,
    :func:`make_distributed_group_mvm`, :func:`make_distributed_group_rmvm`):
    a stack of same-shape members, member ``g`` under the device fold of its
    own key, so the stack equals ``g`` solo distributed programs bit for bit.

``use_kernel=True`` runs tier-1 through the hand-written EC kernels (one
``ec_matmul`` / ``ec_rmatmul`` launch per capacity block of a rank's window;
one ``ec_group_matmul`` launch per rank's window of a group forward, one
``ec_group_rmatmul`` per column block of it transposed) and tier-2 through
``stencil_denoise`` / ``thomas_solve``, one launch per output segment.  On
CPU tensors the kernels' plain versions run.  The DAC draws per block
(``fold_in(block_key(key, I, J), 1)``), on both backends.

Every noisy stage takes an optional ``eta`` in the reference's draw layout
so tests can inject its draws: dense and grouped placement index a rank's
window draws as ``eta[r, c]`` (after the member axis for groups), the
producer placement takes the global block grid's.  Write costs follow the
paper's Figs. 4-5 convention: the mean over ranks.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from ..launch.mesh import Mesh, gather_to_lead, mesh_axis_sizes, psum
from .crossbar import (CrossbarConfig, _denoise_output, _encode_vec,
                       group_program_blocks,
                       grouped_block_mvm, grouped_block_rmvm,
                       input_write_cost, matrix_write_cost, program_blocks,
                       programmed_block_mvm, programmed_block_rmvm,
                       streamed_block_mvm, streamed_block_rmvm,
                       streamed_program_blocks, write_cost)
from .prng import block_key, fold_in, generator
from .write_verify import WriteStats

__all__ = [
    "distributed_corrected_mvm",
    "shard_matrix",
    "mesh_grid_shape",
    "make_distributed_program",
    "make_distributed_programmed_mvm",
    "make_distributed_rmvm",
    "make_distributed_streamed_program",
    "make_distributed_streamed_mvm",
    "make_distributed_streamed_rmvm",
    "make_distributed_group_program",
    "make_distributed_group_mvm",
    "make_distributed_group_rmvm",
]

Axes = Union[str, Sequence[str]]


def _as_axes(row_axes: Axes) -> Tuple[str, ...]:
    return (row_axes,) if isinstance(row_axes, str) else tuple(row_axes)


def mesh_grid_shape(mesh: Mesh, row_axes: Axes,
                    col_axis: str) -> Tuple[int, int]:
    """(R, C): how many ways the mesh splits rows and contraction columns."""
    sizes = mesh_axis_sizes(mesh)
    r = 1
    for ax in _as_axes(row_axes):
        r *= sizes[ax]
    return r, sizes[col_axis]


def _row_index(coords, row_axes: Tuple[str, ...], sizes) -> int:
    """A rank's row-shard index: row-major over ``row_axes``."""
    idx = 0
    for ax in row_axes:
        idx = idx * sizes[ax] + coords[ax]
    return idx


def _device_key(key: int, coords, axes: Tuple[str, ...]) -> int:
    """A rank's key: ``key`` folded with its index on each of ``axes``, in
    order, so programming and DAC noise differ from rank to rank."""
    for ax in axes:
        key = fold_in(key, coords[ax])
    return key


class RankGrid:
    """The R x C grid of a mesh under ``row_axes`` / ``col_axis`` (checked
    against the mesh): each rank's (r, c) in ``rc``, the rank at each (r,
    c) in ``ranks``, and each rank's device key and device."""

    def __init__(self, mesh: Mesh, row_axes: Axes, col_axis: str):
        row_axes = _as_axes(row_axes)
        named = row_axes + (col_axis,)
        sizes = mesh_axis_sizes(mesh)
        missing = [ax for ax in named if ax not in sizes]
        if missing or len(set(named)) != len(named):
            raise ValueError(f"row_axes {row_axes} and col_axis {col_axis!r} "
                             f"must be distinct axes of the mesh "
                             f"{mesh.axis_names}")
        spare = [ax for ax in mesh.axis_names
                 if ax not in named and sizes[ax] > 1]
        if spare:
            raise ValueError(f"mesh axes {spare} are neither row axes nor the "
                             f"column axis; give them size 1")
        self.mesh, self.row_axes, self.col_axis = mesh, row_axes, col_axis
        self.axes = named
        self.R, self.C = mesh_grid_shape(mesh, row_axes, col_axis)
        self.rc: List[Tuple[int, int]] = []
        self.ranks = [[0] * self.C for _ in range(self.R)]
        self.coords = [mesh.coords(rank) for rank in range(mesh.size)]
        for rank, co in enumerate(self.coords):
            r, c = _row_index(co, row_axes, sizes), co[col_axis]
            self.rc.append((r, c))
            self.ranks[r][c] = rank

    def key(self, key: int, rank: int) -> int:
        return _device_key(key, self.coords[rank], self.axes)

    def device(self, rank: int) -> torch.device:
        return self.mesh.devices[rank]


def _mean_stats(stats: Sequence[WriteStats]) -> WriteStats:
    """The mean over ranks (the paper's Figs. 4-5 convention)."""
    return WriteStats(energy_j=sum(s.energy_j for s in stats) / len(stats),
                      latency_s=sum(s.latency_s for s in stats) / len(stats),
                      iterations=stats[0].iterations,
                      final_delta=stats[0].final_delta)


def _scale_stats(stats: WriteStats, factor: float) -> WriteStats:
    """``factor`` members' worth of one member's :class:`WriteStats` (a
    group's members program in parallel onto disjoint MCA sets, so latency
    scales with energy here)."""
    return WriteStats(energy_j=stats.energy_j * factor,
                      latency_s=stats.latency_s * factor,
                      iterations=stats.iterations,
                      final_delta=stats.final_delta)


def _windows(a: torch.Tensor, grid: RankGrid) -> List[torch.Tensor]:
    """Rank (r, c)'s window of the last two axes of ``a``, contiguous on the
    rank's device, in rank order."""
    m, n = a.shape[-2:]
    if m % grid.R or n % grid.C:
        raise ValueError(f"a {m} x {n} matrix does not divide over the "
                         f"{grid.R} x {grid.C} mesh (need m % {grid.R} == 0 "
                         f"and n % {grid.C} == 0)")
    ml, nl = m // grid.R, n // grid.C
    return [a[..., r * ml:(r + 1) * ml, c * nl:(c + 1) * nl]
            .to(grid.device(rank)).contiguous()
            for rank, (r, c) in enumerate(grid.rc)]


def shard_matrix(a: torch.Tensor, mesh: Mesh, row_axes: Axes = ("data",),
                 col_axis: str = "model") -> List[torch.Tensor]:
    """Cut a global (m, n) matrix -- or a (g, m, n) stack, along its last two
    axes -- into the mesh's R x C windows: rank (r, c) gets rows ``r * m /
    R`` on and columns ``c * n / C`` on, as a contiguous tensor on its
    device; a list in rank order."""
    if a.ndim < 2:
        raise ValueError(f"shard_matrix takes a matrix or a stack of them, "
                         f"got shape {tuple(a.shape)}")
    return _windows(a, RankGrid(mesh, row_axes, col_axis))


def _eta_rc(eta, r: int, c: int):
    return None if eta is None else eta[r][c]


def _reduce(grid: RankGrid, partials, cfg, use_kernel, transpose):
    """psum the ranks' partials over the contraction axis, tier-2 each
    output segment (a group's as one panel: one launch), and join the
    segments in order on the lead device."""
    mesh = grid.mesh
    if transpose:
        sums = psum(mesh, partials, grid.row_axes)
        segs = [sums[grid.ranks[0][c]] for c in range(grid.C)]
    else:
        sums = psum(mesh, partials, grid.col_axis)
        segs = [sums[grid.ranks[r][0]] for r in range(grid.R)]
    segs = [_denoise_output(s, cfg, use_kernel=use_kernel) for s in segs]
    return gather_to_lead(mesh, segs, 1 if segs[0].ndim == 3 else 0)


def _split(u: torch.Tensor, parts: int, index: int, device,
           axis: int = 0) -> torch.Tensor:
    """Part ``index`` of ``parts`` equal parts of ``u`` along ``axis``, on
    ``device``."""
    size = u.shape[axis] // parts
    return u.narrow(axis, index * size, size).to(device).contiguous()


# --------------------------------------------------------------------------- #
# Dense placement
# --------------------------------------------------------------------------- #

def make_distributed_program(cfg: CrossbarConfig, mesh: Mesh,
                             row_axes: Axes = ("data",),
                             col_axis: str = "model") -> Callable:
    """The dense program stage.

    Returned fn: ``(windows, key, *, eta=None) -> (at_ranks, da_ranks,
    WriteStats)``: ``windows`` are :func:`shard_matrix`'s, rank (r, c)'s is
    programmed with :func:`~repro_torch.core.crossbar.program_blocks` under
    its device key (``eta[r, c]`` of shape (mb_loc, nb_loc, cap_m, cap_n)
    replaces its draws), and the padded images stay on the rank's device,
    one per rank in rank order.  The cost is the mean over ranks.
    """
    grid = RankGrid(mesh, row_axes, col_axis)

    def program(windows, key: int, *, eta=None):
        at, da, stats = [], [], []
        for rank, (r, c) in enumerate(grid.rc):
            w = windows[rank]
            at_r, da_r = program_blocks(w, grid.key(key, rank), cfg,
                                        eta=_eta_rc(eta, r, c))
            at.append(at_r)
            da.append(da_r)
            stats.append(matrix_write_cost(*w.shape, cfg))
        return at, da, _mean_stats(stats)

    return program


def _dense_execute(cfg, mesh, row_axes, col_axis, *, transpose,
                   stats_include_matrix=False, use_kernel=False):
    grid = RankGrid(mesh, row_axes, col_axis)
    run = programmed_block_rmvm if transpose else programmed_block_mvm

    def execute(at_ranks, da_ranks, ub: torch.Tensor, key: int, *,
                shape: Tuple[int, int], eta=None):
        m, n = shape
        ml, nl = m // grid.R, n // grid.C
        batch = ub.shape[1]
        partials, stats = [], []
        for rank, (r, c) in enumerate(grid.rc):
            u = _split(ub, grid.R, r, grid.device(rank)) if transpose \
                else _split(ub, grid.C, c, grid.device(rank))
            partials.append(run(at_ranks[rank], da_ranks[rank], u,
                                grid.key(key, rank), cfg, m=ml, n=nl,
                                tier2=False, use_kernel=use_kernel,
                                eta=_eta_rc(eta, r, c)))
            if stats_include_matrix:
                stats.append(write_cost(ml, nl, cfg, batch=batch))
            else:
                stats.append(input_write_cost(ml, nl, cfg, batch=batch,
                                              transpose=transpose))
        y = _reduce(grid, partials, cfg, use_kernel, transpose)
        return y, _mean_stats(stats)

    return execute


def make_distributed_programmed_mvm(cfg: CrossbarConfig, mesh: Mesh,
                                    row_axes: Axes = ("data",),
                                    col_axis: str = "model", *,
                                    stats_include_matrix: bool = False,
                                    use_kernel: bool = False) -> Callable:
    """The dense execute stage.

    Returned fn: ``(at_ranks, da_ranks, x (n, batch), key, *, shape=(m, n),
    eta=None) -> (y (m, batch), WriteStats)``.  Rank (r, c) runs
    :func:`~repro_torch.core.crossbar.programmed_block_mvm` on its window
    against x's column part c, under its device key (``eta[r, c]`` of shape
    (mb_loc, nb_loc, cap_n, batch) replaces the DAC draws), without tier-2;
    the partials are summed over ``col_axis`` and tier-2 runs on each row
    segment.  ``stats_include_matrix=True`` bills programming and inputs in
    one figure (the one-shot accounting).
    """
    return _dense_execute(cfg, mesh, row_axes, col_axis, transpose=False,
                          stats_include_matrix=stats_include_matrix,
                          use_kernel=use_kernel)


def make_distributed_rmvm(cfg: CrossbarConfig, mesh: Mesh,
                          row_axes: Axes = ("data",),
                          col_axis: str = "model", *,
                          use_kernel: bool = False) -> Callable:
    """The dense transposed execute stage, the mirror of
    :func:`make_distributed_programmed_mvm`: ``(at_ranks, da_ranks, y (m,
    batch), key, *, shape, eta=None) -> (z (n, batch), WriteStats)``; rank
    (r, c) reads y's row part r (``eta[r, c]``: (mb_loc, nb_loc, cap_m,
    batch)), the partials are summed over ``row_axes`` and tier-2 runs on
    each column segment."""
    return _dense_execute(cfg, mesh, row_axes, col_axis, transpose=True,
                          use_kernel=use_kernel)


# --------------------------------------------------------------------------- #
# Grouped placement
# --------------------------------------------------------------------------- #

def make_distributed_group_program(cfg: CrossbarConfig, mesh: Mesh,
                                   row_axes: Axes = ("data",),
                                   col_axis: str = "model") -> Callable:
    """The grouped program stage.

    Returned fn: ``(windows, keys, *, eta=None) -> (at_ranks, da_ranks,
    WriteStats)``: ``windows`` are the ranks' (g, m_loc, n_loc) windows of
    the stack (rank order), ``keys`` one base key per member; member ``g``
    of rank (r, c) is programmed under the device fold of ``keys[g]``
    (``eta[g, r, c]`` replaces its draws), exactly as a solo distributed
    program of that member, into (g, Mw, Nw) stacks on the rank's device.
    """
    grid = RankGrid(mesh, row_axes, col_axis)

    def program(windows, keys, *, eta=None):
        at, da, stats = [], [], []
        for rank, (r, c) in enumerate(grid.rc):
            w = windows[rank]
            at_r, da_r = group_program_blocks(
                w, [grid.key(k, rank) for k in keys], cfg,
                eta=None if eta is None else eta[:, r, c])
            at.append(at_r)
            da.append(da_r)
            stats.append(_scale_stats(matrix_write_cost(*w.shape[1:], cfg),
                                      w.shape[0]))
        return at, da, _mean_stats(stats)

    return program


def _group_window_ec(at, da, ub, keys, cfg, *, m, n, eta, transpose):
    """Tier-1 of a group on one rank's window through the grouped EC
    kernels, with the per-block DAC draws of the plain pipeline.

    ``at``/``da`` are (g, Mw, Nw) padded windows, ``ub`` (g, m or n, batch).
    Forward, each capacity row strip of each member is one member of ONE
    ``ec_group_matmul`` launch: strip i reads x against its own x_tilde,
    the concatenation of x's column chunks each through block (i, j)'s
    draw.  Transposed, each column block j is one ``ec_group_rmatmul``
    launch over the members.  Only the live (m, n) part is read: the
    padding is exact zeros.  Returns (g, n or m, batch).
    """
    from .. import kernels
    g, mw, nw = at.shape
    cap_m, cap_n = cfg.geom.capacity
    mb, nb = mw // cap_m, nw // cap_n
    batch = ub.shape[2]
    if transpose:
        n_in, cap_in, len_in, n_out = mb, cap_m, m, nb
    else:
        n_in, cap_in, len_in, n_out = nb, cap_n, n, mb
    u_pad = torch.zeros(g, n_in * cap_in, batch, dtype=torch.float32,
                        device=ub.device)
    u_pad[:, :len_in] = ub
    chunks = u_pad.view(g, n_in, cap_in, batch)
    # u_t[g, o]: member g's input as output block o's row of blocks sees it.
    u_t = torch.empty(g, n_out, n_in * cap_in, batch, dtype=torch.float32,
                      device=ub.device)
    for q in range(g):
        for o in range(n_out):
            for c in range(n_in):
                i, j = (c, o) if transpose else (o, c)
                dst = u_t[q, o, c * cap_in:(c + 1) * cap_in]
                if not cfg.encode_inputs:
                    dst.copy_(chunks[q, c])
                elif eta is None:
                    dst.copy_(_encode_vec(chunks[q, c], cfg, gen=generator(
                        fold_in(block_key(keys[q], i, j), 1), ub.device)))
                else:
                    dst.copy_(_encode_vec(chunks[q, c], cfg,
                                          eta=eta[q][i][j]))
    if transpose:
        outs = []
        for o in range(n_out):
            w = min(cap_n, n - o * cap_n)
            cols = slice(o * cap_n, o * cap_n + w)

            def panel(v):   # (g, m, batch) -> (m, g * batch)
                return v[:, :m].permute(1, 0, 2).reshape(m, g * batch) \
                    .contiguous()

            p = kernels.ec_group_rmatmul(at[:, :m, cols], da[:, :m, cols],
                                         panel(u_pad), panel(u_t[:, o]))
            outs.append(p.view(w, g, batch).permute(1, 0, 2))
        return torch.cat(outs, dim=1)
    strips = g * mb

    def panel(v):   # (g, mb, n, batch) -> (n, g * mb * batch)
        return v.permute(2, 0, 1, 3).reshape(n, strips * batch).contiguous()

    x = panel(u_pad[:, None, :n].expand(g, mb, n, batch))
    x_t = panel(u_t[:, :, :n])
    p = kernels.ec_group_matmul(at.view(strips, cap_m, nw)[:, :, :n],
                                da.view(strips, cap_m, nw)[:, :, :n], x, x_t)
    return p.view(cap_m, g, mb, batch).permute(1, 2, 0, 3) \
        .reshape(g, mb * cap_m, batch)[:, :m]


def _group_execute(cfg, mesh, row_axes, col_axis, *, transpose, use_kernel):
    grid = RankGrid(mesh, row_axes, col_axis)
    run = grouped_block_rmvm if transpose else grouped_block_mvm

    def execute(at_ranks, da_ranks, ub: torch.Tensor, keys, *,
                shape: Tuple[int, int], eta=None):
        m, n = shape
        ml, nl = m // grid.R, n // grid.C
        size, _, batch = ub.shape
        partials, stats = [], []
        for rank, (r, c) in enumerate(grid.rc):
            u = _split(ub, grid.R, r, grid.device(rank), axis=1) \
                if transpose else \
                _split(ub, grid.C, c, grid.device(rank), axis=1)
            dev_keys = [grid.key(k, rank) for k in keys]
            e = None if eta is None else eta[:, r, c]
            if use_kernel and cfg.ec:
                p = _group_window_ec(at_ranks[rank], da_ranks[rank], u,
                                     dev_keys, cfg, m=ml, n=nl, eta=e,
                                     transpose=transpose)
            else:
                p = run(at_ranks[rank], da_ranks[rank], u, dev_keys, cfg,
                        m=ml, n=nl, tier2=False, eta=e)
            partials.append(p)
            stats.append(_scale_stats(input_write_cost(
                ml, nl, cfg, batch=batch, transpose=transpose), size))
        y = _reduce(grid, partials, cfg, use_kernel, transpose)
        return y, _mean_stats(stats)

    return execute


def make_distributed_group_mvm(cfg: CrossbarConfig, mesh: Mesh,
                               row_axes: Axes = ("data",),
                               col_axis: str = "model", *,
                               use_kernel: bool = False) -> Callable:
    """The grouped execute stage.

    Returned fn: ``(at_ranks, da_ranks, x (g, n, batch), keys, *, shape=(m,
    n), eta=None) -> (y (g, m, batch), WriteStats)``.  Member ``g`` under
    ``keys[g]`` is a solo distributed execute of that member under the same
    key (``eta[g, r, c]``: (mb_loc, nb_loc, cap_n, batch)); the stacked
    partials are summed over ``col_axis`` once for the group and tier-2 runs
    on each member's segment, one launch a segment on the kernel path.
    """
    return _group_execute(cfg, mesh, row_axes, col_axis, transpose=False,
                          use_kernel=use_kernel)


def make_distributed_group_rmvm(cfg: CrossbarConfig, mesh: Mesh,
                                row_axes: Axes = ("data",),
                                col_axis: str = "model", *,
                                use_kernel: bool = False) -> Callable:
    """The grouped transposed execute stage: ``y`` (g, m, batch) split over
    the row axes, the partials summed over ``row_axes`` once for the group,
    tier-2 on each member's column segment; returns (z (g, n, batch),
    WriteStats)."""
    return _group_execute(cfg, mesh, row_axes, col_axis, transpose=True,
                          use_kernel=use_kernel)


# --------------------------------------------------------------------------- #
# Producer placement (the matrix never materializes anywhere)
# --------------------------------------------------------------------------- #

def _window_of(eta, i0: int, j0: int, mb: int, nb: int):
    return None if eta is None else eta[i0:i0 + mb, j0:j0 + nb]


def make_distributed_streamed_program(block_fn, cfg: CrossbarConfig,
                                      mesh: Mesh, row_axes: Axes = ("data",),
                                      col_axis: str = "model", *, mb: int,
                                      nb: int) -> Callable:
    """The producer-driven program stage.

    Returned fn: ``(key, *, eta=None) -> at_ranks``: rank (r, c) programs
    its (mb / R, nb / C) window of the global block grid, at block origin
    (r * mb / R, c * nb / C), through
    :func:`~repro_torch.core.crossbar.streamed_program_blocks` with GLOBAL
    producer indices and keys, into a contiguous block stack on its device;
    ``eta`` is the global grid's (mb, nb, cap_m, cap_n) draws.  The source
    matrix is never materialized.  Needs ``mb % R == 0`` and ``nb % C ==
    0``.
    """
    grid = RankGrid(mesh, row_axes, col_axis)
    if mb % grid.R or nb % grid.C:
        raise ValueError(f"the {mb} x {nb} block grid does not divide over "
                         f"the {grid.R} x {grid.C} mesh")
    mbl, nbl = mb // grid.R, nb // grid.C

    def program(key: int, *, eta=None):
        return [streamed_program_blocks(
            block_fn, key, cfg, mbl, nbl, block_offset=(r * mbl, c * nbl),
            grid=(mb, nb), eta=_window_of(eta, r * mbl, c * nbl, mbl, nbl),
            device=grid.device(rank))
            for rank, (r, c) in enumerate(grid.rc)]

    return program


def _streamed_execute(block_fn, cfg, mesh, row_axes, col_axis, *, m, n, mb,
                      nb, resident, use_kernel, transpose):
    grid = RankGrid(mesh, row_axes, col_axis)
    if mb % grid.R or nb % grid.C:
        raise ValueError(f"the {mb} x {nb} block grid does not divide over "
                         f"the {grid.R} x {grid.C} mesh")
    mbl, nbl = mb // grid.R, nb // grid.C
    cap_m, cap_n = cfg.geom.capacity
    if grid.R > 1 and m != mb * cap_m or grid.C > 1 and n != nb * cap_n:
        raise ValueError(f"a {m} x {n} producer grid split over the "
                         f"{grid.R} x {grid.C} mesh must be whole capacity "
                         f"blocks {cfg.geom.capacity} on every split axis")
    # A rank's footprint: whole capacity blocks, except on a one-way axis,
    # where the single rank owns the (possibly unpadded) global edge.
    ml = m if grid.R == 1 else mbl * cap_m
    nl = n if grid.C == 1 else nbl * cap_n
    run = streamed_block_rmvm if transpose else streamed_block_mvm

    def execute(at_ranks, ub: torch.Tensor, key: int, *, eta=None,
                program_eta=None, program_key: Optional[int] = None):
        if (at_ranks is None) == resident:
            raise ValueError("a resident execute takes the ranks' images, a "
                             "non-resident one takes None")
        partials = []
        for rank, (r, c) in enumerate(grid.rc):
            i0, j0 = r * mbl, c * nbl
            u = _split(ub, grid.R, r, grid.device(rank)) if transpose \
                else _split(ub, grid.C, c, grid.device(rank))
            partials.append(run(
                block_fn, at_ranks[rank] if resident else None, u, key, cfg,
                m=ml, n=nl, use_kernel=use_kernel, tier2=False,
                block_offset=(i0, j0), grid=(mb, nb),
                eta=_window_of(eta, i0, j0, mbl, nbl),
                program_eta=_window_of(program_eta, i0, j0, mbl, nbl),
                program_key=program_key))
        return _reduce(grid, partials, cfg, use_kernel, transpose)

    return execute


def make_distributed_streamed_mvm(block_fn, cfg: CrossbarConfig, mesh: Mesh,
                                  row_axes: Axes = ("data",),
                                  col_axis: str = "model", *, m: int, n: int,
                                  mb: int, nb: int, resident: bool = True,
                                  use_kernel: bool = False) -> Callable:
    """The producer-driven execute stage.

    Returned fn: ``(at_ranks, x (n, batch), key, *, eta=None,
    program_eta=None, program_key=None) -> y (m, batch)``, ``at_ranks``
    None when not ``resident``.  Rank (r, c) sweeps its window of the global block grid
    with :func:`~repro_torch.core.crossbar.streamed_block_mvm` (global
    producer indices and keys; ``eta`` the global (mb, nb, cap_n, batch)
    DAC draws) on x's column part c; the partials are summed over
    ``col_axis`` and tier-2 runs on each row segment.  ``resident=False``
    encodes each block inside the sweep with its programming draw under
    ``program_key`` (default ``key``; ``program_eta``: the global (mb, nb,
    cap_m, cap_n)) and drops it after use, so no rank holds more than a few
    capacity blocks of A.
    """
    return _streamed_execute(block_fn, cfg, mesh, row_axes, col_axis, m=m,
                             n=n, mb=mb, nb=nb, resident=resident,
                             use_kernel=use_kernel, transpose=False)


def make_distributed_streamed_rmvm(block_fn, cfg: CrossbarConfig, mesh: Mesh,
                                   row_axes: Axes = ("data",),
                                   col_axis: str = "model", *, m: int, n: int,
                                   mb: int, nb: int, resident: bool = True,
                                   use_kernel: bool = False) -> Callable:
    """The producer-driven transposed execute stage, the mirror of
    :func:`make_distributed_streamed_mvm`: ``y`` (m, batch) split over the
    row axes, the same per-block DAC draws as forward (``eta``: (mb, nb,
    cap_m, batch)), partials summed over ``row_axes``, tier-2 on each column
    segment; returns z (n, batch)."""
    return _streamed_execute(block_fn, cfg, mesh, row_axes, col_axis, m=m,
                             n=n, mb=mb, nb=nb, resident=resident,
                             use_kernel=use_kernel, transpose=True)


# --------------------------------------------------------------------------- #
# One-shot entry point
# --------------------------------------------------------------------------- #

def distributed_corrected_mvm(a: torch.Tensor, x: torch.Tensor, key: int,
                              cfg: CrossbarConfig, mesh: Mesh,
                              row_axis: Axes = "data",
                              col_axis: str = "model", *,
                              eta=None, dac_eta=None
                              ) -> Tuple[torch.Tensor, WriteStats]:
    """``y ~= A @ x`` with a per-rank multi-MCA simulation and two-tier EC,
    in one shot: :func:`shard_matrix`, the dense program and one dense
    execute under ``key`` (plain PyTorch, as the one-shot
    :func:`~repro_torch.core.crossbar.corrected_mvm` is), billed for the
    program and the inputs together (mean over ranks).  It re-programs
    ``a`` on every call; a matrix used more than once belongs in
    ``AnalogEngine(cfg, execution="distributed", mesh=mesh)``.  ``x`` is
    (n,) or (n, batch); ``eta`` (R, C, mb_loc, nb_loc, cap_m, cap_n) and
    ``dac_eta`` (R, C, mb_loc, nb_loc, cap_n, batch) replace the draws.
    """
    squeeze = x.ndim == 1
    xb = x[:, None] if squeeze else x
    program = make_distributed_program(cfg, mesh, row_axis, col_axis)
    execute = make_distributed_programmed_mvm(cfg, mesh, row_axis, col_axis,
                                              stats_include_matrix=True)
    at, da, _ = program(shard_matrix(a, mesh, row_axis, col_axis), key,
                        eta=eta)
    y, stats = execute(at, da, xb, key, shape=tuple(a.shape), eta=dac_eta)
    return (y[:, 0] if squeeze else y), stats
