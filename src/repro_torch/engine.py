"""Program-once / execute-many analog MVM engine (port of :mod:`repro.engine`:
local, streamed and distributed placement).

``engine.program(a, key)`` pays the write cost once and returns an
:class:`AnalogMatrix` handle holding the padded conductance image
``A_tilde`` and the tier-1 correction operand ``dA = A - A_tilde``, each one
dense ``(Mp, Np)`` float32 tensor (the block layout is a view, see
:attr:`AnalogMatrix.at_blocks`); ``engine.mvm(A, x)`` or ``A @ x`` then runs
tier-1 error correction and tier-2 denoising with only the input vector
passing through the DAC, for ``x`` of shape ``(n,)`` or ``(n, batch)``.
``engine.rmvm(A, y)`` or ``A.T @ y`` reads the same image backwards (the
transposed corrected MVM, ``y`` of shape ``(m,)`` or ``(m, batch)``); it
pays no second programming cost.

Backends:

  * ``"reference"`` -- :func:`repro_torch.core.crossbar.programmed_block_mvm`
    and ``programmed_block_rmvm``, plain PyTorch, one DAC draw per capacity
    block;
  * ``"cuda"`` -- the mirror of the JAX engine's ``_pallas_corrected``: one
    DAC pass over the whole padded input, tier-1 through the
    :func:`~repro_torch.kernels.ec_matmul` kernel (forward) or
    :func:`~repro_torch.kernels.ec_rmatmul` (transposed), tier-2 through
    :func:`~repro_torch.kernels.stencil_denoise` (the default
    ``denoise_method="neumann"``) or :func:`~repro_torch.kernels.thomas_solve`
    (``"thomas"``).  On CPU tensors the kernels' plain versions run, which is
    how the tests drive it.

Groups: ``engine.program_group(source, key)`` programs a stack of
same-shape matrices (MoE experts, the layers of one model) into one
:class:`AnalogMatrixGroup`, ``engine.group(handles)`` stacks programmed
handles; ``engine.group_mvm`` / ``group_rmvm`` execute every member, and
``engine.chain_mvm`` threads one input through the members in turn (an
L-layer forward).  Member ``g`` draws exactly what a solo handle with the
member's key draws.  On ``backend="cuda"`` a group execute is one grouped EC
launch (:func:`~repro_torch.kernels.ec_group_matmul` /
:func:`~repro_torch.kernels.ec_group_rmatmul`) and one tier-2 launch on the
``(rows, g * batch)`` panel, at batch <= 8 per member.

``execution="streamed"`` programs from a ``block_fn(i, j)`` producer of
capacity-sized (padded) blocks with ``engine.program(block_fn, key,
shape=(m, n))``, so the source matrix never materializes (the paper's
65,025^2 case, :class:`~repro_torch.core.matrices.ImplicitBandedMatrix`).
The handle keeps the programmed image as one contiguous ``(mb, nb, cap_m,
cap_n)`` block stack and the producer, never ``dA``: every execute derives
``dA = block_fn(i, j) - A_tilde[i, j]`` again per block, so it holds the
image plus O(one capacity block).  On both backends a streamed execute draws
its DAC noise per block (fold 1 of each block key), as the reference
backend does; on ``"cuda"`` each block's tier-1 product is one
:func:`~repro_torch.kernels.ec_matmul` (``ec_rmatmul``) launch on the block
and its derived ``dA``, accumulated in fp32, and tier-2 runs once on the
assembled output through the stencil or Thomas kernel.  The producer runs
once per block per execute: eager PyTorch has nothing to trace, so a
``traceable`` attribute on it is ignored.  ``program_group`` over producers
and ``group()`` of streamed handles make streamed groups, executed member by
member.  Local and streamed handles execute on either engine.

``execution="distributed"`` places the image over a
:class:`~repro_torch.launch.mesh.Mesh` of R x C ranks (rows over
``row_axes``, the contraction over ``col_axis``), driven from this process:
``program(a, key)`` cuts a dense matrix into the ranks' windows, each
programmed under its rank's key; ``program(block_fn, key, shape=(m, n))``
has each rank program its window of the global block grid with global
keys (``resident=False``: no image at all, each block encoded inside every
execute and dropped); ``program_group`` places a stack.  An execute runs
each rank's window through the local or streamed stages (per-block DAC
draws; one EC kernel launch per capacity block, one grouped launch per
rank's window of a group), sums the partials over the contraction axis in
rank order, runs tier-2 on each output segment (so the stencil or Thomas
system is cut at the segment edges) and returns one global tensor, the
segments joined on the mesh's lead device: the solvers run on the handle
unchanged.  See :mod:`repro_torch.core.distributed`.

Aging: a local handle (or group) with a
:class:`~repro_torch.reliability.aging.AgeLedger` attached
(``reliability.attach_age`` / ``attach_group_age``) executes, on the
``"reference"`` backend only, its aged image -- drift and stuck-at latches
applied to ``A_tilde`` per call, ``dA`` as programmed -- and a host call
adds one read disturb to the ledger (``advance_age=False``, which the
solvers' operators pass, holds it, as a jitted solve does in the JAX
engine).  The ``"cuda"`` backend, streamed and distributed handles,
``group()`` of aged members and ``chain_mvm`` of an aged group refuse.

Keys are integers (:mod:`repro_torch.core.prng`); call ``c`` of a handle, in
either direction (one counter), draws its DAC noise from ``key`` for
``c == 0`` and ``fold_in(key, c)`` after, as the JAX engine does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import kernels
from .core import crossbar
from .core import distributed as dist
from .core.distributed import _scale_stats
from .core.crossbar import CrossbarConfig
from .core.prng import fold_in, generator
from .core.virtualization import blocks_view
from .core.write_verify import WriteStats
from .launch.mesh import pin_device

__all__ = ["AnalogEngine", "AnalogMatrix", "AnalogMatrixGroup",
           "TransposedAnalogMatrix", "EXECUTION_MODES", "BACKENDS",
           "CHAIN_ACTIVATIONS"]

EXECUTION_MODES = ("local", "streamed", "distributed")
BACKENDS = ("reference", "cuda")

#: Elementwise nonlinearities :meth:`AnalogEngine.chain_mvm` applies between
#: chained group members (None: a linear chain).  ``gelu`` is the tanh
#: form, which is ``jax.nn.gelu``'s default (torch's default is the erf form).
CHAIN_ACTIVATIONS = {
    None: lambda x: x,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def _is_producer(a) -> bool:
    return callable(a) and not hasattr(a, "shape")


def _stack_dense(stack: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """The dense unpadded (m, n) copy of a (mb, nb, cap_m, cap_n) stack."""
    mb, nb, cm, cn = stack.shape
    return stack.permute(0, 2, 1, 3).reshape(mb * cm, nb * cn)[:m, :n]


def _join_windows(windows, grid_rc, rows: int, cols: int, m: int, n: int,
                  device) -> torch.Tensor:
    """The (m, n) matrix whose (r, c) window of (rows, cols) is the live part
    of rank (r, c)'s padded window, on ``device``."""
    out = torch.empty(m, n, dtype=torch.float32, device=device)
    for w, (r, c) in zip(windows, grid_rc):
        out[r * rows:(r + 1) * rows, c * cols:(c + 1) * cols] = \
            w[..., :rows, :cols]
    return out


def _tree_leaves(source) -> list:
    """The leaves of a nested dict / list / tuple in JAX's pytree order:
    dict keys sorted (torch's own pytree keeps insertion order), sequences
    in order, ``None`` empty; anything else is a leaf."""
    if source is None:
        return []
    if isinstance(source, dict):
        return [leaf for k in sorted(source) for leaf in _tree_leaves(source[k])]
    if isinstance(source, (list, tuple)):
        return [leaf for item in source for leaf in _tree_leaves(item)]
    return [source]


@dataclasses.dataclass(eq=False)
class AnalogMatrix:
    """Handle to a matrix programmed onto the (simulated) analog hardware.

    A local handle holds the padded image ``at_pad`` (``A_tilde``) and
    correction operand ``da_pad`` (``dA``), each (Mp, Np).  A streamed
    handle holds the image as the contiguous (mb, nb, cap_m, cap_n) block
    stack ``at_stack`` and its producer ``block_fn``, and no ``dA``.  A
    distributed handle (``mesh_sharded``) holds one operand per rank, in
    rank order, each on its rank's device: ``at_ranks`` / ``da_ranks``, the
    ranks' padded windows, for a dense matrix; ``at_ranks``, the ranks'
    block stacks, and ``block_fn`` for a producer, or no image at all when
    not ``resident``.  All carry the one-time programming
    :class:`WriteStats` and the base key whose folds drive the input DAC
    noise of successive executions.
    """

    engine: "AnalogEngine"
    shape: Tuple[int, int]
    base_key: int
    write_stats: WriteStats
    at_pad: Optional[torch.Tensor] = None
    da_pad: Optional[torch.Tensor] = None
    calls: int = 0
    at_stack: Optional[torch.Tensor] = None
    block_fn: Optional[Callable] = None
    mesh_sharded: bool = False
    at_ranks: Optional[List[torch.Tensor]] = None
    da_ranks: Optional[List[torch.Tensor]] = None
    resident: bool = True
    # The programming draws a non-resident handle re-encodes with, when
    # they were given (tests inject the reference's).
    program_eta: Optional[torch.Tensor] = None
    # An attached repro_torch.reliability.AgeLedger (attach_age): every
    # execute then reads the aged image (reference backend only).
    age: Optional[object] = None

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def streamed(self) -> bool:
        """True for a handle programmed from a producer."""
        return self.block_fn is not None

    @property
    def image_device(self) -> torch.device:
        if self.mesh_sharded:
            return self.engine.mesh.lead_device
        return (self.at_stack if self.streamed else self.at_pad).device

    def _grid(self) -> Tuple[int, int]:
        """(mb, nb): the handle's global capacity-block grid."""
        cap_m, cap_n = self.engine.cfg.geom.capacity
        return -(-self.m // cap_m), -(-self.n // cap_n)

    def _global_stack(self) -> torch.Tensor:
        """A distributed producer handle's image as the global (mb, nb,
        cap_m, cap_n) stack on the lead device (programmed again by one
        sweep when the handle keeps no image)."""
        mb, nb = self._grid()
        dev = self.image_device
        if not self.resident:
            return crossbar.streamed_program_blocks(
                self.block_fn, self.base_key, self.engine.cfg, mb, nb,
                eta=self.program_eta, device=dev)
        grid = self.engine._rank_grid
        mbl, nbl = mb // grid.R, nb // grid.C
        out = torch.empty((mb, nb) + self.engine.cfg.geom.capacity,
                          dtype=torch.float32, device=dev)
        for w, (r, c) in zip(self.at_ranks, grid.rc):
            out[r * mbl:(r + 1) * mbl, c * nbl:(c + 1) * nbl] = w
        return out

    def _dense_windows(self, windows) -> torch.Tensor:
        grid = self.engine._rank_grid
        return _join_windows(windows, grid.rc, self.m // grid.R,
                             self.n // grid.C, self.m, self.n,
                             self.image_device)

    @property
    def at_blocks(self) -> Optional[torch.Tensor]:
        """(mb, nb, cap_m, cap_n) blocks of ``A_tilde``: a view of the padded
        image, or a streamed handle's stack itself (no copy); for a
        distributed producer handle the global stack, joined from the ranks'
        (a copy, or a fresh sweep when not resident); None for a dense
        distributed handle, whose ranks pad their windows on their own."""
        if self.mesh_sharded:
            return self._global_stack() if self.streamed else None
        if self.streamed:
            return self.at_stack
        return blocks_view(self.at_pad, self.engine.cfg.geom)

    @property
    def da_blocks(self) -> Optional[torch.Tensor]:
        """(mb, nb, cap_m, cap_n) block view of ``dA`` (no copy); None for a
        streamed or distributed handle."""
        if self.streamed or self.mesh_sharded:
            return None
        return blocks_view(self.da_pad, self.engine.cfg.geom)

    def _producer_blocks(self) -> torch.Tensor:
        mb, nb = self._grid()
        return crossbar.produce_blocks(self.block_fn, mb, nb,
                                       device=self.image_device)

    def _image_stack(self) -> torch.Tensor:
        return self._global_stack() if self.mesh_sharded else self.at_stack

    @property
    def a_tilde(self) -> torch.Tensor:
        """The programmed conductance image, unpadded (m, n): a view of a
        local image, a copy of a streamed or distributed one."""
        if self.streamed:
            return _stack_dense(self._image_stack(), self.m, self.n)
        if self.mesh_sharded:
            return self._dense_windows(self.at_ranks)
        return crossbar.assemble_blocks(self.at_pad, self.m, self.n)

    @property
    def da(self) -> torch.Tensor:
        """The tier-1 correction operand A - A_tilde, unpadded (m, n): a view
        of a local handle's, derived by one producer sweep for a producer
        handle, joined from the ranks' windows for a dense distributed
        one."""
        if self.streamed:
            return _stack_dense(self._producer_blocks().sub_(
                self._image_stack()), self.m, self.n)
        if self.mesh_sharded:
            return self._dense_windows(self.da_ranks)
        return crossbar.assemble_blocks(self.da_pad, self.m, self.n)

    def dense(self) -> torch.Tensor:
        """The exact source matrix A = A_tilde + dA, unpadded (m, n); for a
        producer handle one producer sweep."""
        if self.streamed:
            return _stack_dense(self._producer_blocks(), self.m, self.n)
        return self.a_tilde + self.da

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.engine.mvm(self, x)

    @property
    def T(self) -> "TransposedAnalogMatrix":
        """Transposed view: ``A.T @ y`` runs the corrected ``A^T y`` against
        this same image (no copy, no second programming cost)."""
        return TransposedAnalogMatrix(self)

    def input_write_stats(self, batch: int = 1) -> WriteStats:
        """Per-execution write cost (x DAC pass + EC X^T replica)."""
        return self.engine.input_write_stats(self, batch)

    @property
    def image_nbytes(self) -> int:
        """Resident bytes of the programmed operands: the two padded images,
        or a streamed handle's image alone (a producer is code, not
        residency), summed over the ranks of a distributed handle (0 when
        it keeps no image); there are no derived caches."""
        if self.mesh_sharded:
            return sum(t.nbytes for t in (self.at_ranks or [])
                       + (self.da_ranks or []))
        if self.streamed:
            return self.at_stack.nbytes
        return self.at_pad.nbytes + self.da_pad.nbytes

    def release(self) -> int:
        """Drop derived execution caches, returning the bytes freed.  The port
        keeps none (the stored images ARE the execution layout), so this
        frees 0 bytes; the image itself goes when the handle goes."""
        return 0


@dataclasses.dataclass(frozen=True)
class TransposedAnalogMatrix:
    """Transposed view of an :class:`AnalogMatrix` (``A.T``).

    Holds no operands of its own: every execution reads the parent's image
    backwards through :meth:`AnalogEngine.rmvm`, so the one-time write cost
    is shared with the forward view.  ``A.T.T is A``.
    """

    parent: AnalogMatrix

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.parent.shape[1], self.parent.shape[0])

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def T(self) -> AnalogMatrix:
        return self.parent

    @property
    def engine(self) -> "AnalogEngine":
        return self.parent.engine

    @property
    def write_stats(self) -> WriteStats:
        """The parent's one-time programming cost (shared, never re-paid)."""
        return self.parent.write_stats

    def __matmul__(self, y: torch.Tensor) -> torch.Tensor:
        return self.parent.engine.rmvm(self.parent, y)

    def dense(self) -> torch.Tensor:
        """The exact transposed source matrix A^T, unpadded (n, m) view."""
        return self.parent.dense().T

    def input_write_stats(self, batch: int = 1) -> WriteStats:
        """Per-execution cost of one transposed MVM (y DAC pass + EC Y^T
        replica over the row dimension)."""
        return self.parent.engine.input_write_stats(self.parent, batch,
                                                    transpose=True)


@dataclasses.dataclass(eq=False)
class AnalogMatrixGroup:
    """A stack of same-shape programmed images, executed together.

    Built by :meth:`AnalogEngine.program_group` or :meth:`AnalogEngine.group`.
    A local group holds the ``size`` members' padded images as ``(size, Mp,
    Np)`` stacks; a streamed group holds ``(size, mb, nb, cap_m, cap_n)``
    ``at_stack`` and one producer per member, ``block_fns``; a distributed
    group (``mesh_sharded``) holds each rank's ``(size, Mw, Nw)`` padded
    windows, ``at_ranks`` / ``da_ranks`` in rank order.  Member ``g``
    executes with its own base key ``member_keys[g]``, so it draws exactly
    what a solo handle with that key draws.  ``write_stats`` is the total
    over the members.
    """

    engine: "AnalogEngine"
    size: int
    shape: Tuple[int, int]          # per-member (m, n)
    base_key: int
    member_keys: List[int]
    write_stats: WriteStats
    at_pad: Optional[torch.Tensor] = None     # (size, Mp, Np)
    da_pad: Optional[torch.Tensor] = None
    calls: int = 0
    at_stack: Optional[torch.Tensor] = None   # (size, mb, nb, cap_m, cap_n)
    block_fns: Optional[Tuple[Callable, ...]] = None
    mesh_sharded: bool = False
    at_ranks: Optional[List[torch.Tensor]] = None   # per rank (size, Mw, Nw)
    da_ranks: Optional[List[torch.Tensor]] = None
    # The members' stacked AgeLedger (reliability.attach_group_age).
    ages: Optional[object] = None

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def streamed(self) -> bool:
        """True for a group of producer members."""
        return self.block_fns is not None

    @property
    def image_device(self) -> torch.device:
        if self.mesh_sharded:
            return self.engine.mesh.lead_device
        return (self.at_stack if self.streamed else self.at_pad).device

    def _blocks(self, stack: torch.Tensor) -> torch.Tensor:
        g, mp, np_ = stack.shape
        return blocks_view(stack.view(g * mp, np_),
                           self.engine.cfg.geom).unflatten(0, (g, -1))

    @property
    def at_blocks(self) -> Optional[torch.Tensor]:
        """(size, mb, nb, cap_m, cap_n) blocks of the stacked ``A_tilde``
        (no copy); None for a distributed group (per-rank windows)."""
        if self.mesh_sharded:
            return None
        return self.at_stack if self.streamed else self._blocks(self.at_pad)

    @property
    def da_blocks(self) -> Optional[torch.Tensor]:
        """(size, mb, nb, cap_m, cap_n) block view of the stacked ``dA``;
        None for a streamed or distributed group."""
        if self.streamed or self.mesh_sharded:
            return None
        return self._blocks(self.da_pad)

    def member(self, g: int) -> AnalogMatrix:
        """Member ``g`` as a standalone :class:`AnalogMatrix` on views of the
        stacks (no copy), with the member's base key, its own call counter
        and a ``1 / size`` share of the group's write cost."""
        if not 0 <= g < self.size:
            raise IndexError(f"member {g} of a size-{self.size} group")
        stats = _scale_stats(self.write_stats, 1.0 / self.size)
        if self.mesh_sharded:
            return AnalogMatrix(engine=self.engine, shape=self.shape,
                                base_key=self.member_keys[g],
                                write_stats=stats, mesh_sharded=True,
                                at_ranks=[t[g] for t in self.at_ranks],
                                da_ranks=[t[g] for t in self.da_ranks])
        if self.streamed:
            return AnalogMatrix(engine=self.engine, shape=self.shape,
                                base_key=self.member_keys[g],
                                write_stats=stats, at_stack=self.at_stack[g],
                                block_fn=self.block_fns[g])
        return AnalogMatrix(engine=self.engine, shape=self.shape,
                            base_key=self.member_keys[g], write_stats=stats,
                            at_pad=self.at_pad[g], da_pad=self.da_pad[g])

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.engine.group_mvm(self, x)

    def input_write_stats(self, batch: int = 1, *,
                          transpose: bool = False) -> WriteStats:
        """Per-execution input-write cost of the whole group (``size``
        members' DAC passes and EC replicas)."""
        one = self.engine.input_write_stats(self, batch, transpose=transpose)
        return _scale_stats(one, self.size)

    @property
    def image_nbytes(self) -> int:
        """Resident bytes of the stacked images (a streamed group's image
        alone, a distributed group's summed over the ranks; there are no
        caches)."""
        if self.mesh_sharded:
            return sum(t.nbytes for t in self.at_ranks + self.da_ranks)
        if self.streamed:
            return self.at_stack.nbytes
        return self.at_pad.nbytes + self.da_pad.nbytes

    def release(self) -> int:
        """Drop derived execution caches; the port keeps none, so 0 bytes."""
        return 0


def _dac_pass(x_pad: torch.Tensor, key: int, cfg: CrossbarConfig,
              transpose: bool, eta: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel backend's one DAC pass over a whole padded input: one
    scale, one draw from ``fold_in(key, 1)`` forward and ``fold_in(key, 2)``
    transposed (``eta`` of the input's shape replaces the draw)."""
    if not cfg.encode_inputs:
        return x_pad
    if eta is not None:
        return crossbar._encode_vec(x_pad, cfg, eta=eta)
    fold = 2 if transpose else 1
    return crossbar._encode_vec(
        x_pad, cfg, gen=generator(fold_in(key, fold), x_pad.device))


def _cuda_corrected(at: torch.Tensor, da: torch.Tensor, xb: torch.Tensor,
                    key: int, cfg: CrossbarConfig, shape: Tuple[int, int], *,
                    transpose: bool = False,
                    eta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``cuda`` backend's execute, mirroring the JAX ``_pallas_corrected``.

    One DAC pass over the whole padded input (:func:`_dac_pass`; ``eta`` of
    the padded input's shape replaces its draw), tier-1 ``A_tilde x + dA
    x_tilde`` through the ``ec_matmul`` kernel (``A_tilde^T y + dA^T
    y_tilde`` through ``ec_rmatmul``) on the live ``shape`` = (m, n) part of
    the padded images, and tier-2 through the ``stencil_denoise`` or
    ``thomas_solve`` kernel.  The padding of an image is exact zeros, so
    leaving it unread changes no term of the products.
    """
    m, n = shape
    pad_to = at.shape[0] if transpose else at.shape[1]
    width = m if transpose else n    # the live part of the contraction
    x_pad = F.pad(xb, (0, 0, 0, pad_to - xb.shape[0])).contiguous()
    x_t = _dac_pass(x_pad, key, cfg, transpose, eta)
    at, da = at[:m, :n], da[:m, :n]
    if not cfg.ec:
        return (at.T if transpose else at) @ x_t[:width]
    run = kernels.ec_rmatmul if transpose else kernels.ec_matmul
    return crossbar._denoise_output(run(at, da, x_pad[:width], x_t[:width]),
                                    cfg, use_kernel=True)


def _cuda_group_corrected(at: torch.Tensor, da: torch.Tensor,
                          xb: torch.Tensor, keys: Sequence[int],
                          cfg: CrossbarConfig, shape: Tuple[int, int], *,
                          transpose: bool = False,
                          eta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``cuda`` backend's grouped execute, mirroring the JAX
    ``_exec_group_pallas``: member ``g`` gets its own whole-vector DAC pass
    under ``keys[g]`` (``eta[g]`` replaces it), exactly as its solo
    :func:`_cuda_corrected`; then ONE grouped EC launch on the live (m, n)
    part of every member and the ``(contraction, g * batch)`` panels, and
    ONE tier-2 launch on the ``(rows, g * batch)`` output.  ``at``/``da``
    are (g, Mp, Np) stacks, ``xb`` (g, n, batch); returns (g, rows,
    batch)."""
    m, n = shape
    g, _, batch = xb.shape
    pad_to = at.shape[1] if transpose else at.shape[2]
    width, rows = (m, n) if transpose else (n, m)
    x_pad = F.pad(xb, (0, 0, 0, pad_to - xb.shape[1]))
    x_t = torch.stack([_dac_pass(x_pad[i], keys[i], cfg, transpose,
                                 None if eta is None else eta[i])
                       for i in range(g)])
    at, da = at[:, :m, :n], da[:, :m, :n]
    if not cfg.ec:
        return torch.stack([(at[i].T if transpose else at[i]) @ x_t[i, :width]
                            for i in range(g)])

    def panel(u):   # (g, pad_to, batch) -> (width, g * batch)
        return u[:, :width].transpose(0, 1).reshape(width, g * batch) \
            .contiguous()

    run = kernels.ec_group_rmatmul if transpose else kernels.ec_group_matmul
    p = crossbar._denoise_output(run(at, da, panel(x_pad), panel(x_t)), cfg,
                                 use_kernel=True)
    return p.view(rows, g, batch).transpose(0, 1).contiguous()


def _aged_execute(at_blocks: torch.Tensor, da_blocks: torch.Tensor,
                  xb: torch.Tensor, key: int, cfg: CrossbarConfig, age, *,
                  m: int, n: int, eta: Optional[torch.Tensor],
                  transpose: bool) -> torch.Tensor:
    """The ``reference`` backend's execute of an aged image: the physical
    image drifted and latched by :func:`~repro_torch.reliability.aging.
    aged_blocks`, against the program-time ``dA`` (so the corrected product
    degrades with age), through the block loop of
    :func:`crossbar.programmed_block_mvm` / ``_rmvm`` (the same draws)."""
    from .reliability.aging import aged_blocks
    aged = aged_blocks(at_blocks, age, cfg.device)
    return crossbar._sweep(lambda i, j: (aged[i, j], da_blocks[i, j]),
                           aged.shape, xb, key, cfg, m=m, n=n, tier2=True,
                           use_kernel=False, eta=eta, transpose=transpose)


class AnalogEngine:
    """Program-once / execute-many corrected-MVM engine.

    Parameters
    ----------
    cfg:
        The :class:`CrossbarConfig` of one multi-MCA system (under
        ``"distributed"``: of one rank's).
    execution:
        ``"local"`` (dense arrays) | ``"streamed"`` (``block_fn`` producers
        too) | ``"distributed"`` (either, placed over ``mesh``).
    backend:
        ``"reference"`` (plain PyTorch block pipeline) | ``"cuda"`` (the
        hand-written kernels; their plain versions on a CPU ``device``).
    device:
        Where images and executions live; ``"cuda"`` unless the caller asks
        for the CPU.  Under ``"distributed"`` the mesh's lead device (the
        default; another one raises).
    mesh, row_axes, col_axis:
        The :class:`~repro_torch.launch.mesh.Mesh` of ``"distributed"``
        execution (required there): rows split over ``row_axes``, the
        contraction over ``col_axis``.
    """

    def __init__(self, cfg: CrossbarConfig, *, execution: str = "local",
                 backend: str = "reference", device=None, mesh=None,
                 row_axes: Tuple[str, ...] = ("data",),
                 col_axis: str = "model"):
        if execution not in EXECUTION_MODES:
            raise ValueError(f"unknown execution mode {execution!r}; expected "
                             f"one of {EXECUTION_MODES}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; expected one of "
                             f"{BACKENDS}")
        if execution == "distributed" and mesh is None:
            raise ValueError("execution='distributed' requires a mesh")
        self.cfg = cfg
        self.execution = execution
        self.backend = backend
        self.mesh = mesh
        self.row_axes = tuple(row_axes)
        self.col_axis = col_axis
        if execution == "distributed":
            # Checks the axes against the mesh once, here.
            self._rank_grid = dist.RankGrid(mesh, self.row_axes, col_axis)
            if device is not None \
                    and pin_device(device) != mesh.lead_device:
                raise ValueError(f"device {device} is not the mesh's lead "
                                 f"device {mesh.lead_device}")
            self.device = mesh.lead_device
        else:
            self.device = pin_device("cuda" if device is None else device)

    @property
    def collective_axes(self) -> Tuple[str, ...]:
        """Mesh axes a distributed execution reduces over (empty for the
        single-device modes)."""
        if self.execution != "distributed":
            return ()
        return (*self.row_axes, self.col_axis)

    def _dist_kernels(self) -> bool:
        """Whether a distributed execute runs the hand-written kernels."""
        return self.backend == "cuda" and self.cfg.ec

    # ------------------------------------------------------------- programming
    def _as_tensor(self, a) -> torch.Tensor:
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return torch.as_tensor(a).to(device=self.device, dtype=torch.float32)

    def program(self, a, key: int, *, shape: Optional[Tuple[int, int]] = None,
                resident: bool = True,
                eta: Optional[torch.Tensor] = None) -> AnalogMatrix:
        """Write ``a`` onto the analog system once; returns the reusable
        handle.

        ``a`` is a dense (m, n) array, or -- under ``execution="streamed"``
        or ``"distributed"`` -- a ``block_fn(i, j)`` producer of
        capacity-sized (already padded) blocks with ``shape=(m, n)`` the
        logical size: the handle then keeps only the programmed image (see
        :func:`crossbar.streamed_program_blocks`).  ``resident=False``
        (distributed producers only) keeps no image: every execute encodes
        each block again with the same draw, uses it and drops it.  ``eta``
        replaces the programming noise draws: (mb, nb, cap_m, cap_n) of the
        global block grid, or for a dense distributed matrix each rank's
        window draws, (R, C, mb_loc, nb_loc, cap_m, cap_n).
        """
        if _is_producer(a):
            if self.execution not in ("streamed", "distributed"):
                raise ValueError("a block_fn producer requires "
                                 "execution='streamed' or 'distributed'")
            if shape is None:
                raise ValueError("program(block_fn, ...) requires "
                                 "shape=(m, n)")
            m, n = (int(v) for v in shape)
            if self.execution == "distributed":
                return self._program_distributed_streamed(a, (m, n), key,
                                                          resident, eta)
            if not resident:
                raise ValueError("resident=False requires "
                                 "execution='distributed' (streamed handles "
                                 "keep the programmed image)")
            cap_m, cap_n = self.cfg.geom.capacity
            at = crossbar.streamed_program_blocks(
                a, key, self.cfg, -(-m // cap_m), -(-n // cap_n), eta=eta,
                device=self.device)
            return AnalogMatrix(engine=self, shape=(m, n), base_key=int(key),
                                write_stats=crossbar.matrix_write_cost(
                                    m, n, self.cfg),
                                at_stack=at, block_fn=a)
        if not resident:
            raise ValueError("resident=False requires a block_fn producer "
                             "under execution='distributed'")
        a = self._as_tensor(a)
        if a.ndim != 2:
            raise ValueError(f"program expects a matrix, got shape "
                             f"{tuple(a.shape)}")
        m, n = a.shape
        if self.execution == "distributed":
            at, da, stats = dist.make_distributed_program(
                self.cfg, self.mesh, self.row_axes, self.col_axis)(
                dist.shard_matrix(a, self.mesh, self.row_axes,
                                  self.col_axis), key, eta=eta)
            return AnalogMatrix(engine=self, shape=(m, n), base_key=int(key),
                                write_stats=stats, mesh_sharded=True,
                                at_ranks=at, da_ranks=da)
        at, da = crossbar.program_blocks(a, key, self.cfg, eta=eta)
        return AnalogMatrix(engine=self, shape=(m, n), base_key=int(key),
                            write_stats=crossbar.matrix_write_cost(m, n,
                                                                   self.cfg),
                            at_pad=at, da_pad=da)

    def _program_distributed_streamed(self, block_fn, shape, key, resident,
                                      eta) -> AnalogMatrix:
        """Producer-driven distributed programming: each rank programs its
        window of the global block grid (nothing when not ``resident``); A
        never materializes."""
        m, n = shape
        cap_m, cap_n = self.cfg.geom.capacity
        mb, nb = -(-m // cap_m), -(-n // cap_n)
        grid = self._rank_grid
        if mb % grid.R or nb % grid.C:
            raise ValueError(
                f"the {mb} x {nb} capacity-block grid does not divide over "
                f"the {grid.R} x {grid.C} mesh; pick a capacity/mesh so every "
                f"rank owns an equal block window")
        if grid.R > 1 and m != mb * cap_m:
            raise ValueError(
                f"m={m} must be a multiple of the capacity row size {cap_m} "
                f"to row-shard a producer grid (produce padded blocks and "
                f"declare the padded shape)")
        if grid.C > 1 and n != nb * cap_n:
            raise ValueError(
                f"n={n} must be a multiple of the capacity column size "
                f"{cap_n} to column-shard a producer grid")
        at = None
        if resident:
            at = dist.make_distributed_streamed_program(
                block_fn, self.cfg, self.mesh, self.row_axes, self.col_axis,
                mb=mb, nb=nb)(key, eta=eta)
        # One rank's footprint; the mean over the equal windows is its cost
        # (the Figs. 4-5 convention).  Billed once, resident or not.
        m_loc = m if grid.R == 1 else (mb // grid.R) * cap_m
        n_loc = n if grid.C == 1 else (nb // grid.C) * cap_n
        return AnalogMatrix(
            engine=self, shape=(m, n), base_key=int(key),
            write_stats=crossbar.matrix_write_cost(m_loc, n_loc, self.cfg),
            block_fn=block_fn, mesh_sharded=True, at_ranks=at,
            resident=resident, program_eta=None if resident else eta)

    def encode_dense(self, a, key: int, *,
                     eta: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The programmed image of ``a`` as a dense unpadded tensor; ``eta``
        ((mb, nb, cap_m, cap_n)) replaces the programming draws."""
        a = self._as_tensor(a)
        at, _ = crossbar.program_blocks(a, key, self.cfg, eta=eta)
        return crossbar.assemble_blocks(at, *a.shape)

    # ------------------------------------------------------ group programming
    def program_group(self, source, key: int, *,
                      shape: Optional[Tuple[int, int]] = None,
                      eta: Optional[torch.Tensor] = None) -> AnalogMatrixGroup:
        """Program a stack of same-shape matrices as one group.

        ``source`` is a nested dict / list / tuple of same-shape 2-D arrays
        or tensors (the leaves stack in JAX's pytree order: dict keys
        sorted), or one ``(g, m, n)`` stack, or -- under
        ``execution="streamed"`` -- a sequence of ``block_fn(i, j)``
        producers with ``shape=(m, n)``.  Member ``g`` is programmed with
        ``fold_in(key, g)``: its image is that of a solo :meth:`program`
        under that key.  Under ``execution="distributed"`` each rank
        programs its window of every member.  ``eta`` ((g, mb, nb, cap_m,
        cap_n); distributed: (g, R, C, mb_loc, nb_loc, cap_m, cap_n))
        replaces the programming draws.
        """
        leaves = _tree_leaves(source)
        if not leaves:
            raise ValueError("program_group needs at least one member")
        producers = [f for f in leaves if _is_producer(f)]
        if producers and len(producers) != len(leaves):
            raise ValueError("program_group members must be all arrays or "
                             "all block_fn producers, not a mix")
        if producers:
            return self._program_group_streamed(tuple(producers), key,
                                                shape, eta)
        if len(leaves) == 1 and getattr(leaves[0], "ndim", 0) == 3:
            members = self._as_tensor(leaves[0])
        else:
            shapes = sorted({tuple(getattr(leaf, "shape", ()))
                             for leaf in leaves})
            if len(shapes) != 1 or len(shapes[0]) != 2:
                raise ValueError(
                    "program_group needs geometry-compatible members: every "
                    f"leaf must be the same 2-D (m, n) shape, got {shapes} "
                    "(group same-shape kernels; program the rest solo)")
            members = [self._as_tensor(leaf) for leaf in leaves]
        size = len(members)
        m, n = members[0].shape
        member_keys = [fold_in(key, g) for g in range(size)]
        if self.execution == "distributed":
            stack = members if isinstance(members, torch.Tensor) \
                else torch.stack(members)
            at, da, stats = dist.make_distributed_group_program(
                self.cfg, self.mesh, self.row_axes, self.col_axis)(
                dist.shard_matrix(stack, self.mesh, self.row_axes,
                                  self.col_axis), member_keys, eta=eta)
            del stack
            return AnalogMatrixGroup(
                engine=self, size=size, shape=(m, n), base_key=int(key),
                member_keys=member_keys, write_stats=stats,
                mesh_sharded=True, at_ranks=at, da_ranks=da)
        at, da = crossbar.group_program_blocks(members, member_keys, self.cfg,
                                               eta=eta)
        return AnalogMatrixGroup(
            engine=self, size=size, shape=(m, n), base_key=int(key),
            member_keys=member_keys,
            write_stats=_scale_stats(
                crossbar.matrix_write_cost(m, n, self.cfg), size),
            at_pad=at, da_pad=da)

    def _program_group_streamed(self, block_fns, key, shape, eta
                                ) -> AnalogMatrixGroup:
        if self.execution == "distributed":
            raise ValueError(
                "program_group does not take producer groups under "
                "execution='distributed' (one producer already programs the "
                "whole mesh); program members individually or use "
                "execution='streamed'")
        if self.execution != "streamed":
            raise ValueError("a producer group requires execution='streamed'")
        if shape is None:
            raise ValueError("program_group(producers, ...) requires "
                             "shape=(m, n)")
        m, n = (int(v) for v in shape)
        cap_m, cap_n = self.cfg.geom.capacity
        size = len(block_fns)
        member_keys = [fold_in(key, g) for g in range(size)]
        at = crossbar.grouped_streamed_program_blocks(
            block_fns, member_keys, self.cfg, -(-m // cap_m), -(-n // cap_n),
            eta=eta, device=self.device)
        return AnalogMatrixGroup(
            engine=self, size=size, shape=(m, n), base_key=int(key),
            member_keys=member_keys,
            write_stats=_scale_stats(
                crossbar.matrix_write_cost(m, n, self.cfg), size),
            at_stack=at, block_fns=block_fns)

    def group(self, handles: Sequence[AnalogMatrix]) -> AnalogMatrixGroup:
        """Stack programmed handles into a group, no re-programming: member
        ``g`` is ``handles[g]``'s image bit for bit, with its base key.
        Members share this engine's configuration and one (m, n) shape, and
        are all local or all streamed, and none has an age attached (group
        first, then age the group with ``attach_group_age``)."""
        handles = list(handles)
        if not handles:
            raise ValueError("group() needs at least one handle")
        shapes = sorted({h.shape for h in handles})
        if len(shapes) != 1:
            raise ValueError("group() members must be geometry-compatible "
                             f"(one shared (m, n) shape); got {shapes}")
        for g, h in enumerate(handles):
            if isinstance(h, TransposedAnalogMatrix):
                raise ValueError("group() stacks forward handles; run the "
                                 "transposed direction through group_rmvm")
            if not isinstance(h, AnalogMatrix):
                raise TypeError(f"group() member {g} is a "
                                f"{type(h).__name__}, not an AnalogMatrix")
            if h.engine is not self and h.engine.cfg != self.cfg:
                raise ValueError(f"group() member {g} was programmed by an "
                                 "incompatible engine configuration")
            if h.mesh_sharded:
                raise ValueError("group() stacks local handles; distributed "
                                 "images group at program time via "
                                 "program_group")
            if h.age is not None:
                raise ValueError(
                    f"group() member {g} has an AgeLedger attached; group "
                    "first, then age the group via attach_group_age")
            if h.image_device != self.device:
                raise ValueError(f"group() member {g} lives on "
                                 f"{h.image_device}, this engine on "
                                 f"{self.device}")
        if len({h.streamed for h in handles}) != 1:
            raise ValueError("group() members must be all local or all "
                             "streamed")
        total = WriteStats(
            energy_j=sum(h.write_stats.energy_j for h in handles),
            latency_s=sum(h.write_stats.latency_s for h in handles),
            iterations=handles[0].write_stats.iterations,
            final_delta=max(h.write_stats.final_delta for h in handles))
        common = dict(engine=self, size=len(handles), shape=handles[0].shape,
                      base_key=handles[0].base_key,
                      member_keys=[h.base_key for h in handles],
                      write_stats=total)
        if handles[0].streamed:
            return AnalogMatrixGroup(
                **common, at_stack=torch.stack([h.at_stack for h in handles]),
                block_fns=tuple(h.block_fn for h in handles))
        return AnalogMatrixGroup(
            **common, at_pad=torch.stack([h.at_pad for h in handles]),
            da_pad=torch.stack([h.da_pad for h in handles]))

    # --------------------------------------------------------------- execution
    def mvm(self, A: AnalogMatrix, x, *, key: Optional[int] = None,
            eta: Optional[torch.Tensor] = None,
            advance_age: bool = True) -> torch.Tensor:
        """Corrected MVM against the programmed image: zero re-encode work.

        ``x``: (n,) or (n, batch).  ``key`` overrides the call's DAC key;
        by default call ``c`` uses the handle's key schedule.  ``eta``
        replaces the DAC draws: ``(Np, batch)`` for a local handle on
        ``backend="cuda"``, ``(R, C, mb_loc, nb_loc, cap_n, batch)`` for a
        dense distributed one, ``(mb, nb, cap_n, batch)`` otherwise (the
        ``"reference"`` backend, and a producer handle on either).  A
        handle with an age attached executes its aged image and, with
        ``advance_age``, adds one read disturb to its ledger (a solver's
        operator passes False: a solve holds the age fixed).
        """
        y, _ = self._execute(A, x, key, eta, advance_age=advance_age)
        return y

    def mvm_with_stats(self, A: AnalogMatrix, x, *, key: Optional[int] = None,
                       eta: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, WriteStats]:
        """Like :meth:`mvm` but also returns this call's input-write cost."""
        return self._execute(A, x, key, eta, with_stats=True)

    def rmvm(self, A: AnalogMatrix, y, *, key: Optional[int] = None,
             eta: Optional[torch.Tensor] = None,
             advance_age: bool = True) -> torch.Tensor:
        """Corrected transposed MVM ``A.T @ y`` against the same image.

        ``y``: (m,) or (m, batch); returns (n,) / (n, batch).  Only ``y``
        passes the DAC; tier-2 runs over the column output.  ``eta``
        replaces the DAC draws: ``(Mp, batch)`` for a local handle on
        ``backend="cuda"``, ``(R, C, mb_loc, nb_loc, cap_m, batch)`` for a
        dense distributed one, ``(mb, nb, cap_m, batch)`` otherwise.
        ``advance_age`` as for :meth:`mvm`.
        """
        z, _ = self._execute(A, y, key, eta, transpose=True,
                             advance_age=advance_age)
        return z

    def rmvm_with_stats(self, A: AnalogMatrix, y, *, key: Optional[int] = None,
                        eta: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, WriteStats]:
        """Like :meth:`rmvm` but also returns this call's input-write cost."""
        return self._execute(A, y, key, eta, with_stats=True, transpose=True)

    def input_write_stats(self, A: AnalogMatrix, batch: int = 1, *,
                          transpose: bool = False) -> WriteStats:
        """Per-execution input-write cost (x DAC pass + EC X^T replica;
        ``transpose=True``: the m-length y pass + the row-dimension replica).
        Under ``execution="distributed"`` one rank's, the paper's Figs. 4-5
        convention: the ceil-divided footprint, what a placement would pad
        onto its largest window."""
        m, n = A.m, A.n
        if self.execution == "distributed":
            m = -(-m // self._rank_grid.R)
            n = -(-n // self._rank_grid.C)
        return crossbar.input_write_cost(m, n, self.cfg, batch=batch,
                                         transpose=transpose)

    def _execute(self, A, x, key, eta, *, with_stats=False, transpose=False,
                 advance_age=True):
        if isinstance(A, AnalogMatrixGroup):
            raise TypeError("mvm takes an AnalogMatrix; execute a group with "
                            "group_mvm / group_rmvm / chain_mvm")
        if isinstance(A, TransposedAnalogMatrix):
            # A view executes as the opposite direction of its parent, after
            # the same engine check as a direct call.
            if A.parent.engine is not self and A.parent.engine.cfg != self.cfg:
                raise ValueError("AnalogMatrix was programmed by an "
                                 "incompatible engine configuration")
            return A.parent.engine._execute(A.parent, x, key, eta,
                                            with_stats=with_stats,
                                            transpose=not transpose,
                                            advance_age=advance_age)
        if A.engine is not self and A.engine.cfg != self.cfg:
            raise ValueError("AnalogMatrix was programmed by an incompatible "
                             "engine configuration")
        self._check_placement(A, "AnalogMatrix")
        if A.image_device != self.device:
            raise ValueError(f"AnalogMatrix lives on {A.image_device} but "
                             f"this engine executes on {self.device}")
        x = self._as_tensor(x)
        squeeze = x.ndim == 1
        xb = x[:, None] if squeeze else x
        m, n = A.shape
        if xb.shape[0] != (m if transpose else n):
            direction = "A.T @ y" if transpose else "A @ x"
            raise ValueError(f"{direction}: input has {xb.shape[0]} rows but "
                             f"the programmed matrix is {m} x {n}")
        if key is None:
            # One call counter for both directions, as the JAX handle has.
            key = A.base_key if A.calls == 0 else fold_in(A.base_key, A.calls)
        if A.age is not None and (A.streamed or A.mesh_sharded
                                  or self.backend != "reference"):
            raise ValueError(
                "an AgeLedger is attached but this execution path cannot "
                "apply it: aged execution needs execution='local', "
                "backend='reference' and resident at/da blocks")
        A.calls += 1
        if A.mesh_sharded:
            return self._execute_distributed(A, xb, key, eta, squeeze,
                                             with_stats, transpose)
        if A.age is not None:
            p = _aged_execute(A.at_blocks, A.da_blocks, xb, key, self.cfg,
                              A.age, m=m, n=n, eta=eta, transpose=transpose)
            if advance_age:
                A.age = A.age.advanced(1)
        elif A.streamed:
            run = crossbar.streamed_block_rmvm if transpose \
                else crossbar.streamed_block_mvm
            p = self._streamed_tier2(
                run(A.block_fn, A.at_stack, xb, key, self.cfg, m=m, n=n,
                    **self._streamed_kw(), eta=eta))
        elif self.backend == "cuda":
            p = _cuda_corrected(A.at_pad, A.da_pad, xb, key, self.cfg,
                                (m, n), transpose=transpose, eta=eta)
        else:
            run = crossbar.programmed_block_rmvm if transpose \
                else crossbar.programmed_block_mvm
            p = run(A.at_pad, A.da_pad, xb, key, self.cfg, m=m, n=n, eta=eta)
        stats = self.input_write_stats(A, xb.shape[1], transpose=transpose) \
            if with_stats else None
        return (p[:, 0] if squeeze else p), stats

    def _check_placement(self, A, what: str) -> None:
        """A handle runs only on the placement that programmed it: a
        distributed engine takes mesh-sharded operands (on its own mesh and
        axes), the other engines take none."""
        if self.execution == "distributed":
            if not A.mesh_sharded:
                raise ValueError(
                    f"{what} holds a local or streamed image but this engine "
                    f"executes distributed; program it with the distributed "
                    f"engine")
            e = A.engine
            if (e.mesh, e.row_axes, e.col_axis) != \
                    (self.mesh, self.row_axes, self.col_axis):
                raise ValueError(f"{what} was placed on another mesh or "
                                 f"other axes than this engine's")
        elif A.mesh_sharded:
            raise ValueError(
                f"{what} holds mesh-sharded operands but this engine "
                f"executes {self.execution!r}; program it with this engine")

    def _execute_distributed(self, A, xb, key, eta, squeeze, with_stats,
                             transpose):
        """A distributed execute: every rank's window through the dense or
        streamed stages, the partials summed over the contraction axis,
        tier-2 per output segment, one global output."""
        m, n = A.shape
        axes = (self.mesh, self.row_axes, self.col_axis)
        kernel = self._dist_kernels()
        if A.streamed:
            mb, nb = A._grid()
            make = dist.make_distributed_streamed_rmvm if transpose \
                else dist.make_distributed_streamed_mvm
            p = make(A.block_fn, self.cfg, *axes, m=m, n=n, mb=mb, nb=nb,
                     resident=A.resident, use_kernel=kernel)(
                A.at_ranks, xb, key, eta=eta, program_eta=A.program_eta,
                program_key=A.base_key)
            stats = self.input_write_stats(A, xb.shape[1],
                                           transpose=transpose) \
                if with_stats else None
        else:
            make = dist.make_distributed_rmvm if transpose \
                else dist.make_distributed_programmed_mvm
            p, stats = make(self.cfg, *axes, use_kernel=kernel)(
                A.at_ranks, A.da_ranks, xb, key, shape=(m, n), eta=eta)
            stats = stats if with_stats else None
        return (p[:, 0] if squeeze else p), stats

    def _streamed_kw(self) -> dict:
        """The streamed stages' switches on this backend: the ``cuda``
        backend runs each block's tier-1 product through the EC kernel and
        leaves tier-2 to :meth:`_streamed_tier2`."""
        cuda = self.backend == "cuda"
        return dict(use_kernel=cuda and self.cfg.ec, tier2=not cuda)

    def _streamed_tier2(self, p: torch.Tensor) -> torch.Tensor:
        """Tier-2 of a streamed execute on the ``cuda`` backend: one stencil
        or Thomas launch on the assembled ``(rows, columns)`` output, or on
        ``(g, rows, batch)`` as one ``(rows, g * batch)`` panel."""
        if self.backend != "cuda":
            return p
        return crossbar._denoise_output(p, self.cfg, use_kernel=True)

    # --------------------------------------------------------- group execution
    def group_mvm(self, G: AnalogMatrixGroup, x, *, key: Optional[int] = None,
                  eta: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Corrected MVM of every member of ``G``.

        ``x`` is ``(n,)`` / ``(n, batch)`` (the same input to every member)
        or ``(size, n)`` / ``(size, n, batch)`` (one per member; a 2-D shape
        that is both reads per member).  Returns ``(size, m)`` /
        ``(size, m, batch)``.  ``key`` gives member ``g`` the call key
        ``fold_in(key, g)``; by default member ``g``'s call ``c`` draws what
        a solo handle with key ``member_keys[g]`` draws on its call ``c``.
        ``eta`` replaces the DAC draws: ``(size, Np, batch)`` for a local
        group on ``backend="cuda"``, ``(size, R, C, mb_loc, nb_loc, cap_n,
        batch)`` for a distributed one, ``(size, mb, nb, cap_n, batch)``
        otherwise.
        """
        y, _ = self._group_execute(G, x, key, eta)
        return y

    def group_mvm_with_stats(self, G: AnalogMatrixGroup, x, *,
                             key: Optional[int] = None,
                             eta: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, WriteStats]:
        """Like :meth:`group_mvm` plus the whole group's input-write cost."""
        return self._group_execute(G, x, key, eta, with_stats=True)

    def group_rmvm(self, G: AnalogMatrixGroup, y, *, key: Optional[int] = None,
                   eta: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Corrected ``A_g.T @ y_g`` of every member against the same
        stacks (``y``: ``(m,)``, ``(m, batch)``, ``(size, m)`` or
        ``(size, m, batch)``; ``eta`` ``(size, Mp, batch)`` for a local
        group on ``"cuda"``, ``(size, mb, nb, cap_m, batch)`` otherwise)."""
        z, _ = self._group_execute(G, y, key, eta, transpose=True)
        return z

    def group_rmvm_with_stats(self, G: AnalogMatrixGroup, y, *,
                              key: Optional[int] = None,
                              eta: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, WriteStats]:
        """Like :meth:`group_rmvm` plus the group's input-write cost."""
        return self._group_execute(G, y, key, eta, with_stats=True,
                                   transpose=True)

    def chain_mvm(self, G: AnalogMatrixGroup, x, *, key: Optional[int] = None,
                  activation: Optional[str] = None,
                  eta: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Chained forward: member 0's output feeds member 1's input and so
        on, with ``activation`` (a :data:`CHAIN_ACTIVATIONS` name or None)
        between members.  Members must be square; ``x`` is (n,) or
        (n, batch).  Member ``g`` runs :func:`crossbar.programmed_block_mvm`
        under its key (per-block DAC draws; ``eta[g]`` of shape
        (mb, nb, cap_n, batch) replaces them), through the ``ec_matmul``
        kernel per capacity block on ``backend="cuda"``: a host loop of
        per-block launches, as the JAX scan body runs its tile step.
        """
        if isinstance(G, (AnalogMatrix, TransposedAnalogMatrix)):
            raise TypeError("chain_mvm takes an AnalogMatrixGroup; wrap solo "
                            "handles with engine.group([...])")
        self._check_group(G)
        if G.streamed or G.mesh_sharded:
            raise ValueError("chain_mvm needs a LOCAL resident group (dense "
                             "members with stacked at/da images)")
        if G.ages is not None:
            raise ValueError("chain_mvm does not apply attached ages; "
                             "detach them or use group_mvm")
        if G.m != G.n:
            raise ValueError(
                f"chain_mvm threads each member's output into the next, so "
                f"members must be square; the group is {G.m} x {G.n}")
        if activation not in CHAIN_ACTIVATIONS:
            names = sorted(k for k in CHAIN_ACTIVATIONS if k is not None)
            raise ValueError(f"unknown chain activation {activation!r}; "
                             f"expected None or one of {names}")
        x = self._as_tensor(x)
        squeeze = x.ndim == 1
        y = x[:, None] if squeeze else x
        if y.ndim != 2 or y.shape[0] != G.n:
            raise ValueError(f"chain_mvm: input of shape {tuple(x.shape)} "
                             f"does not fit members of {G.m} x {G.n}")
        keys = self._group_keys(G, key)
        G.calls += 1
        use_kernel = self.backend == "cuda" and self.cfg.ec
        act = CHAIN_ACTIVATIONS[activation]
        for g in range(G.size):
            y = act(crossbar.programmed_block_mvm(
                G.at_pad[g], G.da_pad[g], y, keys[g], self.cfg, m=G.m, n=G.n,
                use_kernel=use_kernel, eta=None if eta is None else eta[g]))
        return y[:, 0] if squeeze else y

    # ---------------------------------------------------------- analysis hooks
    def mvm_fn(self, A: AnalogMatrix, *, transpose: bool = False):
        """A ``(vec, key) -> out`` closure over a programmed handle: the
        call :meth:`mvm` (or :meth:`rmvm`) makes, which
        :mod:`repro_torch.analysis` measures and the solver cores take as
        their operator's matvec."""
        if transpose:
            return lambda y, key: self.rmvm(A, y, key=key)
        return lambda x, key: self.mvm(A, x, key=key)

    def group_mvm_fn(self, G: AnalogMatrixGroup, *, transpose: bool = False):
        """The :meth:`mvm_fn` of a group: ``(vec, key) -> out`` over
        :meth:`group_mvm` (or :meth:`group_rmvm`)."""
        if transpose:
            return lambda y, key: self.group_rmvm(G, y, key=key)
        return lambda x, key: self.group_mvm(G, x, key=key)

    def chain_fn(self, G: AnalogMatrixGroup, *,
                 activation: Optional[str] = None):
        """A ``(vec, key) -> out`` closure over :meth:`chain_mvm`."""
        return lambda x, key: self.chain_mvm(G, x, key=key,
                                             activation=activation)

    def _check_group(self, G) -> None:
        if not isinstance(G, AnalogMatrixGroup):
            raise TypeError("group execution takes an AnalogMatrixGroup; use "
                            "engine.mvm for solo handles")
        if G.engine is not self and G.engine.cfg != self.cfg:
            raise ValueError("AnalogMatrixGroup was programmed by an "
                             "incompatible engine configuration")
        self._check_placement(G, "AnalogMatrixGroup")
        if G.image_device != self.device:
            raise ValueError(f"AnalogMatrixGroup lives on {G.image_device} "
                             f"but this engine executes on {self.device}")

    def _group_keys(self, G: AnalogMatrixGroup, key: Optional[int]
                    ) -> List[int]:
        """Per-member call keys: an explicit ``key`` fans out as
        ``fold_in(key, g)``; by default member ``g``'s key is folded by the
        group's call counter as a solo handle's is by its own."""
        if key is not None:
            return [fold_in(key, g) for g in range(G.size)]
        if G.calls == 0:
            return list(G.member_keys)
        return [fold_in(k, G.calls) for k in G.member_keys]

    def _group_input(self, G: AnalogMatrixGroup, x: torch.Tensor,
                     transpose: bool) -> Tuple[torch.Tensor, bool]:
        """The input as (size, contraction, batch), and whether the caller's
        form had no batch axis."""
        contraction = G.m if transpose else G.n
        direction = "G.T @ y" if transpose else "G @ x"
        if x.ndim == 1:
            if x.shape[0] != contraction:
                raise ValueError(f"{direction}: input has {x.shape[0]} rows "
                                 f"but members are {G.m} x {G.n}")
            return x[None, :, None].expand(G.size, contraction, 1), True
        if x.ndim == 2:
            if tuple(x.shape) == (G.size, contraction):
                return x[:, :, None], True
            if x.shape[0] == contraction:
                return x[None].expand((G.size,) + tuple(x.shape)), False
            raise ValueError(
                f"{direction}: 2-D input must be ({contraction}, batch) or "
                f"(size={G.size}, {contraction}); got {tuple(x.shape)}")
        if x.ndim == 3:
            if x.shape[0] != G.size or x.shape[1] != contraction:
                raise ValueError(
                    f"{direction}: 3-D input must be (size={G.size}, "
                    f"{contraction}, batch); got {tuple(x.shape)}")
            return x, False
        raise ValueError(f"{direction}: input must be 1-, 2- or 3-D")

    def _group_execute(self, G, x, key, eta, *, with_stats=False,
                       transpose=False):
        self._check_group(G)
        if G.ages is not None and (G.streamed or G.mesh_sharded
                                   or self.backend != "reference"):
            raise ValueError(
                "aged group execution needs execution='local', "
                "backend='reference' and resident da blocks")
        xb, squeeze = self._group_input(G, self._as_tensor(x), transpose)
        keys = self._group_keys(G, key)
        G.calls += 1
        m, n = G.shape
        if G.mesh_sharded:
            make = dist.make_distributed_group_rmvm if transpose \
                else dist.make_distributed_group_mvm
            p, stats = make(self.cfg, self.mesh, self.row_axes,
                            self.col_axis, use_kernel=self._dist_kernels())(
                G.at_ranks, G.da_ranks, xb, keys, shape=(m, n), eta=eta)
            return (p[:, :, 0] if squeeze else p), \
                (stats if with_stats else None)
        if G.ages is not None:
            at_b, da_b = G.at_blocks, G.da_blocks
            p = torch.stack([_aged_execute(
                at_b[g], da_b[g], xb[g], keys[g], self.cfg, G.ages.member(g),
                m=m, n=n, eta=None if eta is None else eta[g],
                transpose=transpose) for g in range(G.size)])
            G.ages = G.ages.advanced(1)
        elif G.streamed:
            run = crossbar.grouped_streamed_block_rmvm if transpose \
                else crossbar.grouped_streamed_block_mvm
            p = self._streamed_tier2(
                run(G.block_fns, G.at_stack, xb, keys, self.cfg, m=m, n=n,
                    **self._streamed_kw(), eta=eta))
        elif self.backend == "cuda":
            p = _cuda_group_corrected(G.at_pad, G.da_pad, xb, keys, self.cfg,
                                      (m, n), transpose=transpose, eta=eta)
        else:
            run = crossbar.grouped_block_rmvm if transpose \
                else crossbar.grouped_block_mvm
            p = run(G.at_pad, G.da_pad, xb, keys, self.cfg, m=m, n=n, eta=eta)
        stats = G.input_write_stats(xb.shape[2], transpose=transpose) \
            if with_stats else None
        return (p[:, :, 0] if squeeze else p), stats
