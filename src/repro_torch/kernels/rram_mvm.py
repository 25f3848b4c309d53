"""Fused tier-1 error-corrected products, forward and transposed, solo and
grouped (port of :func:`repro.kernels.rram_mvm.ec_matmul`, of the same call
read backwards, ``repro.kernels.ops.rram_ec_tile_rmvm``, and of the grouped
wrappers ``ops.rram_ec_group_mvm`` / ``ops.rram_ec_group_rmvm``).

  * ``ec_matmul(at, da, x, x_t) = at @ x + da @ x_t``: (M, K) images,
    (K, batch) panels, (M, batch) out;
  * ``ec_rmatmul(at, da, y, y_t) = at.T @ y + da.T @ y_t``: the same images
    read backwards, (M, batch) panels, (K, batch) out;
  * ``ec_group_matmul`` / ``ec_group_rmatmul``: the same for a stack of g
    images ``(g, M, K)`` in one launch, on panels that hold member g's
    columns at ``g * batch`` (``(K, g * batch)`` in, ``(M, g * batch)`` out
    forward), so the tier-2 kernels take the output panel as it is.

fp32 accumulation, fp32 out.  The images are row-major with unit column
stride and may have a row stride larger than their width, so one capacity
block of a padded image runs as a view without a copy; the panels are
contiguous.  On CUDA tensors the wrappers launch the hand-written kernels in
``csrc/rram_mvm.cu`` (memory-bound GEMVs: each reads the images once over a
persistent one-wave grid, staging them by the TMA engine where they are
16-byte aligned; a solo product is the grouped launcher with one member;
see :func:`matmul_layout` and :func:`rmatmul_layout`); on CPU tensors they
run the ``*_plain`` versions.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from . import build
from ._checks import check_images, check_panels, on_cpu, row_stride

__all__ = ["ec_matmul", "ec_matmul_plain", "ec_rmatmul", "ec_rmatmul_plain",
           "ec_group_matmul", "ec_group_matmul_plain", "ec_group_rmatmul",
           "ec_group_rmatmul_plain", "matmul_layout", "MatmulLayout",
           "rmatmul_layout", "RmatmulLayout", "MAX_KERNEL_BATCH"]

#: Widest panel one launch takes; wider panels are split into launches of
#: this many columns (each re-reads the images).
MAX_KERNEL_BATCH = 8


def ec_matmul_plain(at: torch.Tensor, da: torch.Tensor, x: torch.Tensor,
                    x_t: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: two float32 products and a sum."""
    return at @ x + da @ x_t


def ec_rmatmul_plain(at: torch.Tensor, da: torch.Tensor, y: torch.Tensor,
                     y_t: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: two float32 products through transposed
    views (no copy) and a sum."""
    return at.T @ y + da.T @ y_t


def _members(panel: torch.Tensor, g: int):
    """The g contiguous ``(rows, batch)`` member panels of a
    ``(rows, g * batch)`` group panel."""
    return [c.contiguous() for c in panel.chunk(g, dim=1)]


def ec_group_matmul_plain(at: torch.Tensor, da: torch.Tensor, x: torch.Tensor,
                          x_t: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: :func:`ec_matmul_plain` member by member,
    each member's columns of the panels, concatenated back."""
    g = at.shape[0]
    return torch.cat([ec_matmul_plain(at[i], da[i], u, u_t) for i, (u, u_t)
                      in enumerate(zip(_members(x, g), _members(x_t, g)))],
                     dim=1)


def ec_group_rmatmul_plain(at: torch.Tensor, da: torch.Tensor,
                           y: torch.Tensor, y_t: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: :func:`ec_rmatmul_plain` member by member."""
    g = at.shape[0]
    return torch.cat([ec_rmatmul_plain(at[i], da[i], u, u_t) for i, (u, u_t)
                      in enumerate(zip(_members(y, g), _members(y_t, g)))],
                     dim=1)


def _check(name, at, da, u, u_t, contraction: int) -> None:
    check_panels(name, u, u_t)
    check_images(name, at, da, u.device)
    if u.ndim != 2 or u_t.shape != u.shape or u.shape[0] != contraction:
        raise ValueError(
            f"{name}: images {tuple(at.shape)}/{tuple(da.shape)} do not "
            f"match panels {tuple(u.shape)}/{tuple(u_t.shape)}")


def _check_group(name, at, da, u, u_t, contraction: int) -> int:
    """Check a grouped call; returns the columns per member."""
    if not (isinstance(at, torch.Tensor) and isinstance(da, torch.Tensor)) \
            or at.ndim != 3 or da.ndim != 3:
        raise ValueError(f"{name}: images must be (g, M, K) stacks")
    g = at.shape[0]
    if g < 1 or da.shape[0] != g or at.stride(0) != da.stride(0):
        raise ValueError(f"{name}: image stacks {tuple(at.shape)} and "
                         f"{tuple(da.shape)} differ")
    _check(name, at[0], da[0], u, u_t, contraction)
    if u.shape[1] % g or u.shape[1] == 0:
        raise ValueError(f"{name}: panel of {u.shape[1]} columns does not "
                         f"split into {g} members")
    return u.shape[1] // g


def _launch_ec(kernel: str, at, da, u, u_t, transpose: bool,
               g: int = 1, member_ld: int = 0) -> torch.Tensor:
    """One launch per :data:`MAX_KERNEL_BATCH` columns of every member of
    the images ``at``/``da`` (a (M, K) image, or its (g, M, K) stack)."""
    img = at[0] if at.ndim == 3 else at
    img_stride = at.stride(0) if at.ndim == 3 else 0
    m, k = img.shape
    batch = member_ld or u.shape[1]
    out = torch.empty(k if transpose else m, u.shape[1], dtype=torch.float32,
                      device=u.device)
    ld = u.shape[1]
    query = rmatmul_layout if transpose else matmul_layout
    for c0 in range(0, batch, MAX_KERNEL_BATCH):
        cols = min(MAX_KERNEL_BATCH, batch - c0)
        floats = query(at, da, cols).workspace_floats
        ws = torch.empty(floats, dtype=torch.float32, device=u.device)
        args = (at.data_ptr(), da.data_ptr(), u[:, c0:].data_ptr(),
                u_t[:, c0:].data_ptr(), out[:, c0:].data_ptr(),
                ws.data_ptr() if floats else None, floats, g, img_stride,
                member_ld, m, k, row_stride(img), cols, ld)
        if transpose:
            build.launch(kernel, "repro_ec_rmatmul", u.device, *args, ld)
        else:
            build.launch(kernel, "repro_ec_matmul", u.device, *args)
    return out


def ec_matmul(at: torch.Tensor, da: torch.Tensor, x: torch.Tensor,
              x_t: torch.Tensor) -> torch.Tensor:
    """``at @ x + da @ x_t`` for (M, K) images and (K, batch) panels.  Each
    row is summed over 4,096-column pieces of K in a fixed order and the
    pieces are added in order, so the result depends on K alone: the same
    run to run, whatever the grid (:func:`matmul_layout`)."""
    _check("ec_matmul", at, da, x, x_t, at.shape[-1])
    if on_cpu(x):
        return ec_matmul_plain(at, da, x, x_t)
    return _launch_ec("ec_matmul", at, da, x, x_t, transpose=False)


class MatmulLayout(NamedTuple):
    """How the forward launcher runs a call (``repro_ec_matmul_workspace``
    in ``csrc/rram_mvm.cu``): the staged (TMA) kernel or register loads, a
    persistent grid of ``blocks`` = ``blocks_per_sm`` x ``sms`` (or one
    block a unit, if fewer), ``units`` of ``rows_per_unit`` rows x
    ``cols_per_unit`` columns (a piece of K) cut among them in order, K in
    ``pieces`` pieces, and the workspace floats: the pieces' partial sums
    when there is more than one, and for the staged kernel x and x_tilde
    packed."""
    workspace_floats: int
    staged: bool
    blocks: int
    blocks_per_sm: int
    sms: int
    units: int
    rows_per_unit: int
    cols_per_unit: int
    pieces: int


class RmatmulLayout(NamedTuple):
    """How the transposed launcher runs a call (``repro_ec_rmatmul_workspace``
    in ``csrc/rram_mvm.cu``): the staged (TMA) kernel or register loads, a
    persistent grid of ``blocks`` = ``blocks_per_sm`` x ``sms`` (or one
    block a unit, if fewer), ``units`` of ``rows_per_unit`` x
    ``cols_per_unit`` cut among them in order, at most
    ``partials_per_block`` partial panels a block, and the workspace floats
    those take."""
    workspace_floats: int
    staged: bool
    blocks: int
    blocks_per_sm: int
    sms: int
    units: int
    rows_per_unit: int
    cols_per_unit: int
    partials_per_block: int


_LAYOUTS: Dict[tuple, tuple] = {}


def _layout(kind, symbol: str, at: torch.Tensor, da: torch.Tensor,
            batch: int):
    """Ask the launcher's query ``symbol`` for its layout, once per key."""
    img = at[0] if at.ndim == 3 else at
    g, img_stride = (at.shape[0], at.stride(0)) if at.ndim == 3 else (1, 0)
    (m, k), lda = img.shape, row_stride(img)
    key = (symbol, g, m, k, lda, img_stride, batch, at.data_ptr() % 16,
           da.data_ptr() % 16, at.device)
    if key not in _LAYOUTS:
        got = (ctypes.c_longlong * len(kind._fields))()
        build.query(symbol, at.device, at.data_ptr(), da.data_ptr(), g,
                    img_stride, m, k, lda, batch, got)
        _LAYOUTS[key] = kind(got[0], bool(got[1]), *got[2:])
    return _LAYOUTS[key]


def matmul_layout(at: torch.Tensor, da: torch.Tensor,
                  batch: int) -> MatmulLayout:
    """The layout of one forward launch on CUDA images ``at``/``da`` ((M,
    K), or a (g, M, K) stack) at ``batch`` (1..8) columns a member.  The
    launcher decides it alone, from the shapes, strides, batch, the device
    and the images' 16-byte alignment; it is asked once per such key."""
    return _layout(MatmulLayout, "repro_ec_matmul_workspace", at, da, batch)


def rmatmul_layout(at: torch.Tensor, da: torch.Tensor,
                   batch: int) -> RmatmulLayout:
    """The layout of one transposed launch, as :func:`matmul_layout`."""
    return _layout(RmatmulLayout, "repro_ec_rmatmul_workspace", at, da,
                   batch)


def ec_rmatmul(at: torch.Tensor, da: torch.Tensor, y: torch.Tensor,
               y_t: torch.Tensor) -> torch.Tensor:
    """``at.T @ y + da.T @ y_t`` for (M, K) images and (M, batch) panels;
    returns (K, batch).  The kernel's blocks each sum a fixed range of row
    chunks, and a second pass adds their partials in a fixed order: the
    result is the same run to run (:func:`rmatmul_layout`)."""
    _check("ec_rmatmul", at, da, y, y_t, at.shape[0])
    if on_cpu(y):
        return ec_rmatmul_plain(at, da, y, y_t)
    return _launch_ec("ec_rmatmul", at, da, y, y_t, transpose=True)


def ec_group_matmul(at: torch.Tensor, da: torch.Tensor, x: torch.Tensor,
                    x_t: torch.Tensor) -> torch.Tensor:
    """``at[g] @ x_g + da[g] @ x_t_g`` for every member g of (g, M, K)
    image stacks in one launch; ``x``/``x_t`` are (K, g * batch) panels with
    member g's columns at ``g * batch``; returns the (M, g * batch) panel
    laid out the same way.  Member g's columns equal the solo
    :func:`ec_matmul` on member g bit for bit."""
    batch = _check_group("ec_group_matmul", at, da, x, x_t, at.shape[-1])
    if on_cpu(x):
        return ec_group_matmul_plain(at, da, x, x_t)
    return _launch_ec("ec_group_matmul", at, da, x, x_t, transpose=False,
                      g=at.shape[0], member_ld=batch)


def ec_group_rmatmul(at: torch.Tensor, da: torch.Tensor, y: torch.Tensor,
                     y_t: torch.Tensor) -> torch.Tensor:
    """``at[g].T @ y_g + da[g].T @ y_t_g`` for every member g in one launch:
    (M, g * batch) panels in, the (K, g * batch) panel out, member g's
    columns at ``g * batch``.  The rows are cut for the whole group, so a
    member's sums may be cut otherwise than a solo :func:`ec_rmatmul` cuts
    them (equal to fp32 rounding); a group of one is the solo call."""
    batch = _check_group("ec_group_rmatmul", at, da, y, y_t, at.shape[1])
    if on_cpu(y):
        return ec_group_rmatmul_plain(at, da, y, y_t)
    return _launch_ec("ec_group_rmatmul", at, da, y, y_t, transpose=True,
                      g=at.shape[0], member_ld=batch)
