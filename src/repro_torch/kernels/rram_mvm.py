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
``csrc/rram_mvm.cu`` (memory-bound GEMVs: each reads the images once; a solo
product is the grouped launcher with one member); on CPU tensors they run the
``*_plain`` versions.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from ._checks import check_images, check_panels, on_cpu, row_stride

__all__ = ["ec_matmul", "ec_matmul_plain", "ec_rmatmul", "ec_rmatmul_plain",
           "ec_group_matmul", "ec_group_matmul_plain", "ec_group_rmatmul",
           "ec_group_rmatmul_plain", "MAX_KERNEL_BATCH"]

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
    for c0 in range(0, batch, MAX_KERNEL_BATCH):
        cols = min(MAX_KERNEL_BATCH, batch - c0)
        ptrs = (at.data_ptr(), da.data_ptr(), u[:, c0:].data_ptr(),
                u_t[:, c0:].data_ptr(), out[:, c0:].data_ptr())
        if not transpose:
            build.launch(kernel, "repro_ec_matmul", u.device, *ptrs, g,
                         img_stride, member_ld, m, k, row_stride(img), cols,
                         ld)
            continue
        floats = _rmatmul_workspace(g, m, k, cols, u.device)
        ws = torch.empty(floats, dtype=torch.float32,
                         device=u.device) if floats else None
        build.launch(kernel, "repro_ec_rmatmul", u.device, *ptrs,
                     ws.data_ptr() if ws is not None else None, floats, g,
                     img_stride, member_ld, m, k, row_stride(img), cols, ld,
                     ld)
    return out


def ec_matmul(at: torch.Tensor, da: torch.Tensor, x: torch.Tensor,
              x_t: torch.Tensor) -> torch.Tensor:
    """``at @ x + da @ x_t`` for (M, K) images and (K, batch) panels."""
    _check("ec_matmul", at, da, x, x_t, at.shape[-1])
    if on_cpu(x):
        return ec_matmul_plain(at, da, x, x_t)
    return _launch_ec("ec_matmul", at, da, x, x_t, transpose=False)


@functools.lru_cache(maxsize=None)
def _rmatmul_workspace(g: int, m: int, k: int, batch: int,
                       device: torch.device) -> int:
    """Floats of workspace the transposed launcher asks for (0: none); the
    launcher alone decides how it cuts the rows."""
    floats = ctypes.c_longlong()
    build.query("repro_ec_rmatmul_workspace", device, g, m, k, batch,
                ctypes.byref(floats))
    return floats.value


def ec_rmatmul(at: torch.Tensor, da: torch.Tensor, y: torch.Tensor,
               y_t: torch.Tensor) -> torch.Tensor:
    """``at.T @ y + da.T @ y_t`` for (M, K) images and (M, batch) panels;
    returns (K, batch).  The kernel sums row slabs in a second pass over a
    workspace, in a fixed order: the result is the same run to run."""
    _check("ec_rmatmul", at, da, y, y_t, at.shape[0])
    if on_cpu(y):
        return ec_rmatmul_plain(at, da, y, y_t)
    return _launch_ec("ec_rmatmul", at, da, y, y_t, transpose=True)


def ec_group_matmul(at: torch.Tensor, da: torch.Tensor, x: torch.Tensor,
                    x_t: torch.Tensor) -> torch.Tensor:
    """``at[g] @ x_g + da[g] @ x_t_g`` for every member g of (g, M, K)
    image stacks in one launch; ``x``/``x_t`` are (K, g * batch) panels with
    member g's columns at ``g * batch``; returns the (M, g * batch) panel
    laid out the same way."""
    batch = _check_group("ec_group_matmul", at, da, x, x_t, at.shape[-1])
    if on_cpu(x):
        return ec_group_matmul_plain(at, da, x, x_t)
    return _launch_ec("ec_group_matmul", at, da, x, x_t, transpose=False,
                      g=at.shape[0], member_ld=batch)


def ec_group_rmatmul(at: torch.Tensor, da: torch.Tensor, y: torch.Tensor,
                     y_t: torch.Tensor) -> torch.Tensor:
    """``at[g].T @ y_g + da[g].T @ y_t_g`` for every member g in one launch:
    (M, g * batch) panels in, the (K, g * batch) panel out, member g's
    columns at ``g * batch``.  The slab count is chosen for the whole grid
    of members, so a member's sums may be cut into other slabs than a solo
    :func:`ec_rmatmul` cuts them (equal to fp32 rounding)."""
    batch = _check_group("ec_group_rmatmul", at, da, y, y_t, at.shape[1])
    if on_cpu(y):
        return ec_group_rmatmul_plain(at, da, y, y_t)
    return _launch_ec("ec_group_rmatmul", at, da, y, y_t, transpose=True,
                      g=at.shape[0], member_ld=batch)
