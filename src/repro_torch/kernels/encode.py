"""Single-pass encode + product (port of :func:`repro.kernels.rram_mvm.encode_matmul`,
:func:`~repro.kernels.rram_mvm.encode_matmul_rng` and the wrapper
:func:`repro.kernels.ops.rram_encode_matmul`).

  * ``encode_matmul(x, w, eps) = x @ (Q(w) * (1 + sigma * eps))`` where Q
    quantizes each ``(block_k, block_n)`` tile of ``w`` -- one MCA -- to
    ``levels`` states with the tile's own max-abs scale; the encoded weights
    are never stored;
  * ``encode_matmul_rng(seed, x, w)``: the same with ``eps`` drawn inside the
    kernel from a counter-based generator (Philox4x32-10, keyed by the seed
    and the weight tile), so no ``eps`` array exists;
  * ``rram_encode_matmul``: the JAX package's entry point, which shrinks the
    tiles for small problems (``_pick_blocks``) and pads to whole tiles
    (``_pad_to``).

On CUDA tensors the wrappers launch ``csrc/encode_matmul.cu`` (which masks
the ragged edges itself, with the same result as padding); on CPU tensors
they run the ``*_plain`` versions: :func:`encode_matmul_plain` (the twin of
``repro.kernels.ref.encode_matmul_ref``) on padded operands, with
:func:`philox_normal_plain` for the in-kernel draws.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..core.devices import quantize
from . import build, cost
from .cost import OBSERVERS
from ._checks import check_panels, on_cpu

__all__ = ["encode_matmul", "encode_matmul_plain", "encode_matmul_rng",
           "encode_matmul_rng_plain", "rram_encode_matmul",
           "quantize_tile_plain", "philox_normal_plain", "DEFAULT_BLOCK_M",
           "DEFAULT_BLOCK_K", "DEFAULT_BLOCK_N"]

DEFAULT_BLOCK_M = 256
DEFAULT_BLOCK_K = 512   # MCA cell rows (contraction)
DEFAULT_BLOCK_N = 512   # MCA cell columns (output features)

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #

def _pad_to(x: torch.Tensor, mults) -> torch.Tensor:
    """Zero-pad every dimension of ``x`` up to a multiple of ``mults``."""
    pads = [(-dim) % mult for dim, mult in zip(x.shape, mults)]
    if not any(pads):
        return x
    # F.pad lists the last dimension first.
    return F.pad(x, [p for pad in reversed(pads) for p in (0, pad)])


def _pick_blocks(m: int, k: int, n: int, bm: int, bk: int, bn: int):
    """Shrink the default blocks for small problems, as the JAX wrapper does
    (a small problem quantizes with smaller tiles)."""
    return min(bm, max(8, m)), min(bk, max(8, k)), min(bn, max(8, n))


def quantize_tile_plain(w: torch.Tensor, levels: int, tile_k: int,
                        tile_n: int) -> torch.Tensor:
    """Per-(tile_k x tile_n)-tile symmetric quantization of a (k, n) matrix
    whose sides are multiples of the tile (twin of ``quantize_tile_ref``):
    ``round(w / scale * (L - 1)) / (L - 1) * scale``, ``scale == 0 -> 1``."""
    k, n = w.shape
    if k % tile_k or n % tile_n:
        raise ValueError(f"{(k, n)} is not a multiple of the tile "
                         f"{(tile_k, tile_n)}")
    t = w.to(torch.float32).reshape(k // tile_k, tile_k, n // tile_n, tile_n)
    return quantize(t, levels, axis=(1, 3)).reshape(k, n)


def encode_matmul_plain(x: torch.Tensor, w: torch.Tensor, eps: torch.Tensor,
                        sigma: float, levels: int, tile_k: int,
                        tile_n: int) -> torch.Tensor:
    """``x @ W_tilde`` with ``W_tilde = Q(w) * (1 + sigma * eps)`` and a
    per-tile Q, on operands whose ``k`` and ``n`` are tile multiples (twin
    of ``encode_matmul_ref``)."""
    if OBSERVERS and cost.outermost():
        return cost.observed("encode_matmul", encode_matmul_plain, x, w, eps,
                             sigma, levels, tile_k, tile_n)
    q = quantize_tile_plain(w, levels, tile_k, tile_n)
    w_tilde = q * (1.0 + sigma * eps.to(torch.float32))
    return x.to(torch.float32) @ w_tilde


def _mulhilo(a: torch.Tensor, m: int):
    """``(hi, lo)`` 32-bit words of ``a * m`` for int64 tensors holding
    unsigned 32-bit values, through 16-bit halves (no int64 overflow)."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    ll = a_lo * m_lo
    mid = a_lo * m_hi + a_hi * m_lo + (ll >> 16)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    return a_hi * m_hi + (mid >> 16), lo


def _philox(c0, c1, c2, c3, seed: int):
    """Philox4x32-10 (Random123's round and key schedule) on int64 tensors
    of 32-bit words; returns the first two output words."""
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1


def philox_normal_plain(seed: int, k: int, n: int, tile_k: int, tile_n: int,
                        device="cpu") -> torch.Tensor:
    """The in-kernel draws of :func:`encode_matmul_rng` for a (k, n) weight
    matrix cut into (tile_k, tile_n) MCA tiles, in torch integer ops.

    Element (r, c) of tile (s, j) takes Philox4x32-10 of the counter
    ``(r * tile_n + c, s, j, 0)`` under the 64-bit ``seed``; two 24-bit
    uniforms ``(bits >> 8) / 2^24``, ``u1`` clamped at 1e-7, and
    Box-Muller ``sqrt(-2 ln u1) cos(2 pi u2)``.  Returns (k, n) float32.
    """
    seed = int(seed) & ((1 << 64) - 1)
    i64 = dict(dtype=torch.int64, device=device)
    rows, cols = torch.arange(k, **i64), torch.arange(n, **i64)
    elem = (rows % tile_k)[:, None] * tile_n + (cols % tile_n)[None, :]
    s = (rows // tile_k)[:, None].expand(k, n)
    j = (cols // tile_n)[None, :].expand(k, n)
    b1, b2 = _philox(elem, s, j, torch.zeros_like(elem), seed)
    u1 = torch.clamp((b1 >> 8).to(torch.float32) / 2.0 ** 24, min=1e-7)
    u2 = (b2 >> 8).to(torch.float32) / 2.0 ** 24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def encode_matmul_rng_plain(seed: int, x: torch.Tensor, w: torch.Tensor, *,
                            sigma: float, levels: int,
                            block_k: int = DEFAULT_BLOCK_K,
                            block_n: int = DEFAULT_BLOCK_N) -> torch.Tensor:
    """The plain version of :func:`encode_matmul_rng`: the padded operands
    through :func:`encode_matmul_plain` with :func:`philox_normal_plain`'s
    draws."""
    if OBSERVERS and cost.outermost():
        return cost.observed("encode_matmul_rng", encode_matmul_rng_plain,
                             seed, x, w, sigma=sigma, levels=levels,
                             block_k=block_k, block_n=block_n)
    m, k = x.shape
    n = w.shape[1]
    xp, wp = _pad_to(x, (1, block_k)), _pad_to(w, (block_k, block_n))
    eps = philox_normal_plain(seed, *wp.shape, block_k, block_n, w.device)
    return encode_matmul_plain(xp, wp, eps, sigma, levels, block_k,
                               block_n)[:m, :n]


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #

def _check(name, x, w, eps, block_k, block_n) -> None:
    check_panels(name, x, w, *(() if eps is None else (eps,)))
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0] \
            or (eps is not None and eps.shape != w.shape):
        raise ValueError(
            f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)}"
            + ("" if eps is None else f", eps {tuple(eps.shape)}")
            + " do not match (x (m, k), w and eps (k, n))")
    if block_k < 1 or block_n < 1:
        raise ValueError(f"{name}: tiles must be positive, got "
                         f"{(block_k, block_n)}")


def _workspace_floats(m: int, k: int, n: int, block_k: int, block_n: int,
                     device) -> tuple:
    """Floats of the two workspaces the launcher asks for at these shapes:
    one scale per MCA tile, and x transposed and zero-padded to the
    kernel's stages and row tiles."""
    scales, xt = ctypes.c_longlong(), ctypes.c_longlong()
    build.query("repro_encode_matmul_scales", device, k, n, block_k, block_n,
                ctypes.byref(scales))
    build.query("repro_encode_matmul_workspace", device, m, k,
                ctypes.byref(xt))
    return scales.value, xt.value


def _launch(kernel: str, x, w, eps, sigma, levels, block_k, block_n,
            seed: int) -> torch.Tensor:
    m, k = x.shape
    n = w.shape[1]
    n_scales, n_xt = _workspace_floats(m, k, n, block_k, block_n, x.device)
    scales = torch.empty(n_scales, dtype=torch.int32, device=x.device)
    xt = torch.empty(n_xt, dtype=torch.float32, device=x.device)
    out = torch.empty(m, n, dtype=torch.float32, device=x.device)
    build.launch(kernel, "repro_encode_matmul", x.device, x.data_ptr(),
                 w.data_ptr(), None if eps is None else eps.data_ptr(),
                 out.data_ptr(), scales.data_ptr(), n_scales, xt.data_ptr(),
                 n_xt, m, k, n, block_k, block_n, float(sigma), int(levels),
                 int(seed) & ((1 << 64) - 1), int(eps is None))
    return out


def encode_matmul(x: torch.Tensor, w: torch.Tensor, eps: torch.Tensor, *,
                  sigma: float, levels: int, block_k: int = DEFAULT_BLOCK_K,
                  block_n: int = DEFAULT_BLOCK_N) -> torch.Tensor:
    """``x @ (Q(w) * (1 + sigma * eps))`` with a per-(block_k, block_n)-tile
    Q; x (m, k), w and eps (k, n), float32; any shapes (a ragged edge tile
    is quantized as the zero-padded tile would be).  Returns (m, n)."""
    if OBSERVERS and cost.outermost():
        return cost.observed("encode_matmul", encode_matmul, x, w, eps,
                             sigma=sigma, levels=levels, block_k=block_k,
                             block_n=block_n)
    _check("encode_matmul", x, w, eps, block_k, block_n)
    if on_cpu(x):
        m, n = x.shape[0], w.shape[1]
        xp = _pad_to(x, (1, block_k))
        wp, ep = (_pad_to(t, (block_k, block_n)) for t in (w, eps))
        return encode_matmul_plain(xp, wp, ep, sigma, levels, block_k,
                                   block_n)[:m, :n]
    return _launch("encode_matmul", x, w, eps, sigma, levels, block_k,
                   block_n, 0)


def encode_matmul_rng(seed: int, x: torch.Tensor, w: torch.Tensor, *,
                      sigma: float, levels: int,
                      block_k: int = DEFAULT_BLOCK_K,
                      block_n: int = DEFAULT_BLOCK_N) -> torch.Tensor:
    """:func:`encode_matmul` with the noise drawn inside the kernel from
    ``seed`` (see :func:`philox_normal_plain`): W is the only k x n read.
    Each weight tile has one realisation for every row of x."""
    if OBSERVERS and cost.outermost():
        return cost.observed("encode_matmul_rng", encode_matmul_rng, seed, x,
                             w, sigma=sigma, levels=levels, block_k=block_k,
                             block_n=block_n)
    _check("encode_matmul_rng", x, w, None, block_k, block_n)
    if on_cpu(x):
        return encode_matmul_rng_plain(seed, x, w, sigma=sigma, levels=levels,
                                       block_k=block_k, block_n=block_n)
    return _launch("encode_matmul_rng", x, w, None, sigma, levels, block_k,
                   block_n, seed)


def rram_encode_matmul(x: torch.Tensor, w: torch.Tensor, eps: torch.Tensor, *,
                       sigma: float, levels: int,
                       block_m: int = DEFAULT_BLOCK_M,
                       block_k: int = DEFAULT_BLOCK_K,
                       block_n: int = DEFAULT_BLOCK_N) -> torch.Tensor:
    """``y = x @ encode(w)``, one MCA per (block_k, block_n) tile, as the JAX
    package's ``rram_encode_matmul``: the tiles shrink to ``min(block,
    max(8, dim))`` for small problems.  ``block_m`` only sizes the TPU
    kernel's row blocks; it does not change the result."""
    m, k = x.shape
    n = w.shape[1]
    _, bk, bn = _pick_blocks(m, k, n, block_m, block_k, block_n)
    return encode_matmul(x, w, eps, sigma=sigma, levels=levels, block_k=bk,
                         block_n=bn)
