"""The port's kernels: plain versions held to the JAX kernel wrappers
(interpret mode on the CPU, as tests/test_kernels.py runs them) and the
wrappers' argument checks; the grouped EC products, the single-pass encode
(``rram_encode_matmul``, ``encode_matmul_rng``) and its Philox draws.  The CUDA kernels themselves are held to their
plain versions on the card by tests/test_torch_cuda.py."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads, rel, rng_array  # noqa: F401
from repro.kernels import (denoise_stencil, denoise_thomas, rram_ec_matmul,
                           rram_ec_tile_rmvm, rram_encode_matmul,
                           solver_cg_update, solver_richardson_update)
from repro.kernels import ref as kref
from repro.kernels.ops import rram_ec_group_mvm, rram_ec_group_rmvm
from repro.kernels.rram_mvm import encode_matmul_rng as jax_encode_matmul_rng
from repro_torch import kernels
from repro_torch.kernels import build

TOL = 1e-5


@pytest.mark.parametrize("m,k,batch", [(64, 64, 1), (96, 160, 8),
                                       (70, 100, 3), (256, 128, 1),
                                       (128, 256, 1)])
def test_ec_matmul_matches_reference(m, k, batch):
    at, da = rng_array((m, k), 0), rng_array((m, k), 1, 0.05)
    x = rng_array((k, batch), 2)
    xt = x * (1 + 0.05 * rng_array((k, batch), 3))
    # The JAX engine calls the kernel on transposed views; so does this.
    want = rram_ec_matmul(jnp.asarray(x.T), jnp.asarray(xt.T),
                          jnp.asarray(at.T), jnp.asarray(da.T)).T
    got = kernels.ec_matmul(*(torch.from_numpy(v) for v in (at, da, x, xt)))
    assert got.shape == (m, batch) and got.dtype == torch.float32
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("m,k,batch", [(64, 64, 1), (96, 160, 8),
                                       (70, 100, 3), (256, 128, 1),
                                       (128, 256, 1)])
def test_ec_rmatmul_matches_reference(m, k, batch):
    """The transposed product against the JAX kernel read backwards
    (``ops.rram_ec_tile_rmvm``, interpret mode): rel-L2 <= 1e-5 (fp32 sums
    in another order)."""
    at, da = rng_array((m, k), 30), rng_array((m, k), 31, 0.05)
    y = rng_array((m, batch), 32)
    yt = y * (1 + 0.05 * rng_array((m, batch), 33))
    want = rram_ec_tile_rmvm(*(jnp.asarray(v) for v in (y, yt, at, da)))
    got = kernels.ec_rmatmul(*(torch.from_numpy(v) for v in (at, da, y, yt)))
    assert got.shape == (k, batch) and got.dtype == torch.float32
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("transpose", [False, True])
def test_ec_kernels_take_a_block_view(transpose):
    """A capacity block of a padded image (row stride > width) runs as a
    view, no copy, and equals the same block copied out (exactly: the same
    plain products on the same numbers)."""
    image = torch.from_numpy(rng_array((96, 128), 34))
    corr = torch.from_numpy(rng_array((96, 128), 35, 0.05))
    at, da = image[32:64, 64:112], corr[32:64, 64:112]
    assert not at.is_contiguous() and at.stride() == (128, 1)
    u = torch.from_numpy(rng_array((32 if transpose else 48, 3), 36))
    run = kernels.ec_rmatmul if transpose else kernels.ec_matmul
    got = run(at, da, u, 1.01 * u)
    want = run(at.contiguous(), da.contiguous(), u, 1.01 * u)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="unit column stride"):
        run(image.T[:48, :32], corr.T[:48, :32], u, u)


@pytest.mark.parametrize("n,b", [(16, 8), (64, 16), (128, 8), (33, 5)])
@pytest.mark.parametrize("lam", [1e-12, 1e-3, 0.5])
def test_thomas_solve_matches_reference(n, b, lam):
    """The exact tier-2 solve against the JAX Thomas kernel (interpret mode)
    on tests/test_kernels.py's shapes and lams: rel-L2 <= 1e-6 at
    lam <= 1e-3, <= 1e-5 at 0.5 (where the recurrence's fp32 steps,
    rounded once in the kernel's FMA and twice here, differ most)."""
    p = rng_array((n, b), 37)
    want = np.asarray(denoise_thomas(jnp.asarray(p), lam=lam, h=-1.0))
    got = kernels.thomas_solve(torch.from_numpy(p), lam, -1.0)
    assert got.shape == (n, b) and got.dtype == torch.float32
    assert rel(got, want) <= (1e-6 if lam <= 1e-3 else 1e-5)
    if lam == 0.5:
        assert rel(got, p) > 1e-2         # the solve is not the identity


def test_thomas_coeffs_match_the_reference_recurrence():
    """c' and the pivots equal the JAX wrapper's fp32 scan exactly or to one
    rounding; the early stop at the fixed point fills the same values."""
    import jax
    n, lam, h = 300, 0.5, -1.0
    cp, piv = (t.numpy() for t in kernels.tridiag.thomas_coeffs(n, lam, h,
                                                                "cpu"))
    diag = jnp.full((n,), 1.0 + lam * (1.0 + h * h), jnp.float32) \
        .at[0].set(1.0 + lam)
    a = float(lam * h)

    def step(c, bi):
        pv = 1.0 / (bi - a * c)
        return a * pv, (a * pv, pv)

    _, (jcp, jpiv) = jax.lax.scan(step, jnp.float32(0.0), diag)
    np.testing.assert_allclose(cp[:-1], np.asarray(jcp)[:-1], rtol=1e-6)
    np.testing.assert_allclose(piv, np.asarray(jpiv), rtol=1e-6)
    assert cp[-1] == 0.0


@pytest.mark.parametrize("lam", [1e-12, 1e-2])
def test_stencil_denoise_matches_reference(lam):
    p = rng_array((65, 3), 4)
    want = np.asarray(denoise_stencil(jnp.asarray(p), lam=lam, h=-1.0))
    got = kernels.stencil_denoise(torch.from_numpy(p), lam, -1.0)
    assert rel(got, want) <= TOL
    if lam == 1e-2:
        # At this lam the stencil term is resolved in fp32: an identity
        # kernel would fail here.
        assert rel(got, p) > 1e-3


def test_cg_update_matches_reference():
    x, r, p, ap = (rng_array((70, 3), s) for s in range(5, 9))
    alpha = rng_array((3,), 9)
    want = solver_cg_update(*(jnp.asarray(v) for v in (x, r, p, ap, alpha)))
    got = kernels.cg_update(*(torch.from_numpy(v)
                              for v in (x, r, p, ap, alpha)))
    for g, w in zip(got, want):
        assert rel(g, w) <= TOL


def test_richardson_update_matches_reference():
    x, b, y = (rng_array((70, 3), s) for s in range(10, 13))
    omega = np.float32(0.37)
    want = solver_richardson_update(jnp.asarray(x), jnp.asarray(b),
                                    jnp.asarray(y), jnp.asarray(omega))
    got = kernels.richardson_update(*(torch.from_numpy(v) for v in (x, b, y)),
                                    torch.tensor(omega))
    for g, w in zip(got, want):
        assert rel(g, w) <= TOL


def test_wrappers_check_arguments_and_count_no_cpu_launch():
    kernels.reset_launches()
    a = torch.ones(8, 8)
    x = torch.ones(8, 2)
    with pytest.raises(TypeError):
        kernels.ec_matmul(a.double(), a, x, x)
    with pytest.raises(ValueError):
        kernels.ec_matmul(a, a, x.t(), x)                 # non-contiguous
    with pytest.raises(ValueError):
        kernels.ec_matmul(a, a, torch.ones(7, 2), torch.ones(7, 2))
    with pytest.raises(ValueError):
        kernels.cg_update(x, x, x, x, torch.ones(3))      # alpha per column
    with pytest.raises(ValueError):
        kernels.richardson_update(x, x, x, torch.ones(2))
    with pytest.raises(ValueError):
        kernels.stencil_denoise(torch.ones(8), 1e-3)
    with pytest.raises(ValueError):
        kernels.ec_rmatmul(a[:, :6], a[:, :6], torch.ones(6, 2),
                           torch.ones(6, 2))             # needs (M, batch)
    with pytest.raises(ValueError):
        kernels.ec_rmatmul(a, a[:, :6], x, x)             # images differ
    with pytest.raises(ValueError):
        kernels.thomas_solve(torch.ones(8), 1e-3)
    with pytest.raises(TypeError):
        kernels.thomas_solve(x.double(), 1e-3)
    kernels.ec_matmul(a, a, x, x)
    kernels.ec_rmatmul(a, a, x, x)
    kernels.stencil_denoise(x, 1e-3)
    kernels.thomas_solve(x, 1e-3)
    kernels.cg_update(x, x, x, x, torch.ones(2))
    kernels.richardson_update(x, x, x, torch.tensor(0.5))
    # The CPU path runs the plain versions: no kernel launched, none counted.
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_sources_export_every_bound_symbol():
    """Each C launcher the wrappers bind is defined in some csrc/*.cu, and
    the build targets sm_90a."""
    text = "\n".join(p.read_text() for p in build.CSRC.glob("*.cu"))
    for symbol in list(build.SIGNATURES) + ["repro_error_string"]:
        assert re.search(rf"\b{symbol}\s*\(", text), symbol
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert set(build.LAUNCHES) == {"ec_matmul", "ec_rmatmul",
                                   "ec_group_matmul", "ec_group_rmatmul",
                                   "encode_matmul", "encode_matmul_rng",
                                   "stencil_denoise", "thomas_solve",
                                   "cg_update", "richardson_update"}



# ----------------------------------------------------------- grouped products
def _panel(u):
    """(g, rows, batch) -> the (rows, g * batch) group panel."""
    g, rows, batch = u.shape
    return torch.from_numpy(np.ascontiguousarray(
        u.transpose(1, 0, 2).reshape(rows, g * batch)))


def _unpanel(p, g):
    rows = p.shape[0]
    return p.numpy().reshape(rows, g, -1).transpose(1, 0, 2)


@pytest.mark.parametrize("g,m,k,batch", [(4, 64, 64, 1), (3, 70, 100, 3),
                                         (8, 96, 40, 8), (2, 33, 50, 11)])
def test_ec_group_matmul_matches_reference(g, m, k, batch):
    """The grouped forward product against ``ops.rram_ec_group_mvm``
    (interpret mode, one member at a time under ``lax.map``), per member:
    rel-L2 <= 1e-5 (fp32 sums in another order)."""
    at, da = rng_array((g, m, k), 40), rng_array((g, m, k), 41, 0.05)
    x = rng_array((g, k, batch), 42)
    xt = x * (1 + 0.05 * rng_array((g, k, batch), 43))
    want = np.asarray(rram_ec_group_mvm(*(jnp.asarray(v)
                                          for v in (x, xt, at, da))))
    got = kernels.ec_group_matmul(torch.from_numpy(at), torch.from_numpy(da),
                                  _panel(x), _panel(xt))
    assert got.shape == (m, g * batch)
    got = _unpanel(got, g)
    for i in range(g):
        assert rel(got[i], want[i]) <= TOL


@pytest.mark.parametrize("g,m,k,batch", [(4, 64, 64, 1), (3, 70, 100, 3),
                                         (8, 96, 40, 8), (2, 33, 50, 11)])
def test_ec_group_rmatmul_matches_reference(g, m, k, batch):
    """The grouped transposed product against ``ops.rram_ec_group_rmvm``."""
    at, da = rng_array((g, m, k), 44), rng_array((g, m, k), 45, 0.05)
    y = rng_array((g, m, batch), 46)
    yt = y * (1 + 0.05 * rng_array((g, m, batch), 47))
    want = np.asarray(rram_ec_group_rmvm(*(jnp.asarray(v)
                                           for v in (y, yt, at, da))))
    got = kernels.ec_group_rmatmul(torch.from_numpy(at), torch.from_numpy(da),
                                   _panel(y), _panel(yt))
    assert got.shape == (k, g * batch)
    got = _unpanel(got, g)
    for i in range(g):
        assert rel(got[i], want[i]) <= TOL


def test_group_kernels_equal_solo_per_member_and_check_arguments():
    """Member g of a grouped product is the solo product on member g's
    image and columns, exactly (the same plain products here); the
    wrappers refuse panels that do not split into the members and image
    stacks that differ, and count no launch on the CPU."""
    kernels.reset_launches()
    g, m, k, b = 3, 20, 30, 2
    at = torch.from_numpy(rng_array((g, m, k), 48))
    da = torch.from_numpy(rng_array((g, m, k), 49))
    x, y = torch.from_numpy(rng_array((k, g * b), 50)), \
        torch.from_numpy(rng_array((m, g * b), 51))
    p, q = kernels.ec_group_matmul(at, da, x, x), \
        kernels.ec_group_rmatmul(at, da, y, y)
    for i in range(g):
        cols = slice(i * b, (i + 1) * b)
        xi, yi = x[:, cols].contiguous(), y[:, cols].contiguous()
        assert torch.equal(p[:, cols], kernels.ec_matmul(at[i], da[i], xi, xi))
        assert torch.equal(q[:, cols],
                           kernels.ec_rmatmul(at[i], da[i], yi, yi))
    with pytest.raises(ValueError, match="split"):
        kernels.ec_group_matmul(at, da, x[:, :5].contiguous(),
                                x[:, :5].contiguous())
    with pytest.raises(ValueError):
        kernels.ec_group_matmul(at, da[:2], x, x)
    with pytest.raises(ValueError):
        kernels.ec_group_matmul(at[0], da[0], x, x)
    with pytest.raises(ValueError):
        kernels.ec_group_rmatmul(at, da, x, x)           # needs (M, g*b)
    assert all(v == 0 for v in kernels.LAUNCHES.values())


# ---------------------------------------------------------- single-pass encode
ENCODE_SHAPES = [(8, 8, 8, 8, 8, 8), (16, 32, 24, 8, 8, 8),
                 (32, 16, 16, 16, 16, 16), (8, 48, 16, 8, 16, 8),
                 (24, 24, 40, 8, 8, 8),
                 (20, 37, 29, 16, 16, 16)]   # padded: no dimension a multiple


@pytest.mark.parametrize("m,k,n,bm,bk,bn", ENCODE_SHAPES)
def test_rram_encode_matmul_matches_reference(m, k, n, bm, bk, bn):
    """``rram_encode_matmul`` (the plain version here) against the JAX
    entry point (interpret mode) on tests/test_kernels.py's shapes and one
    padded shape: rel-L2 <= 1e-5."""
    x, w, eps = rng_array((m, k), 60), rng_array((k, n), 61), \
        rng_array((k, n), 62)
    want = np.asarray(rram_encode_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(eps), sigma=0.13,
        levels=8, block_m=bm, block_k=bk, block_n=bn))
    got = kernels.rram_encode_matmul(
        *(torch.from_numpy(v) for v in (x, w, eps)), sigma=0.13, levels=8,
        block_m=bm, block_k=bk, block_n=bn)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert rel(got, want) <= TOL


@pytest.mark.parametrize("levels", [4, 8, 64])
def test_rram_encode_matmul_default_tiles_shrink(levels):
    """With the default 512 tiles a small problem quantizes with tiles of
    ``min(512, max(8, dim))`` (``_pick_blocks``), as the JAX wrapper: here
    one tile over a 40 x 24 weight."""
    x, w, eps = rng_array((12, 40), 63), rng_array((40, 24), 64), \
        rng_array((40, 24), 65)
    want = np.asarray(rram_encode_matmul(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(eps), sigma=0.05,
                                         levels=levels))
    got = kernels.rram_encode_matmul(*(torch.from_numpy(v)
                                       for v in (x, w, eps)),
                                     sigma=0.05, levels=levels)
    assert rel(got, want) <= TOL
    assert kernels.encode._pick_blocks(12, 40, 24, 256, 512, 512) == \
        (12, 40, 24)
    assert kernels.encode._pick_blocks(3, 700, 5, 256, 512, 512) == \
        (8, 512, 8)


@pytest.mark.parametrize("levels,tile", [(8, (8, 8)), (4, (16, 8)),
                                         (64, (32, 16))])
def test_quantize_tile_plain_equals_reference_exactly(levels, tile):
    w = rng_array((64, 48), 66)
    w[:16, :8] = 0.0                    # an all-zero tile: scale 0 -> 1
    want = np.asarray(kref.quantize_tile_ref(jnp.asarray(w), levels, *tile))
    got = kernels.quantize_tile_plain(torch.from_numpy(w), levels, *tile)
    np.testing.assert_array_equal(got.numpy(), want)


def test_encode_matmul_rng_at_sigma_zero_matches_reference():
    """At sigma = 0 the in-kernel noise vanishes: the port's
    ``encode_matmul_rng`` equals the JAX kernel in interpret mode (whose
    CPU interpreter has no TPU random bits) and the port's
    ``encode_matmul`` with zero eps."""
    x, w = rng_array((16, 64), 67), rng_array((64, 32), 68)
    want = np.asarray(jax_encode_matmul_rng(
        jnp.array([7], jnp.int32), jnp.asarray(x), jnp.asarray(w), sigma=0.0,
        levels=8, block_m=16, block_k=32, block_n=32, interpret=True))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = kernels.encode_matmul_rng(7, xt, wt, sigma=0.0, levels=8,
                                    block_k=32, block_n=32)
    assert rel(got, want) <= TOL
    assert torch.equal(got, kernels.encode_matmul(
        xt, wt, torch.zeros_like(wt), sigma=0.0, levels=8, block_k=32,
        block_n=32))


def test_encode_matmul_rng_is_seeded_and_deterministic():
    """The same seed gives the same result bit for bit, another seed
    another one; the draws are keyed by the weight tile, so every row of
    x sees one realisation (row r of the product equals x[r] @ W_tilde)."""
    x, w = torch.from_numpy(rng_array((40, 50), 69)), \
        torch.from_numpy(rng_array((50, 30), 70))
    kw = dict(sigma=0.2, levels=8, block_k=16, block_n=16)
    a, b = kernels.encode_matmul_rng(3, x, w, **kw), \
        kernels.encode_matmul_rng(3, x, w, **kw)
    assert torch.equal(a, b)
    assert rel(kernels.encode_matmul_rng(4, x, w, **kw), a) > 1e-3
    one = kernels.encode_matmul_rng(3, x[7:8].contiguous(), w, **kw)
    assert rel(one, a[7:8]) <= 1e-6
    eps = kernels.philox_normal_plain(3, 64, 32, 16, 16)[:50, :30]
    assert rel(a, kernels.encode_matmul(x, w, eps.contiguous(), sigma=0.2,
                                        levels=8, block_k=16,
                                        block_n=16)) <= 1e-6


def test_philox_normal_plain_moments_and_known_answers():
    """2^20 draws: mean within 0.01 of 0 and variance within 2 % of 1; the
    generator is Philox4x32-10 (Random123's known answers for a zero and
    an all-ones counter and key)."""
    eta = kernels.philox_normal_plain(11, 1024, 1024, 512, 256)
    assert eta.shape == (1024, 1024) and bool(torch.isfinite(eta).all())
    assert abs(float(eta.mean())) <= 0.01
    assert abs(float(eta.var()) - 1.0) <= 0.02
    enc = kernels.encode
    for ctr, seed, want in (((0, 0, 0, 0), 0, (0x6627E8D5, 0xE169C58D)),
                            ((0xFFFFFFFF,) * 4, (1 << 64) - 1,
                             (0x408F276D, 0x41C83B0E))):
        words = enc._philox(*(torch.tensor([c]) for c in ctr), seed)
        assert tuple(int(v) for v in words) == want


def test_encode_wrappers_check_arguments():
    kernels.reset_launches()
    x, w = torch.ones(4, 6), torch.ones(6, 5)
    with pytest.raises(ValueError):
        kernels.encode_matmul(x, torch.ones(7, 5), torch.ones(7, 5),
                              sigma=0.1, levels=8)
    with pytest.raises(ValueError):
        kernels.encode_matmul(x, w, torch.ones(6, 4), sigma=0.1, levels=8)
    with pytest.raises(TypeError):
        kernels.encode_matmul_rng(0, x.double(), w, sigma=0.1, levels=8)
    with pytest.raises(ValueError):
        kernels.quantize_tile_plain(torch.ones(6, 5), 8, 4, 4)
    kernels.encode_matmul(x, w, w, sigma=0.1, levels=8)
    kernels.encode_matmul_rng(0, x, w, sigma=0.1, levels=8)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
