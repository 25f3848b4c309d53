"""The port's kernels: plain versions held to the JAX kernel wrappers
(interpret mode on the CPU, as tests/test_kernels.py runs them) and the
wrappers' argument checks; the grouped EC products, the single-pass encode
(``rram_encode_matmul``, ``encode_matmul_rng``) and its Philox draws.  The CUDA kernels themselves are held to their
plain versions on the card by tests/test_torch_cuda.py."""
import re
from pathlib import Path

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


@pytest.mark.parametrize("lam", [1e-12, 1e-2, 0.5, 10.0, 1e3])
@pytest.mark.parametrize("n", [1, 2, 3, 40, 5000])
def test_thomas_coeffs_early_stop_is_exact(n, lam):
    """thomas_coeffs stops its recurrence where a step repeats the previous
    one and fills the rest with that step: bit for bit the recurrence run
    over every row (c'_{n-1} = 0), at lams from the identity to |c'| ~
    0.97."""
    f32 = np.float32
    a = f32(lam * -1.0)
    body, row0 = f32(1.0 + lam * 2.0), f32(1.0 + lam)
    want_cp, want_piv = np.empty(n, f32), np.empty(n, f32)
    c = f32(0.0)
    for i in range(n):
        want_piv[i] = f32(1.0) / ((row0 if i == 0 else body) - a * c)
        c = want_cp[i] = a * want_piv[i]
    want_cp[-1] = 0.0
    cp, piv = kernels.tridiag.thomas_coeffs(n, lam, -1.0, "cpu")
    assert np.array_equal(cp.numpy(), want_cp)
    assert np.array_equal(piv.numpy(), want_piv)


@pytest.mark.parametrize("lam", [1e-12, 1e-2, 0.5, 10.0, 1e3])
@pytest.mark.parametrize("n", [1, 2, 3, 40, 5000])
def test_thomas_tail_describes_the_coefficients(n, lam):
    """The kernel reads c' and the pivots below ``head`` only: the rows from
    ``head`` on, rebuilt from the two tail values (and c'_{n-1} = 0), are
    the cached coefficients bit for bit."""
    cp, piv = (t.numpy() for t in kernels.tridiag.thomas_coeffs(n, lam, -1.0,
                                                                "cpu"))
    head, piv_tail, cp_tail = kernels.tridiag.thomas_tail(n, lam, -1.0)
    assert 0 <= head <= n
    rows = np.arange(n)
    rebuilt_piv = np.where(rows < head, piv, np.float32(piv_tail))
    rebuilt_cp = np.where(rows < head, cp, np.float32(cp_tail))
    if head < n:
        rebuilt_cp[-1] = 0.0
    assert np.array_equal(rebuilt_piv, piv) and np.array_equal(rebuilt_cp, cp)
    if n == 5000:
        assert head < 200        # the fixed point comes early


def _carry_in(A, B, x0):
    """The value entering each chunk of a tile: chunk maps ``x -> A x + B``
    ((T,) and (T, b)) applied in index order, ``x0`` (b,) entering chunk 0.
    The kernel's association: an inclusive scan over the 32 lanes of each
    warp (shuffle offsets 1, 2, ..., 16), the same over the warp totals,
    then each lane's exclusive map applied to its warp's carry-in."""
    T, b = B.shape
    nw = -(-T // 32)
    Ap = torch.ones(nw * 32)
    Bp = torch.zeros(nw * 32, b)
    Ap[:T], Bp[:T] = A, B

    def scan(A, B):                      # along dim 1 of (w, 32[, b])
        for off in (1, 2, 4, 8, 16):
            A2, B2 = A.clone(), B.clone()
            B2[:, off:] = A[:, off:, None] * B[:, :-off] + B[:, off:]
            A2[:, off:] = A[:, off:] * A[:, :-off]
            A, B = A2, B2
        return A, B

    A, B = scan(Ap.view(nw, 32), Bp.view(nw, 32, b))
    ea = torch.cat([torch.ones(nw, 1), A[:, :-1]], 1)
    eb = torch.cat([torch.zeros(nw, 1, b), B[:, :-1]], 1)
    wa, wb = torch.ones(1, 32), torch.zeros(1, 32, b)
    wa[0, :nw], wb[0, :nw] = A[:, 31], B[:, 31]
    wa, wb = scan(wa, wb)
    after = wa[0, :nw, None] * x0 + wb[0, :nw]
    warp_in = torch.cat([x0[None], after[:-1]])
    carry = ea[:, :, None] * warp_in[:, None] + eb
    return carry.reshape(nw * 32, b)[:T]


def _affine_scan(alpha, beta, threads, rows):
    """``x_i = alpha_i x_{i-1} + beta_i`` (x_{-1} = 0) over a length that is a
    whole number of tiles of ``threads * rows``, as the kernel runs it: per
    tile, chunk maps, the carry into each chunk, the replay from it; the
    tile's last replayed value enters the next tile."""
    T, R = threads, rows
    x0 = torch.zeros(beta.shape[1])
    out = torch.empty_like(beta)
    for t0 in range(0, beta.shape[0], T * R):
        al = alpha[t0:t0 + T * R].view(T, R)
        be = beta[t0:t0 + T * R].view(T, R, -1)
        A, B = torch.ones(T), torch.zeros(T, be.shape[2])
        for j in range(R):
            B = al[:, j, None] * B + be[:, j]
            A = al[:, j] * A
        x = _carry_in(A, B, x0)
        for j in range(R):
            x = al[:, j, None] * x + be[:, j]
            out[t0:t0 + T * R].view(T, R, -1)[:, j] = x
        x0 = x[-1]
    return out


def thomas_scan_mirror(p, lam, h=-1.0, threads=None, rows=64):
    """An fp32 mirror of the thomas_solve kernel's block scan (its
    association, not its bits: a multiply and an add here where the kernel
    has one FMA).  ``threads`` defaults to the launcher's choice: whole
    warps for the chunks of ``rows`` rows, at most 512."""
    n, b = p.shape
    if threads is None:
        threads = min(512, -(-n // (rows * 32)) * 32)
    cp, piv = kernels.tridiag.thomas_coeffs(n, lam, h, "cpu")
    a = torch.tensor(float(np.float32(lam * h)))
    span = -(-n // (threads * rows)) * threads * rows

    def pad(t):
        return torch.cat([t, t.new_zeros((span - n,) + t.shape[1:])])

    pv = pad(piv)
    d = _affine_scan(-a * pv, pv[:, None] * pad(p), threads, rows)
    y = _affine_scan(-pad(cp).flip(0), d.flip(0), threads, rows).flip(0)
    return y[:n]


@pytest.mark.parametrize("lam", [1e-12, 1e-2, 0.5, 10.0])
@pytest.mark.parametrize("n,b,threads,rows", [
    (1000, 3, None, 64),      # the launcher's choice: one warp, one tile
    (5000, 2, None, 64),      # 79 chunks: 3 warps, ragged last warp
    (1000, 3, 64, 4),         # four tiles
    (777, 2, 40, 3),          # a partial warp, a ragged last tile
])
def test_thomas_scan_mirror_matches_plain(lam, n, b, threads, rows):
    """The kernel's association (chunk maps, the block scan, the replay,
    tile carries) is the sequential recurrence to rel-L2 <= 1e-6, also at
    lam = 10 where |c'| ~ 0.9 carries far down the column."""
    p = torch.from_numpy(rng_array((n, b), 60))
    got = thomas_scan_mirror(p, lam, threads=threads, rows=rows)
    assert got.shape == (n, b) and got.dtype == torch.float32
    assert rel(got, kernels.thomas_solve_plain(p, lam)) <= 1e-6
    if lam >= 0.5:
        assert rel(got, p) > 1e-2


@pytest.mark.parametrize("n,b", [(16, 8), (64, 16), (128, 8), (33, 5)])
@pytest.mark.parametrize("lam", [1e-12, 1e-3, 0.5])
def test_thomas_scan_mirror_matches_jax_reference(n, b, lam):
    """The mirror against the JAX Thomas kernel (interpret mode) at
    test_thomas_solve_matches_reference's shapes, lams and tolerances, on
    tiles of 32 x 2 rows so that every shape spans more than one tile."""
    p = rng_array((n, b), 61)
    want = np.asarray(denoise_thomas(jnp.asarray(p), lam=lam, h=-1.0))
    got = thomas_scan_mirror(torch.from_numpy(p), lam, threads=32, rows=2)
    assert rel(got, want) <= (1e-6 if lam <= 1e-3 else 1e-5)


@pytest.mark.parametrize("threads,rows", [(None, 64), (32, 8), (96, 5)])
def test_thomas_scan_mirror_at_large_lam_against_fp64(threads, rows):
    """At lam = 1e3 (|c'| ~ 0.97, so a carry decays over hundreds of rows)
    the scan's error against a float64 solve is at most twice the
    sequential fp32 recurrence's: a scan that cut its carries short would
    miss by orders of magnitude."""
    p = torch.from_numpy(rng_array((3000, 3), 62))
    want = kernels.tridiag.thomas_solve_fp64(p, 1e3)
    err_scan = rel(thomas_scan_mirror(p, 1e3, threads=threads, rows=rows),
                   want)
    err_plain = rel(kernels.thomas_solve_plain(p, 1e3), want)
    assert err_scan <= 2 * err_plain


@pytest.mark.parametrize("n", [1, 2, 33, 1000, 5000])
def test_thomas_scan_mirror_ragged(n):
    """Columns shorter than a warp's chunks (n < threads), one row, and a
    ragged last chunk, at the launcher's choice of threads and at a tile
    that n does not fill."""
    p = torch.from_numpy(rng_array((n, 2), 63))
    want = kernels.thomas_solve_plain(p, 0.5)
    for threads, rows in ((None, 64), (64, 7)):
        got = thomas_scan_mirror(p, 0.5, threads=threads, rows=rows)
        assert rel(got, want) <= 1e-6


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


def test_build_digest_covers_sources_and_headers(tmp_path, monkeypatch):
    """The library's name hashes every ``csrc/*.cu`` and every shared
    ``*.cuh`` header, so an edited header is rebuilt, not loaded stale;
    ``nvcc`` compiles the ``.cu`` sources alone."""
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    (tmp_path / "notes.txt").write_text("x\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build._sources() == [tmp_path / "a.cu"]
    before = build._digest()
    (tmp_path / "notes.txt").write_text("y\n")
    assert build._digest() == before
    (tmp_path / "shared.cuh").write_text("// v2\n")
    assert build._digest() != before
    assert "async_copy.cuh" in {
        p.name for p in Path(build.__file__).parent.glob("csrc/*.cuh")}


_PTXAS_LOG = """== encode_matmul.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__9ff8f882_16_encode_matmul_cu_b9ee5ddf20encode_matmul_kernelILb1EEEvPKfS2_S2_PKjPfiiiiiiiiffyi' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__9ff8f882_16_encode_matmul_cu_b9ee5ddf20encode_matmul_kernelILb1EEEvPKfS2_S2_PKjPfiiiiiiiiffyi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 140 registers, used 1 barriers, 448 bytes cmem[0]
ptxas info    : Function properties for __internal_fdiv_slowpath
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__0a1b2c3d_11_rram_mvm_cu_4e5f6a7b16ec_matmul_kernelILi4ELb0EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__0a1b2c3d_11_rram_mvm_cu_4e5f6a7b16ec_matmul_kernelILi4ELb0EEEvPKf
    88 bytes stack frame, 84 bytes spill stores, 120 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 88 bytes cumulative stack size, 20992 bytes smem
== tridiag.cu
ptxas info    : Compiling entry function '_Z14stencil_kernelPKfPf' for 'sm_90a'
ptxas info    : Used 32 registers, used 0 barriers
"""


def test_ptxas_report_reads_each_kernel():
    """``build.ptxas_report`` names each kernel of a ``ptxas -v`` log with its
    template arguments and reads its registers, stack frame, spills and
    static shared memory; a device function's lines are not a kernel's."""
    rep = build.ptxas_report(_PTXAS_LOG)
    assert set(rep) == {"encode_matmul_kernel<true>",
                        "ec_matmul_kernel<4, false>", "stencil_kernel"}
    assert rep["encode_matmul_kernel<true>"] == {
        "source": "encode_matmul.cu", "registers": 140, "stack": 0,
        "spill_stores": 0, "spill_loads": 0, "smem": 0}
    assert rep["ec_matmul_kernel<4, false>"] == {
        "source": "encode_matmul.cu", "registers": 128, "stack": 88,
        "spill_stores": 84, "spill_loads": 120, "smem": 20992}
    assert rep["stencil_kernel"]["source"] == "tridiag.cu"
    assert rep["stencil_kernel"]["registers"] == 32



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


@pytest.mark.parametrize("m,splits", [(600, (256, 512)), (37, (5, 20, 21))])
def test_encode_matmul_rng_plain_equals_its_row_split_pieces(m, splits):
    """The plain ``encode_matmul_rng`` on x of m rows equals, row block by
    row block, itself on each slice of x: the draws are keyed by the weight
    tile, so every row block multiplies the same W_tilde (the CPU side of
    the card test that the kernel's row tiles agree)."""
    x, w = torch.from_numpy(rng_array((m, 70), 71)), \
        torch.from_numpy(rng_array((70, 90), 72))
    kw = dict(sigma=0.3, levels=8, block_k=24, block_n=40)
    whole = kernels.encode_matmul_rng_plain(5, x, w, **kw)
    for lo, hi in zip((0,) + splits, splits + (m,)):
        piece = kernels.encode_matmul_rng_plain(5, x[lo:hi].contiguous(), w,
                                                **kw)
        assert rel(piece, whole[lo:hi]) <= 1e-6


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
