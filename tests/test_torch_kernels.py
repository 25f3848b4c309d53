"""The port's kernels: plain versions held to the JAX kernel wrappers
(interpret mode on the CPU, as tests/test_kernels.py runs them) and the
wrappers' argument checks.  The CUDA kernels themselves are held to their
plain versions on the card by tests/test_torch_cuda.py."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads, rel, rng_array  # noqa: F401
from repro.kernels import (denoise_stencil, denoise_thomas, rram_ec_matmul,
                           rram_ec_tile_rmvm, solver_cg_update,
                           solver_richardson_update)
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
                                   "stencil_denoise", "thomas_solve",
                                   "cg_update", "richardson_update"}

