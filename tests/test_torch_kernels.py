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
from repro.kernels import (denoise_stencil, rram_ec_matmul,
                           solver_cg_update, solver_richardson_update)
from repro_torch import kernels
from repro_torch.kernels import build

TOL = 1e-5


@pytest.mark.parametrize("m,k,batch", [(64, 64, 1), (96, 160, 8),
                                       (70, 100, 3)])
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
    kernels.ec_matmul(a, a, x, x)
    kernels.stencil_denoise(x, 1e-3)
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
    assert set(build.LAUNCHES) == {"ec_matmul", "stencil_denoise",
                                   "cg_update", "richardson_update"}
