"""The port's BiCGSTAB, restarted GMRES and iterative refinement held to the
JAX solvers on the same numpy systems: a dense nonsymmetric digital
operator, and a programmed analog image (epiram, EC on, the reference's
programming draws injected, the input DAC off so that each MVM is a
deterministic function of the image) with the Neumann tier-2 and the exact
Thomas tier-2 at lam 1e-2.  Each case checks the iteration counts, the
``converged`` flags and the MVM counts for equality, x to 1e-5 rel-L2 and
the ledger's energy and latency to 1e-4; on the CPU the port's ``cuda``
backend (kernels' plain versions) and its ``reference`` backend give the
same solve."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads, program_eta, rel, rng_array  # noqa: F401
from repro import solvers as jsol
from repro.core import crossbar as jcb
from repro.core import devices as jdev
from repro.core import virtualization as jvirt
from repro.engine import AnalogEngine as JaxEngine
from repro_torch import solvers as tsol
from repro_torch.engine import AnalogEngine
from repro_torch.interop import config_from_dict

N = 96
OPS = ["digital", "neumann", "thomas"]
KEY = 17


def nonsymmetric(seed=110):
    """Spectrum in a disk of radius ~0.6 about 2: BiCGSTAB and GMRES
    territory."""
    return (2.0 * np.eye(N) + 0.6 * rng_array((N, N), seed) / np.sqrt(N)) \
        .astype(np.float32)


def spd(seed=111):
    r = rng_array((N, N), seed) / N
    return (r + r.T + 2.0 * np.eye(N)).astype(np.float32)


def rhs(batch, seed=112):
    b = rng_array((N, batch), seed)
    return b[:, 0] if batch == 1 else b


def operators(kind, a):
    """The JAX operand and, per port backend, the port's operand."""
    if kind == "digital":
        return jnp.asarray(a), {"reference": torch.from_numpy(a),
                                "cuda": torch.from_numpy(a)}
    cfg = jcb.CrossbarConfig(device=jdev.get_device("epiram"),
                             geom=jvirt.MCAGeometry(2, 2, 32, 32),
                             encode_inputs=False, denoise_method=kind,
                             lam=1e-2)
    pcfg = config_from_dict(dataclasses.asdict(cfg))
    key = jax.random.PRNGKey(KEY)
    ja = JaxEngine(cfg).program(jnp.asarray(a), key)
    mb, nb = ja.at_blocks.shape[:2]
    eta = torch.from_numpy(program_eta(key, cfg, mb, nb))
    return ja, {be: AnalogEngine(pcfg, backend=be, device="cpu")
                .program(a, 0, eta=eta) for be in ("reference", "cuda")}


def assert_same_solve(got, want, tol=1e-5):
    assert got.iterations == int(want.iterations)
    assert got.converged == bool(want.converged)
    assert got.ledger.mvms == int(want.ledger.mvms)
    assert got.ledger.mvms_single == int(want.ledger.mvms_single)
    assert rel(got.x, want.x) <= tol
    assert got.ledger.total_energy_j == pytest.approx(
        float(want.ledger.total_energy_j), rel=1e-4)
    assert got.ledger.total_latency_s == pytest.approx(
        float(want.ledger.total_latency_s), rel=1e-4)


def run_both(solve_j, solve_t, kind, a, batch):
    """One JAX solve; the port's on both backends, each held to it and to
    each other."""
    ja, ports = operators(kind, a)
    b = rhs(batch)
    want = solve_j(ja, jnp.asarray(b))
    assert want.converged, want
    got = {be: solve_t(A, b, be) for be, A in ports.items()}
    for res in got.values():
        assert res.x.shape == want.x.shape
        assert_same_solve(res, want)
    assert got["cuda"].iterations == got["reference"].iterations
    assert rel(got["cuda"].x, got["reference"].x) <= 1e-5
    return got["cuda"], want


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("kind", OPS)
def test_bicgstab_matches(kind, batch):
    got, _ = run_both(
        lambda A, b: jsol.bicgstab(A, b, tol=1e-5, maxiter=60),
        lambda A, b, _be: tsol.bicgstab(A, b, tol=1e-5, maxiter=60),
        kind, nonsymmetric(), batch)
    assert got.solver == "bicgstab" and got.iterations > 2
    assert got.ledger.mvms == 1 + 2 * got.iterations


@pytest.mark.parametrize("restart,maxiter", [(5, 40), (7, 40)])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("kind", OPS)
def test_gmres_matches(kind, batch, restart, maxiter):
    """Two restarts, one of which does not divide ``maxiter`` (ceil)."""
    got, _ = run_both(
        lambda A, b: jsol.gmres(A, b, restart=restart, tol=1e-5,
                                maxiter=maxiter),
        lambda A, b, _be: tsol.gmres(A, b, restart=restart, tol=1e-5,
                                     maxiter=maxiter),
        kind, nonsymmetric(), batch)
    assert got.solver == "gmres" and got.iterations >= 2
    assert got.ledger.mvms == 1 + got.iterations * (restart + 1)
    assert got.residuals.shape[0] == -(-maxiter // restart)


def test_gmres_stops_after_its_cycles():
    """A tolerance no cycle reaches: ``ceil(maxiter / restart)`` cycles,
    not converged, in both packages."""
    a, b = nonsymmetric(), rhs(1)
    want = jsol.gmres(jnp.asarray(a), jnp.asarray(b), restart=3, tol=1e-30,
                      maxiter=8)
    got = tsol.gmres(torch.from_numpy(a), b, restart=3, tol=1e-30, maxiter=8)
    assert got.iterations == int(want.iterations) == 3
    assert not got.converged and not want.converged
    assert got.ledger.mvms == 1 + 3 * 4 == int(want.ledger.mvms)
    assert rel(got.x, want.x) <= 1e-5


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("kind", OPS)
def test_refine_cg_matches(kind, batch):
    """Refinement with the CG inner solve; the digital outer residual ends
    under a tolerance the inner tolerance alone does not reach."""
    got, _ = run_both(
        lambda A, b: jsol.refine(A, b, inner="cg", tol=1e-5, maxiter=20),
        lambda A, b, be: tsol.refine(A, b, inner="cg", tol=1e-5, maxiter=20,
                                     backend=be),
        kind, spd(), batch)
    assert got.solver == "refine[cg]" and got.iterations >= 2
    assert got.final_residual <= 1e-5


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("kind", OPS)
def test_refine_richardson_matches(kind, batch):
    """Refinement with the Richardson inner solve at a given omega (the
    power-iteration start vectors differ by design between the packages)."""
    got, _ = run_both(
        lambda A, b: jsol.refine(A, b, inner="richardson", omega=0.5,
                                 tol=1e-5, maxiter=20),
        lambda A, b, be: tsol.refine(A, b, inner="richardson", omega=0.5,
                                     tol=1e-5, maxiter=20, backend=be),
        kind, spd(), batch)
    assert got.solver == "refine[richardson]" and got.iterations >= 2
    assert got.ledger.mvms_single == 0


def test_refine_auto_omega_bills_its_power_iterations():
    """``omega=None`` resolves omega once: 16 batch-1 MVMs, as in the
    reference, and the solve still converges below the inner tolerance."""
    a, b = spd(), rhs(3)
    got = tsol.refine(torch.from_numpy(a), b, inner="richardson", tol=1e-5,
                      maxiter=20)
    want = jsol.refine(jnp.asarray(a), jnp.asarray(b), inner="richardson",
                       tol=1e-5, maxiter=20)
    assert got.converged and want.converged
    assert got.ledger.mvms_single == int(want.ledger.mvms_single) == 16
    assert rel(got.x, want.x) <= 1e-4


def test_refine_needs_a_digital_matrix():
    """A bare matvec has no digital reconstruction: refine raises unless
    ``a_digital=`` is given, and with it solves as the dense operator
    does; an unknown inner solver raises."""
    a, b = spd(), rhs(1)
    at = torch.from_numpy(a)
    bare = tsol.as_operator(lambda v, _k: at @ v, shape=a.shape, device="cpu")
    with pytest.raises(ValueError, match="a_digital"):
        tsol.refine(bare, b)
    got = tsol.refine(bare, b, a_digital=a, tol=1e-5)
    want = tsol.refine(at, b, tol=1e-5)
    assert got.iterations == want.iterations and got.converged
    assert torch.equal(got.x, want.x)
    with pytest.raises(ValueError, match="inner solver"):
        tsol.refine(at, b, inner="jacobi")
