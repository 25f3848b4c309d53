"""The port's eigen solvers (Lanczos, LOBPCG, ``operator_norm`` and the
Lanczos spectral bounds) held to the JAX solvers, and the eigen family's
solver contracts held on the port directly.

Parity: the same numpy matrices go through both packages, as a digital
operator and as programmed images (epiram, EC on, the reference's
programming draws injected, the input DAC off so that each MVM is a
deterministic function of the image) with the Neumann tier-2 and the exact
Thomas tier-2 at lam 1e-2, on the port's ``reference`` and ``cuda`` backends
against the JAX ``reference`` and ``pallas`` backends.  The reference's
start vectors are drawn with ``jax.random`` and injected (``lanczos(v0=)``,
``lobpcg(x0=)``).  Each case checks the iteration, MVM and ``converged``
counts for equality, the eigenvalues to 5e-5 rel, the Ritz vectors to 1e-4
up to a per-column sign (``eigh`` may flip a column between
implementations; neither package fixes one), and the ledger's energy and
latency to 1e-4.  The test spectrum has separated ends within [1, 2], so
that eight power-iteration seed steps leave the bottom eigenvector in the
Lanczos start vector.

Contracts, on a fixed sweep of numpy seeds and conditionings with the
reference registry's eigen problems (SPD, eigenvalues log-spaced over the
condition number) and run settings (tol 1e-3, maxiter 32; LOBPCG k = 2,
smallest): residual honesty both ways at the registry's slack and floors,
``converged`` iff ``final_residual <= tol``, LOBPCG's entry convergence on
the identity, and the ledger's arithmetic.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads, program_eta  # noqa: F401
from repro import solvers as jsol
from repro.core import crossbar as jcb
from repro.core import devices as jdev
from repro.core import virtualization as jvirt
from repro.engine import AnalogEngine as JaxEngine
from repro_torch import solvers as tsol
from repro_torch.core import CrossbarConfig, MCAGeometry, get_device
from repro_torch.core.prng import fold_in, generator
from repro_torch.engine import AnalogEngine
from repro_torch.interop import config_from_dict
from repro_torch.solvers import stationary

N = 48
KEY = jax.random.PRNGKey(0)          # the reference solvers' key
PROGRAM_KEY = 17
# (operator, port backend); the port's "cuda" is held to JAX's "pallas".
CASES = [("digital", None), ("neumann", "reference"), ("neumann", "cuda"),
         ("thomas", "reference"), ("thomas", "cuda")]
CASE_IDS = [k if b is None else f"{k}-{b}" for k, b in CASES]
JAX_BACKEND = {"reference": "reference", "cuda": "pallas"}

# The reference registry's eigen run (tests/test_solver_contracts.py RUN,
# solvers/registry.py _s_lanczos / _s_lobpcg); slack and floors from the
# port's registry, which tests/test_torch_contracts.py holds to the
# reference's.
CONTRACT_TOL, CONTRACT_MAXITER = 1e-3, 32
_EIGEN_SPECS = {s.name: s for s in tsol.registry() if s.family == "eigen"}
SLACK = {name: spec.slack for name, spec in _EIGEN_SPECS.items()}
FLOOR = {name: spec.floor for name, spec in _EIGEN_SPECS.items()}
SEEDS = range(8)
CONDS = [10.0, 200.0]


def rotated(lam, seed) -> np.ndarray:
    """``Q diag(lam) Q'`` with Q from a numpy-seeded Gaussian, float32."""
    n = len(lam)
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((n, n)))
    a = (q * np.asarray(lam)[None, :]) @ q.T
    return (0.5 * (a + a.T)).astype(np.float32)


def separated(n=N, seed=0) -> np.ndarray:
    """Spectrum in [1, 2] with two separated eigenvalues at each end."""
    return rotated(np.concatenate([[1.0, 1.1], np.linspace(1.25, 1.75, n - 4),
                                   [1.9, 2.0]]), seed)


def contract_problem(seed, cond) -> np.ndarray:
    """The registry's ``_eigen_problem`` in numpy: n 9 or 12, eigenvalues
    log-spaced over ``cond``."""
    n = (9, 12)[seed % 2]
    return rotated(np.logspace(0.0, np.log10(cond), n), 1000 + seed)


def lanczos_v0(n: int) -> np.ndarray:
    """The reference Lanczos's start vector: the power iteration's draw
    under ``fold_in(key, 900_007)``."""
    k = jax.random.fold_in(jax.random.fold_in(KEY, 900_007), 0)
    return np.array(jax.random.normal(k, (n, 1), jnp.float32))


def matrix(shape, seed) -> np.ndarray:
    """A square case's separated SPD matrix, or an m x n Gaussian scaled by
    1 / sqrt(m)."""
    if shape[0] == shape[1]:
        return separated(shape[0], seed)
    return (np.random.default_rng(seed).standard_normal(shape)
            / np.sqrt(shape[0])).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _programmed(kind, backend, shape, seed):
    a = matrix(shape, seed)
    cfg = jcb.CrossbarConfig(device=jdev.get_device("epiram"),
                             geom=jvirt.MCAGeometry(2, 2, 16, 16),
                             encode_inputs=False, denoise_method=kind,
                             lam=1e-2)
    pcfg = config_from_dict(dataclasses.asdict(cfg))
    key = jax.random.PRNGKey(PROGRAM_KEY)
    ja = JaxEngine(cfg, backend=JAX_BACKEND[backend]).program(
        jnp.asarray(a), key)
    mb, nb = ja.at_blocks.shape[:2]
    eta = torch.from_numpy(program_eta(key, cfg, mb, nb))
    pa = AnalogEngine(pcfg, backend=backend, device="cpu").program(
        a, 0, eta=eta)
    return ja, pa


def operands(kind, backend, shape=(N, N), seed=0):
    """(JAX operand, port operand) of one case."""
    if kind == "digital":
        a = matrix(shape, seed)
        return jnp.asarray(a), torch.from_numpy(a)
    return _programmed(kind, backend, shape, seed)


def sign_free_gap(got, want) -> float:
    """Worst column's rel-L2 distance, each column up to its sign."""
    g = got.numpy().astype(np.float64)
    w = np.asarray(want, np.float64)
    g, w = (g if g.ndim == 2 else g[:, None]), (w if w.ndim == 2 else
                                               w[:, None])
    assert g.shape == w.shape
    return max(min(np.linalg.norm(g[:, j] - w[:, j]),
                   np.linalg.norm(g[:, j] + w[:, j]))
               / np.linalg.norm(w[:, j]) for j in range(w.shape[1]))


def eig_rel(got, want) -> float:
    g = got.numpy().astype(np.float64)
    w = np.asarray(want, np.float64)
    return float(np.max(np.abs(g - w) / np.abs(w)))


def assert_same_eigen_solve(got, want):
    assert got.iterations == int(want.iterations)
    assert got.converged == bool(want.converged)
    assert got.ledger.mvms == int(want.ledger.mvms)
    assert got.ledger.mvms_single == int(want.ledger.mvms_single)
    assert eig_rel(got.eigenvalues, want.eigenvalues) <= 5e-5
    assert sign_free_gap(got.x, want.x) <= 1e-4
    assert got.ledger.total_energy_j == pytest.approx(
        float(want.ledger.total_energy_j), rel=1e-4)
    assert got.ledger.total_latency_s == pytest.approx(
        float(want.ledger.total_latency_s), rel=1e-4)


# --------------------------------------------------------------- parity
@pytest.mark.parametrize("kind,backend", CASES, ids=CASE_IDS)
def test_lanczos_matches(kind, backend):
    ja, pa = operands(kind, backend)
    want = jsol.lanczos(ja, tol=1e-3, maxiter=32, key=KEY)
    got = tsol.lanczos(pa, tol=1e-3, maxiter=32, v0=lanczos_v0(N))
    assert want.converged and got.solver == "lanczos"
    assert got.x.shape == (N, 2) and got.eigenvalues.shape == (2,)
    assert_same_eigen_solve(got, want)
    assert got.ledger.mvms == 0 and got.ledger.mvms_single == \
        8 + got.iterations
    # The Ritz-residual history, row for row (row 0 is inf by design).
    k = got.iterations
    h_t, h_j = got.residuals.numpy()[:k], np.asarray(want.residuals)[:k]
    assert np.isinf(h_t[0]).all() and np.isinf(h_j[0]).all()
    assert np.allclose(h_t[1:], h_j[1:], rtol=1e-3, atol=1e-7)
    assert np.isnan(got.residuals.numpy()[k:]).all()


@pytest.mark.parametrize("which", ["largest", "smallest"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("kind,backend", CASES, ids=CASE_IDS)
def test_lobpcg_matches(kind, backend, k, which):
    """``x0`` a vector for k = 1 (the result squeezes), a block for k = 2.
    An image at lam 1e-2 is not symmetric (its tier-2 acts on the output
    alone; 0.7 % of its norm), which holds LOBPCG's Ritz residual near 2e-3
    at the bottom of the spectrum, so images run at tol 1e-2."""
    ja, pa = operands(kind, backend)
    tol = 1e-4 if kind == "digital" else 1e-2
    x0 = np.random.default_rng(7).standard_normal((N, k)).astype(np.float32)
    x0 = x0[:, 0] if k == 1 else x0
    want = jsol.lobpcg(ja, k, which=which, tol=tol, maxiter=40,
                       x0=jnp.asarray(x0), key=KEY)
    got = tsol.lobpcg(pa, k, which=which, tol=tol, maxiter=40, x0=x0)
    assert want.converged and got.iterations >= 2, want
    assert got.x.shape == ((N,) if k == 1 else (N, k))
    assert_same_eigen_solve(got, want)
    assert got.ledger.mvms == 1 + 3 * got.iterations
    assert got.initial_residual == pytest.approx(
        float(want.initial_residual), rel=1e-4)
    # The ends of the spectrum, as far as the image's error lets them be.
    ends = [1.9, 2.0] if which == "largest" else [1.0, 1.1]
    assert np.allclose(np.sort(got.eigenvalues.numpy()), ends[-k:]
                       if which == "largest" else ends[:k], rtol=0.05)


@pytest.mark.parametrize("kind,backend", CASES, ids=CASE_IDS)
def test_operator_norm_matches(kind, backend):
    """A rectangular 24 x 40 image: Lanczos on ``[[0, A], [A', 0]]``."""
    m, n = 24, 40
    ja, pa = operands(kind, backend, shape=(m, n), seed=3)
    want = jsol.operator_norm(ja, key=KEY)
    got = tsol.operator_norm(pa, v0=lanczos_v0(m + n))
    assert isinstance(got, float)
    assert abs(got - want) / abs(want) <= 5e-5
    if kind == "digital":
        assert got == pytest.approx(
            float(np.linalg.norm(pa.numpy().astype(np.float64), 2)),
            rel=1e-3)


@pytest.mark.parametrize("iters", [1, 16])
@pytest.mark.parametrize("kind,backend", CASES, ids=CASE_IDS)
def test_lanczos_spectral_bounds_match(kind, backend, iters):
    """``spectral_bounds(method="lanczos")`` is ``lanczos(tol=0,
    maxiter=max(iters, 2))`` under its key, in both packages; with the
    reference's start injected the two packages agree, and
    ``estimate_omega`` derives from the same bounds."""
    ja, pa = operands(kind, backend)
    want = jsol.spectral_bounds(ja, key=KEY, iters=iters, method="lanczos")
    sweep = tsol.lanczos(pa, tol=0.0, maxiter=max(iters, 2),
                         v0=lanczos_v0(N))
    assert sweep.iterations == max(iters, 2) and not sweep.converged
    assert eig_rel(sweep.eigenvalues, np.asarray(want)) <= 5e-5
    got = tsol.spectral_bounds(pa, key=5, iters=iters, method="lanczos")
    own = tsol.lanczos(pa, tol=0.0, maxiter=max(iters, 2), key=5)
    assert got == (float(own.eigenvalues[0]), float(own.eigenvalues[1]))
    omega = tsol.estimate_omega(pa, key=5, iters=iters, method="lanczos")
    assert omega == float(2.0 / (1.05 * got[1] + max(got[0], 0.0)))


# ------------------------------------------------------------ contracts
def _contract_solve(name, a, **kw):
    kw = dict(tol=CONTRACT_TOL, maxiter=CONTRACT_MAXITER, key=0, **kw)
    if name == "lanczos":
        return tsol.lanczos(a, **kw)
    return tsol.lobpcg(a, 2, which="smallest", **kw)


def _recompute(a, res) -> float:
    """The registry's digital recompute: the worst pair's relative Ritz
    residual ``||a y - theta y|| / |theta|`` (float64)."""
    a = np.asarray(a, np.float64)
    x = res.x.numpy().astype(np.float64)
    x = x if x.ndim == 2 else x[:, None]
    theta = res.eigenvalues.numpy().astype(np.float64)
    resid = np.linalg.norm(a @ x - x * theta[None, :], axis=0)
    return float(np.max(resid / np.maximum(np.abs(theta), 1e-30)))


@pytest.mark.parametrize("cond", CONDS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["lanczos", "lobpcg"])
def test_contract_residual_honesty(name, seed, cond):
    """The recorded residual is the digitally recomputable one, both ways:
    ``recompute <= max(slack * recorded, floor)`` and the reverse."""
    a = contract_problem(seed, cond)
    res = _contract_solve(name, torch.from_numpy(a))
    recorded = float(res.final_residual)
    rec = _recompute(a, res)
    assert math.isfinite(recorded), res
    assert rec <= max(SLACK[name] * recorded, FLOOR[name]), (rec, recorded)
    assert recorded <= max(SLACK[name] * rec, FLOOR[name]), (rec, recorded)


@pytest.mark.parametrize("cond", CONDS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["lanczos", "lobpcg"])
def test_contract_converged_flag(name, seed, cond):
    """``converged`` iff ``final_residual <= tol`` (a NaN never
    converges)."""
    res = _contract_solve(name, torch.from_numpy(contract_problem(seed,
                                                                  cond)))
    final = float(res.final_residual)
    assert res.converged == (math.isfinite(final) and final <= CONTRACT_TOL)


@pytest.mark.parametrize("which", ["largest", "smallest"])
@pytest.mark.parametrize("k", [1, 2])
def test_contract_lobpcg_identity_converges_at_entry(k, which):
    """Every vector of the identity is an eigenvector: LOBPCG reports 0
    iterations, converged, a finite entry residual, and bills the entry
    MVM."""
    res = tsol.lobpcg(torch.eye(8), k, which=which, tol=1e-6, maxiter=32)
    assert res.iterations == 0 and res.converged, res
    assert math.isfinite(res.final_residual) and res.final_residual <= 1e-6
    assert res.ledger.mvms == 1
    assert torch.allclose(res.eigenvalues, torch.ones(k))


@pytest.mark.parametrize("name", ["lanczos", "lobpcg"])
def test_contract_ledger_arithmetic(name):
    """On an analog operator the total energy is the write plus the four
    (count x rate) terms exactly; on the digital operator the same solve
    bills zero energy and still counts its MVMs."""
    a = contract_problem(1, 50.0)
    cfg = CrossbarConfig(device=get_device("epiram"),
                         geom=MCAGeometry(1, 1, 32, 32), k_iters=5)
    A = AnalogEngine(cfg, device="cpu").program(a, 0)
    led = _contract_solve(name, A).ledger
    counts = (led.mvms, led.mvms_single, led.mvms_t, led.mvms_single_t)
    assert all(c >= 0 for c in counts) and sum(counts) >= 1, counts
    assert led.write_energy_j > 0
    assert led.total_energy_j == pytest.approx(
        led.write_energy_j
        + led.mvms * float(led.input_stats.energy_j)
        + led.mvms_single * float(led.input_stats_single.energy_j)
        + led.mvms_t * float(led.input_stats_t.energy_j)
        + led.mvms_single_t * float(led.input_stats_single_t.energy_j))
    assert led.total_energy_j > led.write_energy_j
    led_d = _contract_solve(name, torch.from_numpy(a)).ledger
    assert led_d.total_energy_j == 0.0
    assert led_d.mvms + led_d.mvms_single >= 1


# ----------------------------------------------------------- validation
_RECT = np.ones((6, 9), np.float32)
_SQ = np.eye(9, dtype=np.float32)


@pytest.mark.parametrize("call,match", [
    (lambda: tsol.lanczos(_RECT, device="cpu"), "square"),
    (lambda: tsol.lanczos(_SQ, maxiter=1, device="cpu"), "maxiter >= 2"),
    (lambda: tsol.lobpcg(_RECT, device="cpu"), "square"),
    (lambda: tsol.lobpcg(_SQ, which="middle", device="cpu"), "which"),
    (lambda: tsol.lobpcg(_SQ, 0, device="cpu"), "1 <= k <= n//3"),
    (lambda: tsol.lobpcg(_SQ, 4, device="cpu"), "1 <= k <= n//3"),
    (lambda: tsol.lobpcg(_SQ, 2, x0=np.ones((9, 3), np.float32),
                         device="cpu"), "x0 has shape"),
    (lambda: tsol.operator_norm(tsol.as_operator(
        lambda v, _k: v, shape=(9, 9), device="cpu")), "rmatvec"),
    (lambda: tsol.spectral_bounds(_SQ, method="qr", device="cpu"),
     "method"),
    (lambda: tsol.estimate_omega(_SQ, method="qr", device="cpu"), "method"),
], ids=["lanczos-rect", "lanczos-maxiter", "lobpcg-rect", "lobpcg-which",
        "lobpcg-k0", "lobpcg-k-big", "lobpcg-x0", "opnorm-no-rmatvec",
        "bounds-method", "omega-method"])
def test_validation_errors(call, match):
    with pytest.raises(ValueError, match=match):
        call()


# ------------------------------------------------------ power unchanged
def _power_before(matvec, n, key, iters, shift=None):
    """``_power_extreme`` as it was before ``_power_iterate`` existed."""
    v = torch.randn(n, 1, generator=generator(fold_in(key, 0), "cpu"))
    v = v / torch.clamp(torch.linalg.vector_norm(v, dim=0), min=1e-30)
    lam = torch.zeros(())
    for i in range(iters):
        w = matvec(v, fold_in(key, 1 + i))
        if shift is not None:
            w = shift * v - w
        lam = torch.sqrt(torch.sum(w * w, dim=0))[0]
        v = w / torch.clamp(lam, min=1e-30)
    return lam


@pytest.mark.parametrize("key", [0, 11])
def test_power_method_unchanged(key):
    """``method="power"`` (the default) gives the same bounds and omega, bit
    for bit, as the power iteration before this change; Richardson's auto
    omega still equals ``estimate_omega``; the non-eigen solvers return no
    eigenvalues."""
    a = torch.from_numpy(separated(32, 4))
    op = tsol.as_operator(a)
    lmax = _power_before(op.matvec, 32, fold_in(key, 1), 16)
    lmin = lmax - _power_before(op.matvec, 32, fold_in(key, 2), 16,
                                shift=lmax)
    assert tsol.spectral_bounds(a, key=key) == (float(lmin), float(lmax))
    assert tsol.spectral_bounds(a, key=key, method="power") == \
        (float(lmin), float(lmax))
    pk = fold_in(key, 900_001)
    lmax = _power_before(op.matvec, 32, fold_in(pk, 1), 16)
    lmin = lmax - _power_before(op.matvec, 32, fold_in(pk, 2), 16,
                                shift=lmax)
    omega = float(2.0 / (1.05 * lmax + torch.clamp(lmin, min=0.0)))
    assert tsol.estimate_omega(a, key=key) == omega
    b = np.ones(32, np.float32)
    auto = tsol.richardson(a, b, tol=1e-6, maxiter=60, key=key)
    fixed = tsol.richardson(a, b, omega=omega, tol=1e-6, maxiter=60,
                            key=key)
    assert auto.iterations == fixed.iterations and auto.converged
    assert torch.equal(auto.x, fixed.x)
    assert auto.eigenvalues is None and tsol.cg(a, b).eigenvalues is None
    # The start vector can be injected: the key's own draw, passed in,
    # gives the same iterate bit for bit.
    v0 = torch.randn(32, 1, generator=generator(fold_in(key, 0), "cpu"))
    drawn = stationary._power_iterate(op.matvec, 32, key, 5, "cpu")
    given = stationary._power_iterate(op.matvec, 32, key, 5, "cpu", v0=v0)
    assert all(torch.equal(d, g) for d, g in zip(drawn, given))
