"""The port's linearized ADMM held to the JAX package's.

Parity: the reference's ``random_box_qp`` (``jax.random``) at (m, n) =
(48, 32), batch 1 and 3, carried across as numpy, through both packages on
a digital operator and on programmed images (epiram, EC on, the
reference's programming draws injected, the input DAC off so that each MVM
is a deterministic function of the image) with the Neumann tier-2 and the
exact Thomas tier-2 at lam 1e-2, on the port's ``reference`` and ``cuda``
backends against the JAX ``reference`` and ``pallas`` backends.  The step
``mu`` is given (the default one comes from a power iteration that starts
from each package's own draw).  Each case checks iterations, ``converged``
and the four MVM counts for equality, ``x`` and ``dual`` to 1e-5 rel-L2,
the KKT history to 1e-5 and the ledger's energy and latency to 1e-4.

Beside it: ``mu=None`` in both packages, the port's ``random_box_qp``
(known optimum, seeding, shapes), entry honesty and the argument checks.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads, program_eta, rel  # noqa: F401
from repro import solvers as jsol
from repro.core import crossbar as jcb
from repro.core import devices as jdev
from repro.core import virtualization as jvirt
from repro.engine import AnalogEngine as JaxEngine
from repro_torch import solvers as tsol
from repro_torch.core import CrossbarConfig, MCAGeometry, get_device
from repro_torch.engine import AnalogEngine
from repro_torch.interop import config_from_dict

M, N = 48, 32
KEY = jax.random.PRNGKey(0)          # the reference solver's key
PROGRAM_KEY = 17
TOL, MAXITER = 1e-4, 2000
# (operator, port backend); the port's "cuda" is held to JAX's "pallas".
CASES = [("digital", None), ("neumann", "reference"), ("neumann", "cuda"),
         ("thomas", "reference"), ("thomas", "cuda")]
CASE_IDS = [k if b is None else f"{k}-{b}" for k, b in CASES]
JAX_BACKEND = {"reference": "reference", "cuda": "pallas"}


@functools.lru_cache(maxsize=None)
def box_qp(batch, seed=3):
    """The reference's ``random_box_qp`` as numpy arrays."""
    out = jsol.random_box_qp(jax.random.PRNGKey(seed), M, N, batch)
    return tuple(np.array(v, np.float32) for v in out)


def default_mu(a, rho=1.0) -> float:
    """The default step with the exact ``||A||_2``."""
    return 1.0 / (1.05 * (float(np.linalg.norm(a, 2)) ** 2 + rho))


@functools.lru_cache(maxsize=None)
def _programmed(kind, backend):
    a = box_qp(1)[0]
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


def operands(kind, backend):
    if kind == "digital":
        a = box_qp(1)[0]
        return jnp.asarray(a), torch.from_numpy(a)
    return _programmed(kind, backend)


def assert_same_solve(got, want):
    assert got.iterations == int(want.iterations)
    assert got.converged == bool(want.converged)
    for field in ("mvms", "mvms_single", "mvms_t", "mvms_single_t"):
        assert getattr(got.ledger, field) == \
            int(getattr(want.ledger, field)), field
    assert rel(got.x, want.x) <= 1e-5
    assert rel(got.dual, want.dual) <= 1e-5
    k = got.iterations
    assert rel(got.residuals[:k], np.asarray(want.residuals)[:k]) <= 1e-5
    assert np.isnan(got.residuals.numpy()[k:]).all()
    assert got.initial_residual == pytest.approx(
        float(want.initial_residual), rel=1e-5)
    assert got.ledger.total_energy_j == pytest.approx(
        float(want.ledger.total_energy_j), rel=1e-4)
    assert got.ledger.total_latency_s == pytest.approx(
        float(want.ledger.total_latency_s), rel=1e-4)


# --------------------------------------------------------------- parity
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("kind,backend", CASES, ids=CASE_IDS)
def test_admm_matches(kind, backend, batch):
    ja, pa = operands(kind, backend)
    a, b, q, lo, hi, x_star = box_qp(batch)
    mu = default_mu(a)
    want = jsol.admm(ja, jnp.asarray(b), jnp.asarray(q), lo=lo, hi=hi,
                     mu=mu, tol=TOL, maxiter=MAXITER, key=KEY)
    got = tsol.admm(pa, b, q, lo=lo, hi=hi, mu=mu, tol=TOL,
                    maxiter=MAXITER)
    assert want.converged and got.solver == "admm"
    assert got.x.shape == x_star.shape and got.dual.shape == x_star.shape
    assert_same_solve(got, want)
    assert got.ledger.mvms == got.ledger.mvms_t == 1 + got.iterations
    assert got.ledger.mvms_single == got.ledger.mvms_single_t == 0
    # The split copy is in the box; on the digital operator x is x*.
    assert float(got.dual.min()) >= -1.0 and float(got.dual.max()) <= 1.0
    if kind == "digital":
        assert rel(got.x, x_star) <= 10 * TOL


@pytest.mark.parametrize("batch", [1, 3])
def test_admm_default_step(batch):
    """``mu=None`` in both packages on the digital operator: each estimates
    ``||A||_2`` by 16 power steps from its own start vector, bills them as
    16 single and 16 single-transposed MVMs, converges to x* within 10
    tol, in iteration counts within 10 % or 2 of each other."""
    a, b, q, lo, hi, x_star = box_qp(batch)
    want = jsol.admm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(q), lo=lo,
                     hi=hi, tol=TOL, maxiter=MAXITER, key=KEY)
    got = tsol.admm(torch.from_numpy(a), b, q, lo=lo, hi=hi, tol=TOL,
                    maxiter=MAXITER)
    assert want.converged and got.converged
    assert rel(got.x, x_star) <= 10 * TOL
    assert rel(np.asarray(want.x), x_star) <= 10 * TOL
    assert got.ledger.mvms_single == got.ledger.mvms_single_t == 16
    assert int(want.ledger.mvms_single) == 16
    assert abs(got.iterations - int(want.iterations)) <= \
        max(2, 0.1 * int(want.iterations))
    # Equal to the same solve with the port's own estimate passed in.
    from repro_torch.core.prng import fold_in
    from repro_torch.solvers.pdhg import _power_norm
    norm = _power_norm(tsol.as_operator(torch.from_numpy(a)),
                       fold_in(0, 900_005), 16)
    again = tsol.admm(torch.from_numpy(a), b, q, lo=lo, hi=hi, tol=TOL,
                      maxiter=MAXITER,
                      mu=float(1.0 / (1.05 * (torch.square(norm) + 1.0))))
    assert again.iterations == got.iterations
    assert torch.equal(again.x, got.x)


def test_admm_pipeline_is_the_core():
    """``admm_pipeline`` binds the settings of the core ``admm`` runs."""
    a, b, q, lo, hi, _ = box_qp(3)
    op = tsol.as_operator(torch.from_numpy(a))
    mu = default_mu(a)
    core = tsol.admm_pipeline(op, lo=torch.from_numpy(lo),
                              hi=torch.from_numpy(hi), mu=mu, tol=TOL,
                              maxiter=MAXITER)
    x, z, hist, k, mvms, pi, rel0 = core(
        torch.from_numpy(b), torch.from_numpy(q), torch.zeros(N, 3), 0)
    res = tsol.admm(op, b, q, lo=lo, hi=hi, mu=mu, tol=TOL, maxiter=MAXITER)
    assert (k, mvms, pi) == (res.iterations, 1 + res.iterations, 0)
    assert torch.equal(x, res.x) and torch.equal(z, res.dual)
    assert hist.shape == (MAXITER, 3) and rel0.shape == (3,)


def test_scalar_and_vector_bounds_agree():
    """``lo`` / ``hi`` as scalars give the same solve as (n,) vectors."""
    a, b, q, lo, hi, _ = box_qp(1)
    at = torch.from_numpy(a)
    mu = default_mu(a)
    vec = tsol.admm(at, b, q, lo=lo, hi=hi, mu=mu, tol=TOL, maxiter=MAXITER)
    sca = tsol.admm(at, b, q, lo=-1.0, hi=1.0, mu=mu, tol=TOL,
                    maxiter=MAXITER)
    assert vec.iterations == sca.iterations
    assert torch.equal(vec.x, sca.x) and torch.equal(vec.dual, sca.dual)


# ------------------------------------------------------- random_box_qp
def _kkt(a, b, q, lo, hi, x) -> np.ndarray:
    """Projected-gradient stationarity at x (z = x), float64, per column."""
    a, b, q, x = (np.asarray(v, np.float64) for v in (a, b, q, x))
    b, q, x = (v if v.ndim == 2 else v[:, None] for v in (b, q, x))
    grad = a.T @ (a @ x - b) + q
    proj = np.clip(x - grad, np.asarray(lo)[:, None], np.asarray(hi)[:, None])
    return np.linalg.norm(x - proj, axis=0) / (1.0 + np.linalg.norm(x,
                                                                    axis=0))


@pytest.mark.parametrize("batch", [1, 3])
def test_random_box_qp_has_a_known_optimum(batch):
    """x* is KKT-optimal (the digital measure <= 1e-5), lies in the box
    with about ``active_frac`` of it on a bound; shapes and squeezing are
    the reference's; the same seed gives the same QP."""
    m, n = 96, 64
    got = tsol.random_box_qp(3, m, n, batch, device="cpu")
    want = jsol.random_box_qp(jax.random.PRNGKey(3), m, n, batch)
    assert [tuple(v.shape) for v in got] == [tuple(v.shape) for v in want]
    a, b, q, lo, hi, x_star = got
    assert all(v.dtype == torch.float32 for v in got)
    assert float(_kkt(a, b, q, lo, hi, x_star).max()) <= 1e-5
    assert torch.equal(lo, -torch.ones(n)) and torch.equal(hi, torch.ones(n))
    assert float(x_star.abs().max()) <= 1.0
    on_bound = float((x_star.abs() == 1.0).float().mean())
    assert 0.15 <= on_bound <= 0.45
    inside = x_star[x_star.abs() < 1.0]
    assert float(inside.abs().max()) <= 0.9
    again = tsol.random_box_qp(3, m, n, batch, device="cpu")
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    other = tsol.random_box_qp(4, m, n, batch, device="cpu")
    assert not torch.equal(other[0], a)
    assert float(a.var()) == pytest.approx(1.0 / n, rel=0.05)  # N(0, 1/n)


def test_random_box_qp_active_fraction():
    """``active_frac`` sets the share of x* on a bound (0: none)."""
    for frac in (0.0, 0.6):
        x_star = tsol.random_box_qp(1, 40, 400, active_frac=frac,
                                    device="cpu")[5]
        share = float((x_star.abs() == 1.0).float().mean())
        assert abs(share - frac) <= 0.08, (frac, share)


# ------------------------------------------------------- entry honesty
def test_exact_start_converges_at_entry():
    """From x0 = x*, 0 iterations and converged, with the entry MVM pair
    billed, as the reference reports."""
    a, b, q, lo, hi, x_star = box_qp(1)
    want = jsol.admm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(q), lo=lo,
                     hi=hi, x0=jnp.asarray(x_star), mu=default_mu(a),
                     tol=TOL, maxiter=200)
    got = tsol.admm(torch.from_numpy(a), b, q, lo=lo, hi=hi, x0=x_star,
                    mu=default_mu(a), tol=TOL, maxiter=200)
    assert got.iterations == int(want.iterations) == 0
    assert got.converged and bool(want.converged)
    # x* is optimal to float32 rounding in both packages.
    assert got.final_residual <= 1e-6 and float(want.final_residual) <= 1e-6
    assert got.ledger.mvms == got.ledger.mvms_t == 1
    assert torch.equal(got.x, torch.from_numpy(x_star))


@pytest.mark.parametrize("batch", [1, 2])
def test_zero_rhs_converges_at_entry(batch):
    """b = 0, q = 0 from x0 = 0: converged at entry with the init MVM pair
    billed (and, with ``mu=None``, the 16 power steps each way)."""
    a = np.concatenate([np.eye(8, dtype=np.float32),
                        np.ones((4, 8), np.float32)])
    b = np.zeros((12, batch), np.float32)
    q = np.zeros((8, batch), np.float32)
    if batch == 1:
        b, q = b[:, 0], q[:, 0]
    res = tsol.admm(torch.from_numpy(a), b, q, lo=-1.0, hi=1.0, tol=1e-6)
    assert res.iterations == 0 and res.converged
    assert res.final_residual == 0.0
    led = res.ledger
    assert (led.mvms, led.mvms_t, led.mvms_single, led.mvms_single_t) == \
        (1, 1, 16, 16)
    assert np.isnan(res.residuals.numpy()).all()


# ---------------------------------------------------------- validation
_A = np.ones((6, 4), np.float32)


@pytest.mark.parametrize("call,match", [
    (lambda: tsol.admm(tsol.as_operator(lambda v, _k: v, shape=(4, 4),
                                        device="cpu"),
                       np.ones(4, np.float32), np.ones(4, np.float32),
                       lo=-1, hi=1), "rmatvec"),
    (lambda: tsol.admm(_A, np.ones(6, np.float32),
                       np.ones((4, 1), np.float32), lo=-1, hi=1,
                       device="cpu"), "both be vectors"),
    (lambda: tsol.admm(_A, np.ones(5, np.float32), np.ones(4, np.float32),
                       lo=-1, hi=1, device="cpu"), "rows"),
    (lambda: tsol.admm(_A, np.ones(6, np.float32), np.ones(3, np.float32),
                       lo=-1, hi=1, device="cpu"), "rows"),
    (lambda: tsol.admm(_A, np.ones((6, 2), np.float32),
                       np.ones((4, 3), np.float32), lo=-1, hi=1,
                       device="cpu"), "batch"),
    (lambda: tsol.admm(_A, np.ones(6, np.float32), np.ones(4, np.float32),
                       lo=np.array([0, 0, 2, 0], np.float32), hi=1,
                       device="cpu"), "box is empty"),
], ids=["no-rmatvec", "vector-vs-panel", "b-rows", "q-rows",
        "batch-mismatch", "empty-box"])
def test_validation_errors(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_bare_matvec_operator_has_no_rmatvec():
    """The operator a bare matvec makes cannot be transposed, so neither
    ADMM nor ``.T`` can use it; given ``rmatvec=`` ADMM runs."""
    bare = tsol.as_operator(lambda v, _k: v, shape=(4, 4), device="cpu")
    with pytest.raises(ValueError, match="rmatvec"):
        bare.T
    both = tsol.as_operator(lambda v, _k: v, shape=(4, 4), device="cpu",
                            rmatvec=lambda u, _k: u)
    res = tsol.admm(both, np.full(4, 0.5, np.float32),
                    np.zeros(4, np.float32), lo=-1, hi=1, mu=0.4, tol=1e-6)
    assert res.converged
    assert rel(res.x, np.full(4, 0.5, np.float32)) <= 1e-5
