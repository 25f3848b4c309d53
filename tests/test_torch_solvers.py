"""The port's solvers held to the JAX solvers: the CG and Richardson cores
on a deterministic bare-matvec operator (same iterations, x within 1e-5),
Jacobi, the ledger and iteration-0 honesty, the spectral estimate, and
analog solves on both backends."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads, rel, rng_array  # noqa: F401
from repro import solvers as jsol
from repro_torch import solvers as tsol
from repro_torch.core import CrossbarConfig, MCAGeometry, get_device
from repro_torch.engine import AnalogEngine


def spd(n, seed=30, scale=2.0):
    r = rng_array((n, n), seed) / n
    a = (r + r.T + scale * np.eye(n)).astype(np.float32)
    x = rng_array((n,), seed + 1)
    return a, x, (a @ x).astype(np.float32)


def bare_ops(a):
    """The same deterministic matvec in both packages (the key is ignored)."""
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    jop = jsol.as_operator(lambda v, _k: aj @ v, shape=a.shape)
    top = tsol.as_operator(lambda v, _k: at @ v, shape=a.shape, device="cpu")
    return jop, top


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_cg_core_matches(batch, backend):
    a, _, _ = spd(96, scale=0.6)
    b = rng_array((96, batch), 40)[:, 0] if batch == 1 else \
        rng_array((96, batch), 40)
    jop, top = bare_ops(a)
    want = jsol.cg(jop, jnp.asarray(b), tol=1e-6, maxiter=60,
                   backend="pallas" if backend == "cuda" else None)
    got = tsol.cg(top, b, tol=1e-6, maxiter=60, backend=backend)
    assert got.iterations == want.iterations > 3
    assert got.converged == want.converged
    assert rel(got.x, want.x) <= 1e-5
    assert got.ledger.mvms == want.ledger.mvms


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_richardson_core_matches(backend):
    a, _, b = spd(96, seed=32, scale=1.0)
    jop, top = bare_ops(a)
    want = jsol.richardson(jop, jnp.asarray(b), omega=0.6, tol=1e-5,
                           maxiter=80,
                           backend="pallas" if backend == "cuda" else None)
    got = tsol.richardson(top, b, omega=0.6, tol=1e-5, maxiter=80,
                          backend=backend)
    assert got.iterations == want.iterations > 3
    assert got.converged and want.converged
    assert rel(got.x, want.x) <= 1e-5
    assert rel(got.residuals[:got.iterations],
               want.residuals[:want.iterations]) <= 1e-4


def test_jacobi_matches():
    a, _, b = spd(64, seed=34)
    a[np.diag_indices(64)] += np.linspace(0.0, 1.0, 64, dtype=np.float32)
    want = jsol.jacobi(jnp.asarray(a), jnp.asarray(b), tol=1e-6, maxiter=60)
    got = tsol.jacobi(torch.from_numpy(a), b, tol=1e-6, maxiter=60,
                      device="cpu")
    assert got.iterations == want.iterations
    assert rel(got.x, want.x) <= 1e-5


def test_spectral_estimate_close_to_reference():
    """The port's power iteration starts from its own draw, so the estimate
    matches the reference's to the method's accuracy, not bitwise: on a
    spectrum with separated ends both reach the true bounds."""
    n = 64
    q, _ = np.linalg.qr(np.random.default_rng(36).standard_normal((n, n)))
    lam = np.concatenate([[0.5], np.linspace(1.0, 2.0, n - 2), [3.0]])
    a = ((q * lam) @ q.T).astype(np.float32)
    t_lo, t_hi = tsol.spectral_bounds(a, iters=40, device="cpu")
    assert t_hi == pytest.approx(3.0, rel=1e-3)
    assert t_lo == pytest.approx(0.5, rel=1e-2)
    assert tsol.estimate_omega(a, iters=40, device="cpu") == \
        pytest.approx(jsol.estimate_omega(jnp.asarray(a), iters=40), rel=1e-2)


def test_iteration_zero_honesty_and_ledger():
    a, _, _ = spd(32, seed=38)
    res = tsol.cg(a, np.zeros(32, np.float32), tol=1e-6, device="cpu")
    assert res.iterations == 0 and res.converged
    assert res.final_residual == 0.0
    assert np.isnan(res.residuals.numpy()).all()
    res = tsol.richardson(a, np.zeros(32, np.float32), omega=0.5,
                          tol=1e-6, device="cpu")
    assert res.iterations == 1 and res.converged


def test_operator_device_defaults():
    """A tensor keeps its device; an array or a bare matvec carries none and
    goes to ``cuda`` unless ``device=`` says otherwise -- never silently to
    the CPU (without CUDA that raises)."""
    a = np.eye(4, dtype=np.float32)
    assert tsol.as_operator(torch.from_numpy(a)).device.type == "cpu"
    assert tsol.as_operator(a, device="cpu").device.type == "cpu"
    assert tsol.as_operator(lambda v, _k: v, shape=(4, 4),
                            device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert tsol.as_operator(a).device.type == "cuda"
    else:
        with pytest.raises(AssertionError, match="CUDA"):
            tsol.cg(a, np.ones(4, np.float32))


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_analog_solves_converge(backend):
    """CG and auto-omega Richardson on a programmed epiram image (EC on), as
    examples/meliso_solver.py runs them; the ledger bills the image once."""
    a, x_true, b = spd(128, seed=42)
    cfg = CrossbarConfig(device=get_device("epiram"),
                         geom=MCAGeometry(2, 2, 32, 32))
    A = AnalogEngine(cfg, backend=backend, device="cpu").program(a, 0)
    for res in (tsol.cg(A, b, tol=1e-3, maxiter=50, backend=backend),
                tsol.richardson(A, b, tol=1e-3, maxiter=50, backend=backend)):
        assert res.converged, res
        assert rel(res.x, x_true) <= 1e-3
        led = res.ledger
        assert led.write_energy_j == A.write_stats.energy_j
        want = led.write_energy_j + led.mvms * A.input_write_stats(1).energy_j \
            + led.mvms_single * A.input_write_stats(1).energy_j
        assert led.total_energy_j == pytest.approx(want, rel=1e-9)
    assert res.ledger.mvms_single == 32            # 2 x 16 power iterations
