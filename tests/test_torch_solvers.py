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


# ------------------------------------- least squares and LP (A @ x, A.T @ y)
def lstsq_problem(m=96, n=48, seed=50, batch=1):
    """A consistent plus a small inconsistent part: a least-squares problem
    whose residual does not vanish."""
    a = rng_array((m, n), seed) / np.sqrt(m)
    x = rng_array((n, batch), seed + 1)
    b = a @ x + 0.01 * rng_array((m, batch), seed + 2)
    if batch == 1:
        x, b = x[:, 0], b[:, 0]
    return a.astype(np.float32), x.astype(np.float32), b.astype(np.float32)


def bare_ops_t(a):
    """Deterministic matvec + rmatvec in both packages (keys ignored)."""
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    jop = jsol.as_operator(lambda v, _k: aj @ v, shape=a.shape,
                           rmatvec=lambda u, _k: aj.T @ u)
    top = tsol.as_operator(lambda v, _k: at @ v, shape=a.shape,
                           rmatvec=lambda u, _k: at.T @ u, device="cpu")
    return jop, top


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("solver", ["lsqr", "lsmr"])
def test_lstsq_core_matches(solver, batch):
    """The same numpy problem through both packages on a digital operator:
    the same iteration count, x within 1e-4, the same ledger counts."""
    a, _, b = lstsq_problem(batch=batch)
    jop, top = bare_ops_t(a)
    want = getattr(jsol, solver)(jop, jnp.asarray(b), tol=1e-5, maxiter=80)
    got = getattr(tsol, solver)(top, b, tol=1e-5, maxiter=80)
    assert got.iterations == want.iterations > 3
    assert got.converged == want.converged
    assert rel(got.x, want.x) <= 1e-4
    assert (got.ledger.mvms, got.ledger.mvms_t) == \
        (int(want.ledger.mvms), int(want.ledger.mvms_t))
    assert rel(got.residuals[:got.iterations],
               want.residuals[:want.iterations]) <= 1e-3
    # with a start point: one more transposed MVM for ||A'b||
    x0 = np.full(a.shape[1], 0.1, np.float32) if batch == 1 else \
        np.full((a.shape[1], batch), 0.1, np.float32)
    want = getattr(jsol, solver)(jop, jnp.asarray(b), tol=1e-5, maxiter=80,
                                 x0=jnp.asarray(x0))
    got = getattr(tsol, solver)(top, b, tol=1e-5, maxiter=80, x0=x0)
    assert got.iterations == want.iterations
    assert got.ledger.mvms_t == got.ledger.mvms + 1 == int(want.ledger.mvms_t)
    assert rel(got.x, want.x) <= 1e-4


def lp_problem(m=32, n=48, seed=14, batch=1):
    """The JAX package's random feasible LP, carried across as numpy."""
    import jax
    out = jsol.random_feasible_lp(jax.random.PRNGKey(seed), m, n, batch)
    return [np.array(v, np.float32) for v in out]


@pytest.mark.parametrize("steps", ["given", "estimated"])
def test_pdhg_core_matches(steps):
    """PDHG on a digital operator from the same numpy LP: iterations within
    one of the reference's (equal with given steps; the estimated steps come
    from power iterations that start from each package's own draw), x within
    1e-4."""
    a, b, c, x_star, _ = lp_problem()
    jop, top = bare_ops_t(a)
    kw = dict(tol=1e-4, maxiter=5000)
    if steps == "given":
        step = 0.9 / float(np.linalg.norm(a, 2))
        kw.update(tau=step, sigma=step)
    else:
        kw.update(power_iters=60)
    want = jsol.pdhg(jop, jnp.asarray(b), jnp.asarray(c), **kw)
    got = tsol.pdhg(top, b, c, **kw)
    assert want.converged and got.converged
    assert abs(got.iterations - want.iterations) <= (0 if steps == "given"
                                                     else 1)
    assert rel(got.x, want.x) <= 1e-4 and rel(got.dual, want.dual) <= 1e-4
    assert got.ledger.mvms == got.ledger.mvms_t == got.iterations + 1
    assert got.ledger.mvms_single == got.ledger.mvms_single_t == \
        (0 if steps == "given" else 60)
    assert rel(got.x, x_star) <= 1e-2


def test_random_feasible_lp_has_a_known_optimum():
    """Primal feasibility, dual feasibility and complementary slackness by
    construction, so c'x* = b'y*; same seed, same LP."""
    a, b, c, x_star, y_star = tsol.random_feasible_lp(3, 40, 64, batch=3,
                                                      device="cpu")
    assert a.shape == (40, 64) and b.shape == (40, 3) and c.shape == (64, 3)
    assert rel(a @ x_star, b) <= 1e-6 and bool((x_star >= 0).all())
    s = c - a.T @ y_star
    assert float(s.min()) >= -1e-5                     # dual feasible
    assert float((s * x_star).abs().max()) <= 1e-5     # complementary
    gap = (c * x_star).sum(0) - (b * y_star).sum(0)
    assert float(gap.abs().max()) <= 1e-4 * float((c * x_star).sum(0)
                                                  .abs().max() + 1)
    again = tsol.random_feasible_lp(3, 40, 64, batch=3, device="cpu")
    assert torch.equal(again[0], a) and torch.equal(again[2], c)
    a1, b1, c1, x1, y1 = tsol.random_feasible_lp(4, 8, 12, device="cpu")
    assert b1.shape == (8,) and c1.shape == (12,) and y1.shape == (8,)


def test_transposed_operator_and_ledger():
    """``as_operator(A.T)`` / ``LinearOperator.T`` swap the directions and
    share the image's write cost; a matvec without rmatvec cannot serve
    LSQR or PDHG; the five-rate ledger adds up as the reference's does."""
    cfg = CrossbarConfig(device=get_device("epiram"),
                         geom=MCAGeometry(2, 2, 32, 16))
    a = rng_array((70, 40), 60)
    eng = AnalogEngine(cfg, device="cpu")
    A = eng.program(a, 0)
    op = tsol.as_operator(A.T)
    assert op.shape == (40, 70) and op.T.shape == (70, 40)
    u = torch.from_numpy(rng_array((40, 1), 61))
    v = torch.from_numpy(rng_array((70, 1), 62))
    assert torch.equal(op.matvec(v, 7), eng.rmvm(A, v, key=7))
    assert torch.equal(op.rmatvec(u, 7), eng.mvm(A, u, key=7))
    assert op.write_stats is A.write_stats
    assert op.input_stats(2).energy_j == A.T.input_write_stats(2).energy_j
    assert rel(op.dense(), a.T) <= 1e-6
    dense = tsol.as_operator(torch.from_numpy(a))
    assert rel(dense.T.matvec(v, 0), a.T @ v.numpy()) <= 1e-6
    bare = tsol.as_operator(lambda w, _k: w, shape=(40, 40), device="cpu")
    for solve in (lambda: tsol.lsqr(bare, np.ones(40, np.float32)),
                  lambda: tsol.pdhg(bare, np.ones(40, np.float32),
                                    np.ones(40, np.float32))):
        with pytest.raises(ValueError, match="rmatvec"):
            solve()
    with pytest.raises(ValueError, match="rmatvec"):
        bare.T
    # The ledger's arithmetic against the reference's, on the same rates.
    from repro.core import write_verify as jwv
    rates = [A.input_write_stats(3), A.input_write_stats(1),
             A.T.input_write_stats(3), A.T.input_write_stats(1)]
    counts = dict(mvms=5, mvms_single=16, mvms_t=6, mvms_single_t=16)

    def jstats(s):
        return jwv.WriteStats(energy_j=jnp.float32(s.energy_j),
                              latency_s=jnp.float32(s.latency_s),
                              iterations=jnp.int32(s.iterations),
                              final_delta=jnp.float32(s.final_delta))

    names = ["input_stats", "input_stats_single", "input_stats_t",
             "input_stats_single_t"]
    got = tsol.SolveLedger(write_stats=A.write_stats,
                           **dict(zip(names, rates)), **counts)
    want = jsol.SolveLedger(write_stats=jstats(A.write_stats),
                            **dict(zip(names, map(jstats, rates))), **counts)
    assert got.total_energy_j == pytest.approx(want.total_energy_j, rel=1e-6)
    assert got.total_latency_s == pytest.approx(want.total_latency_s,
                                                rel=1e-6)
    assert rates[2].energy_j != rates[0].energy_j    # non-square: differ


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_analog_lstsq_and_pdhg_converge(backend):
    """LSQR and LSMR on a programmed rectangular image and PDHG on a
    programmed LP (epiram, EC on): converged, with x error (least squares)
    and objective gap (LP) within 2x of the JAX package's analog solves of
    the same problems (their own noise draws), plus a 1e-5 floor."""
    import jax
    from repro.core import crossbar as jcb
    from repro.core import devices as jdev
    from repro.core import virtualization as jvirt
    from repro.engine import AnalogEngine as JaxEngine
    jcfg = jcb.CrossbarConfig(device=jdev.get_device("epiram"),
                              geom=jvirt.MCAGeometry(2, 2, 32, 32))
    cfg = CrossbarConfig(device=get_device("epiram"),
                         geom=MCAGeometry(2, 2, 32, 32))
    jeng = JaxEngine(jcfg, backend="pallas" if backend == "cuda"
                     else "reference")
    eng = AnalogEngine(cfg, backend=backend, device="cpu")

    a = rng_array((150, 70), 63) / np.sqrt(150)
    x_true = rng_array((70,), 64)
    b = (a @ x_true).astype(np.float32)
    A = eng.program(a, 1)
    jA = jeng.program(jnp.asarray(a), jax.random.PRNGKey(1))
    for name in ("lsqr", "lsmr"):
        got = getattr(tsol, name)(A, b, tol=1e-3, maxiter=100)
        want = getattr(jsol, name)(jA, jnp.asarray(b), tol=1e-3, maxiter=100)
        assert got.converged and want.converged, (got, want)
        assert rel(got.x, x_true) <= 2 * rel(want.x, x_true) + 1e-5
        assert got.ledger.mvms_t == got.ledger.mvms == got.iterations + 1

    a, b, c, x_star, _ = lp_problem(48, 64, seed=12)
    obj = float(c @ x_star)
    A = eng.program(a, 2)
    jA = jeng.program(jnp.asarray(a), jax.random.PRNGKey(2))
    got = tsol.pdhg(A, b, c, tol=1e-3, maxiter=5000)
    want = jsol.pdhg(jA, jnp.asarray(b), jnp.asarray(c), tol=1e-3,
                     maxiter=5000)
    assert got.converged and want.converged, (got, want)
    gap = abs(float(c @ got.x.numpy()) - obj) / (1 + abs(obj))
    jgap = abs(float(c @ np.asarray(want.x)) - obj) / (1 + abs(obj))
    assert gap <= 2 * jgap + 1e-5, (gap, jgap)
    led = got.ledger
    assert led.mvms_single == led.mvms_single_t == 16
    assert led.total_energy_j == pytest.approx(
        led.write_energy_j
        + led.mvms * led.input_stats.energy_j
        + led.mvms_single * led.input_stats_single.energy_j
        + led.mvms_t * led.input_stats_t.energy_j
        + led.mvms_single_t * led.input_stats_single_t.energy_j, rel=1e-9)
