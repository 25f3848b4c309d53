"""The solver-contract suite over the port's registry
(``repro_torch.solvers.registry()``), the twin of
``tests/test_solver_contracts.py``.

Four invariants, held for every registered solver:

  1. residual honesty -- the recorded ``final_residual`` tracks the
     family's residual recomputed digitally at the returned iterates:
     ``recompute <= max(slack * recorded, floor)``, and the reverse bound
     for solvers whose history is not lagged one step;
  2. convergence flag -- ``converged <=> final_residual <= tol``
     (a NaN is never converged);
  3. iteration-0 honesty -- on trivial instances (zero RHS, exact ``x0``)
     the solver reports 0 iterations, converged and a finite entry
     residual, with the entry MVMs still billed;
  4. ledger arithmetic -- on a programmed handle the total energy is the
     write plus the four (rate x count) terms exactly, and the digital
     operator bills zero energy while it still counts MVMs.

Problems come from the port's own makers (``torch.Generator`` draws) on a
fixed sweep of seeds, shapes and conditionings, under the reference
suite's run budgets.  The port's registry is also held to the reference's
flag for flag, and the solvers whose placement matters (LSQR, LSMR,
Lanczos, LOBPCG, ADMM) run equal on a local and a streamed handle of the
same matrix.
"""
import math

import jax
import numpy as np
import pytest
import torch

from _torch_port import few_threads, rel  # noqa: F401
from repro.solvers import registry as jax_registry
from repro_torch import solvers as tsol
from repro_torch.engine import AnalogEngine
from repro_torch.solvers.registry import RUN, contract_config, registry

SPECS = {s.name: s for s in registry()}
NAMES = sorted(SPECS)
PLACED = ("lsqr", "lsmr", "lanczos", "lobpcg", "admm")
KEY = 0


def problem(spec, seed, n, batch, cond=50.0):
    return spec.make_problem(seed, n, batch, cond, device="cpu")


def solve(spec, prob, a=None, **overrides):
    kw = dict(RUN[spec.family])
    kw.update(overrides)
    return spec.solve(prob["a"] if a is None else a, prob, key=KEY, **kw)


# ------------------------------------------------ the registry itself
def test_registry_order_matches_the_reference():
    assert [s.name for s in registry()] == \
        [s.name for s in jax_registry()]
    assert len(registry()) == 12


@pytest.mark.parametrize("name", NAMES)
def test_registry_spec_matches_the_reference(name):
    ref = {s.name: s for s in jax_registry()}[name]
    spec = SPECS[name]
    for field in ("family", "slack", "floor", "multi_rhs", "needs_rmatvec",
                  "lagged_history"):
        assert getattr(spec, field) == getattr(ref, field), field
    assert (spec.make_trivial is None) == (ref.make_trivial is None)


@pytest.mark.parametrize("name", NAMES)
def test_problem_makers_are_seeded_and_shaped(name):
    """Same seed, same problem; another seed, another; the reference's
    shapes (least squares and QP: m = n + max(n // 2, 4); LP: m =
    max(n // 2, 2))."""
    spec = SPECS[name]
    p = problem(spec, 4, 12, 2)
    again = problem(spec, 4, 12, 2)
    other = problem(spec, 5, 12, 2)
    assert all(torch.equal(p[k], again[k]) for k in p)
    assert not torch.equal(p["a"], other["a"])
    rows = {"lstsq": 18, "qp": 18, "lp": 6}.get(spec.family, 12)
    assert tuple(p["a"].shape) == (rows, 12)
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for v in p.values())


# ------------------------------------------- 1 + 2: honesty and flag
@pytest.mark.parametrize("cond", [10.0, 200.0])
@pytest.mark.parametrize("shape", [(9, 1), (12, 2)], ids=["9x1", "12x2"])
@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("name", NAMES)
def test_contract_residual_honesty_and_flag(name, seed, shape, cond):
    """The recorded residual is the digitally recomputable one, and
    ``converged`` mirrors it."""
    spec = SPECS[name]
    n, batch = shape
    if not spec.multi_rhs:
        batch = 1
    prob = problem(spec, seed, n, batch, cond)
    res = solve(spec, prob)
    recorded = float(res.final_residual)
    rec = spec.recompute(prob, res)
    assert math.isfinite(recorded), (name, res)
    assert rec <= max(spec.slack * recorded, spec.floor), \
        f"{name}: digital recompute {rec:.3e} vs recorded {recorded:.3e}"
    if not spec.lagged_history:
        assert recorded <= max(spec.slack * rec, spec.floor), \
            f"{name}: recorded {recorded:.3e} overstates {rec:.3e}"
    tol = RUN[spec.family]["tol"]
    assert res.converged == (math.isfinite(recorded) and recorded <= tol)


# ------------------------------------------------ 3: entry honesty
@pytest.mark.parametrize(
    "name", [n for n in NAMES if SPECS[n].make_trivial is not None])
def test_contract_entry_honesty_zero_rhs(name):
    """A solve already converged at entry reports 0 iterations, converged
    and a finite entry residual, and bills the entry MVMs the reference
    bills on the same trivial instance (refinement's entry residual is
    digital: none)."""
    spec = SPECS[name]
    ref = {s.name: s for s in jax_registry()}[name]
    for batch in (1, 2) if spec.multi_rhs else (1,):
        prob = spec.make_trivial(8, batch, device="cpu")
        res = solve(spec, prob, tol=1e-6)
        assert res.iterations == 0 and res.converged, (name, batch, res)
        assert math.isfinite(res.final_residual), (name, res)
        assert res.final_residual <= 1e-6
        jprob = ref.make_trivial(8, batch)
        want = ref.solve(jprob["a"], jprob, key=jax.random.PRNGKey(0),
                         **dict(RUN[spec.family], tol=1e-6)).ledger
        led = res.ledger
        assert (led.mvms, led.mvms_single, led.mvms_t, led.mvms_single_t) \
            == (int(want.mvms), int(want.mvms_single), int(want.mvms_t),
                int(want.mvms_single_t)), (name, batch)


def _digital_solution(a, b):
    return torch.from_numpy(np.linalg.lstsq(a.double().numpy(),
                                            b.double().numpy(),
                                            rcond=None)[0].astype(np.float32))


def test_contract_entry_honesty_exact_x0():
    """The exact-``x0`` form, one solver per family that takes a warm
    start: the entry residual is under tol already, 0 iterations."""
    a = problem(SPECS["cg"], 21, 12, 1)["a"]
    b = torch.randn(12, generator=torch.Generator().manual_seed(1))
    res = tsol.cg(a, b, x0=_digital_solution(a, b), tol=1e-5, maxiter=50)
    assert res.iterations == 0 and res.converged, res

    r = problem(SPECS["lsqr"], 22, 8, 1)
    x_ls = _digital_solution(r["a"], r["b"])
    for fn in (tsol.lsqr, tsol.lsmr):
        res = fn(r["a"], r["b"], x0=x_ls, tol=1e-4, maxiter=50)
        assert res.iterations == 0 and res.converged, (fn.__name__, res)

    qp = problem(SPECS["admm"], 23, 12, 1)
    res = tsol.admm(qp["a"], qp["b"], qp["q"], lo=qp["lo"], hi=qp["hi"],
                    x0=qp["x_star"], tol=1e-4, maxiter=200)
    assert res.iterations == 0 and res.converged, res
    assert res.ledger.mvms == res.ledger.mvms_t == 1


def test_contract_entry_analog_zero_rhs():
    """Analog zero-RHS entry convergence still bills the one init MVM."""
    a = problem(SPECS["cg"], 24, 12, 1)["a"] + 2.0 * torch.eye(12)
    A = AnalogEngine(contract_config(12), device="cpu").program(a, 0)
    res = tsol.cg(A, torch.zeros(12), tol=1e-6, maxiter=50)
    assert res.iterations == 0 and res.converged, res
    assert res.ledger.mvms == 1


# ---------------------------------------------- 4: ledger arithmetic
@pytest.mark.parametrize("name", NAMES)
def test_contract_ledger_arithmetic(name):
    """On a programmed handle the total energy is exactly the write plus
    the four (MVM count x rate) products; on the digital operator the same
    counts bill zero energy."""
    spec = SPECS[name]
    prob = problem(spec, 3, 9, 1)
    A = AnalogEngine(contract_config(prob["a"].shape[0]),
                     device="cpu").program(prob["a"], 0)
    led = solve(spec, prob, a=A).ledger
    counts = (led.mvms, led.mvms_single, led.mvms_t, led.mvms_single_t)
    assert all(c >= 0 for c in counts) and sum(counts) >= 1, (name, counts)
    assert led.write_energy_j > 0
    assert led.total_energy_j == pytest.approx(
        led.write_energy_j
        + led.mvms * float(led.input_stats.energy_j)
        + led.mvms_single * float(led.input_stats_single.energy_j)
        + led.mvms_t * float(led.input_stats_t.energy_j)
        + led.mvms_single_t * float(led.input_stats_single_t.energy_j))
    if spec.needs_rmatvec:
        assert led.mvms_t + led.mvms_single_t >= 1, (name, counts)
        assert float(led.input_stats_t.energy_j) > 0
    led_d = solve(spec, prob).ledger
    assert led_d.total_energy_j == 0.0
    assert led_d.mvms + led_d.mvms_single >= 1


# ------------------------------------------------- placement parity
def _ritz_rel(a, x, theta) -> float:
    a = a.double()
    x = x.double()
    resid = torch.linalg.vector_norm(a @ x - x * theta.double()[None, :],
                                     dim=0)
    return float(torch.max(resid / theta.double().abs()))


@pytest.mark.parametrize("n,cell", [(12, 32), (48, 16)],
                         ids=["n12-one-block", "n48-blocks"])
@pytest.mark.parametrize("name", PLACED)
def test_placement_parity_local_vs_streamed(name, n, cell):
    """The same matrix programmed under the same key on a local and on a
    streamed engine (``reference`` backend, DAC on): equal iterations, the
    iterates within 1e-5 (eigenvalues 5e-5), and every eigen path's
    vectors honest against the dense matrix (digital Ritz residual <=
    5e-3, as the reference suite holds them)."""
    spec = SPECS[name]
    prob = problem(spec, 5, n, 1)
    a = prob["a"]
    m, k = a.shape
    cfg = contract_config(m, cell=cell)
    cap_m, cap_n = cfg.geom.capacity
    mb, nb = -(-m // cap_m), -(-k // cap_n)
    a_pad = torch.zeros(mb * cap_m, nb * cap_n)
    a_pad[:m, :k] = a
    blocks = a_pad.view(mb, cap_m, nb, cap_n).permute(0, 2, 1, 3)
    handles = {
        "local": AnalogEngine(cfg, device="cpu").program(a, 7),
        "streamed": AnalogEngine(cfg, execution="streamed", device="cpu")
        .program(lambda i, j: blocks[i, j], 7, shape=(m, k))}
    assert mb * nb > (1 if n == 48 else 0)
    # The reference's budget at n = 12; at n = 48 the eigen family's 32
    # steps leave LOBPCG far from its pairs (Ritz residual 0.32), so it
    # gets 4 n.
    maxiter = min(RUN[spec.family]["maxiter"], 300)
    if spec.family == "eigen":
        maxiter = max(maxiter, 4 * n)
    out = {p: solve(spec, prob, a=A, maxiter=maxiter)
           for p, A in handles.items()}
    got, want = out["streamed"], out["local"]
    assert got.iterations == want.iterations
    assert got.ledger.mvms == want.ledger.mvms
    if spec.family == "eigen":
        for res in out.values():
            assert _ritz_rel(a, res.x, res.eigenvalues) <= 5e-3
        assert rel(got.eigenvalues, want.eigenvalues) <= 5e-5
    else:
        assert rel(got.x, want.x) <= 1e-5
        if want.dual is not None:
            assert rel(got.dual, want.dual) <= 1e-5
