"""The port's analysis slice held to the JAX package: the four solver cores
(``cg_pipeline``, ``lsqr_pipeline``, ``lsmr_pipeline``, ``pdhg_pipeline``)
against the reference's jitted cores on the same deterministic operators,
and each equal to its public solver on a programmed image; the engine's
hooks (``mvm_fn``, ``group_mvm_fn``, ``chain_fn``) and
``Server.decode_fn`` against the calls they wrap; ``max_aval_elements``
on the reference registry's small streamed CG problem and on a 1 x 1
``resident=False`` distributed MVM, beside the reference's traced numbers;
``param_count`` / ``active_param_count`` / ``model_flops`` exactly the
reference's for every arch and shape; and ``chip_smoke.py``'s phase 17
rehearsed on the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads, rel, rng_array  # noqa: F401
from repro import solvers as jsol
from repro_torch import analysis
from repro_torch import solvers as tsol
from repro_torch.core import CrossbarConfig, MCAGeometry, get_device
from repro_torch.core.matrices import ImplicitBandedMatrix
from repro_torch.engine import AnalogEngine
from test_torch_solvers import (bare_ops, bare_ops_t, lp_problem,
                                lstsq_problem, spd)

REPO = Path(__file__).resolve().parents[1]
JKEY = jax.random.PRNGKey(0)


def panel(v):
    """(n,) or (n, batch) numpy -> (n, batch) float32 panel."""
    v = np.asarray(v, np.float32)
    return v[:, None] if v.ndim == 1 else v


def same(got, want) -> bool:
    """Bit for bit, NaN where NaN (the untaken history rows)."""
    try:
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    except AssertionError:
        return False
    return True


# ------------------------------------------ the cores against the reference
def core_problem(solver, batch):
    """(port core, reference core, numpy operands) on the bare operators of
    ``tests/test_torch_solvers.py``: the same deterministic matvec in both
    packages."""
    if solver == "cg":
        a, _, _ = spd(96, scale=0.6)
        b = rng_array((96, batch), 40)
        jop, top = bare_ops(a)
        kw = dict(tol=1e-6, maxiter=60)
        return (tsol.cg_pipeline(top, **kw), jsol.cg_pipeline(jop, **kw),
                (b, np.zeros_like(b)))
    if solver == "pdhg":
        a, b, c, _, _ = lp_problem(batch=batch)
        jop, top = bare_ops_t(a)
        step = 0.9 / float(np.linalg.norm(a, 2))
        kw = dict(tau=step, sigma=step, tol=1e-4, maxiter=5000)
        b, c = panel(b), panel(c)
        return (tsol.pdhg_pipeline(top, **kw), jsol.pdhg_pipeline(jop, **kw),
                (b, c, np.zeros_like(c), np.zeros_like(b)))
    a, _, b = lstsq_problem(batch=batch)
    jop, top = bare_ops_t(a)
    kw = dict(tol=1e-5, maxiter=80)
    b = panel(b)
    return (getattr(tsol, f"{solver}_pipeline")(top, **kw),
            getattr(jsol, f"{solver}_pipeline")(jop, **kw),
            (b, np.zeros((a.shape[1], b.shape[1]), np.float32)))


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("solver", ["cg", "lsqr", "lsmr", "pdhg"])
def test_core_matches_reference_jitted_core(solver, batch):
    """The port's core against ``jax.jit`` of the reference's on the same
    numpy operands: the same iterations and MVM counts, x (and PDHG's y)
    within the solver tests' tolerances (1e-5 CG, 1e-4 the others), the
    history and the entry residual with it."""
    core, jcore, args = core_problem(solver, batch)
    got = core(*[torch.from_numpy(v) for v in args], 0)
    want = jax.jit(jcore)(*[jnp.asarray(v) for v in args], JKEY)
    tol = 1e-5 if solver == "cg" else 1e-4
    if solver == "pdhg":
        x, y, hist, k, mvms, pi_mvms, rel0 = got
        jx, jy, jhist, jk, jmvms, jpi, jrel0 = want
        assert pi_mvms == int(jpi) == 0
        assert rel(y, jy) <= tol
    else:
        x, hist, k, mvms, rel0 = got
        jx, jhist, jk, jmvms, jrel0 = want
    assert isinstance(k, int) and isinstance(mvms, int)
    assert k == int(jk) > 3
    assert mvms == int(jmvms) == 1 + k
    assert rel(x, jx) <= tol
    assert rel(hist[:k], np.asarray(jhist)[:k]) <= 1e-3
    assert bool(torch.isnan(hist[k:]).all())
    assert rel(rel0, jrel0) <= 1e-5


def analog_problem(solver):
    """A programmed epiram image (EC on, 32^2 MCAs) on the CPU and numpy
    operands: an SPD system for CG, a least-squares problem for LSQR /
    LSMR, a feasible LP for PDHG."""
    if solver == "cg":
        a, _, b = spd(128, seed=42)
        geom = MCAGeometry(2, 2, 32, 32)
    elif solver == "pdhg":
        a, b, c, _, _ = lp_problem(m=40, n=72, seed=15)
        geom = MCAGeometry(2, 2, 16, 32)
        b = (b, c)
    else:
        a, _, b = lstsq_problem(m=100, n=60)
        geom = MCAGeometry(2, 2, 32, 16)
    cfg = CrossbarConfig(device=get_device("epiram"), geom=geom)
    return cfg, a, b


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("solver", ["cg", "lsqr", "lsmr", "pdhg"])
def test_core_equals_public_solver(solver, backend):
    """Each core on a programmed image is its public solver bit for bit:
    x, the history, the iterations and the MVM counts (the least-squares
    cores also from a given start point; PDHG with the power-iteration
    steps and its dual)."""
    cfg, a, b = analog_problem(solver)
    A = AnalogEngine(cfg, backend=backend, device="cpu").program(a, 5)
    op = tsol.as_operator(A)
    if solver == "cg":
        res = tsol.cg(A, b, tol=1e-3, maxiter=50, key=3, backend=backend)
        x, hist, k, mvms, rel0 = tsol.cg_pipeline(
            op, tol=1e-3, maxiter=50, backend=backend)(
            torch.from_numpy(panel(b)), torch.zeros(len(b), 1), 3)
        assert k >= 3
    elif solver == "pdhg":
        b, c = b
        res = tsol.pdhg(A, b, c, tol=1e-3, maxiter=3000, key=3,
                        power_iters=8)
        x, y, hist, k, mvms, pi_mvms, rel0 = tsol.pdhg_pipeline(
            op, tol=1e-3, maxiter=3000, power_iters=8)(
            torch.from_numpy(panel(b)), torch.from_numpy(panel(c)),
            torch.zeros(len(c), 1), torch.zeros(len(b), 1), 3)
        assert same(y[:, 0], res.dual)
        assert pi_mvms == res.ledger.mvms_single == 8
        assert k > 3
    else:
        x0 = np.full(a.shape[1], 0.1, np.float32)
        for start in (None, x0):
            res = getattr(tsol, solver)(A, b, tol=1e-3, maxiter=80, key=3,
                                        x0=start)
            x, hist, k, mvms, rel0 = getattr(tsol, f"{solver}_pipeline")(
                op, tol=1e-3, maxiter=80, explicit_x0=start is not None)(
                torch.from_numpy(panel(b)),
                torch.from_numpy(panel(x0 if start is not None
                                       else np.zeros_like(x0))), 3)
            assert same(x[:, 0], res.x) and k == res.iterations > 3
            assert res.ledger.mvms_t == mvms + (start is not None)
    assert same(x[:, 0], res.x) and same(hist[:, 0], res.residuals)
    assert k == res.iterations and mvms == res.ledger.mvms == 1 + k
    assert float(rel0.max()) == res.initial_residual


def test_solvers_export_the_reference_names():
    assert set(tsol.__all__) == set(jsol.__all__)
    for name in ("cg_pipeline", "pdhg_pipeline", "lsqr_pipeline",
                 "lsmr_pipeline"):
        assert callable(getattr(tsol, name))


# --------------------------------------------------------------- the hooks
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_engine_hooks_equal_their_calls(backend):
    """``mvm_fn`` (both ways), ``group_mvm_fn`` (both ways) and ``chain_fn``
    are the calls they close over, bit for bit under the same key."""
    cfg = CrossbarConfig(device=get_device("taox-hfox"),
                         geom=MCAGeometry(2, 2, 32, 32))
    eng = AnalogEngine(cfg, backend=backend, device="cpu")
    A = eng.program(rng_array((100, 90), 70) / 10, 1)
    x, y = torch.from_numpy(rng_array((90, 2), 71)), \
        torch.from_numpy(rng_array((100, 2), 72))
    assert torch.equal(eng.mvm_fn(A)(x, 9), eng.mvm(A, x, key=9))
    assert torch.equal(eng.mvm_fn(A, transpose=True)(y, 9),
                       eng.rmvm(A, y, key=9))
    G = eng.program_group(rng_array((3, 100, 90), 73) / 10, 2)
    assert torch.equal(eng.group_mvm_fn(G)(x, 4), eng.group_mvm(G, x, key=4))
    assert torch.equal(eng.group_mvm_fn(G, transpose=True)(y, 4),
                       eng.group_rmvm(G, y, key=4))
    C = eng.program_group(rng_array((4, 64, 64), 74) / 8, 3)
    h = torch.from_numpy(rng_array((64,), 75))
    assert torch.equal(eng.chain_fn(C, activation="relu")(h, 6),
                       eng.chain_mvm(C, h, key=6, activation="relu"))
    assert torch.equal(eng.chain_fn(C)(h, 6), eng.chain_mvm(C, h, key=6))


def test_decode_fn_equals_decode_tokens():
    """``Server.decode_fn(n)`` on reduced qwen3-1.7b (programmed, DAC on)
    after a prefill gives ``decode_tokens``' tokens after a second, fresh
    prefill (the caches are written in place, so the two share none)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as ptf
    from repro_torch.models.common import Runtime
    from repro_torch.train.serve import Server
    cfg = get_arch("qwen3-1.7b").reduced()
    params = PM.materialize(ptf.init_specs(cfg), 0, device="cpu")
    rram = RRAMBackendConfig(enabled=True, cell_rows=32, cell_cols=32)
    srv = Server(ptf, cfg, params, rt=Runtime(rram=rram, key=9), max_len=12)
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab, (2, 6)))}
    tok, caches = srv.prefill(batch)
    got, _ = srv.decode_fn(4)(tok, caches)
    tok2, caches2 = srv.prefill(batch)
    want, _ = srv.decode_tokens(tok2, caches2, 4)
    assert torch.equal(tok, tok2)
    assert got.shape == (2, 4) and got.dtype == torch.int32
    assert torch.equal(got, want)


# ------------------------------------------------------------------ memory
def test_max_aval_elements_counts_ops_arguments_and_result():
    """An intermediate, an argument and a result each set the count; a
    view counts at its own size, the operator that takes it at the base's."""
    x = torch.ones(10)
    assert analysis.max_aval_elements(lambda v: (v.repeat(4) * 2).sum(),
                                      x) == 40
    assert analysis.max_aval_elements(lambda v: v[:3] + 1, x) == 10
    assert analysis.max_aval_elements(lambda: torch.zeros(7)) == 7
    assert analysis.max_aval_elements(lambda v, n: v.sum(), x, n=3) == 10


def test_peak_bytes_refuses_a_cpu_call():
    with pytest.raises(ValueError, match="CUDA"):
        analysis.peak_bytes(lambda v: v * 2, torch.ones(4))
    with pytest.raises(ValueError, match="CUDA"):
        analysis.peak_bytes(lambda: torch.ones(4))


def _small_cfg():
    """The reference registry's ``_small_cfg``: taox-hfox, 2 x 2 MCAs of
    32^2 (capacity 64^2), k = 5, EC on."""
    return CrossbarConfig(device=get_device("taox-hfox"),
                          geom=MCAGeometry(2, 2, 32, 32), k_iters=5, ec=True)


def test_max_aval_elements_streamed_cg_within_the_image():
    """The registry's small streamed CG problem (n = 256, the 4 x 4 grid of
    its banded producer, tol 1e-5, maxiter 50): the port's largest tensor
    of one run beside the reference's largest traced aval, both within the
    resident image (n^2 elements), the reference's bound for a handle that
    holds one."""
    from repro.analysis import max_aval_elements as jmax
    from repro.analysis import pipelines as jpipe
    built = jpipe._build_cg()
    want = jmax(built.fn, *built.args)
    n, cap = 256, 64
    imp = ImplicitBandedMatrix(n=n, cap_m=cap, cap_n=cap, seed=2,
                               device="cpu")
    eng = AnalogEngine(_small_cfg(), execution="streamed", device="cpu")
    A = eng.program(imp.block, 7, shape=(n, n))
    core = tsol.cg_pipeline(tsol.as_operator(A), tol=1e-5, maxiter=50)
    b = torch.from_numpy(rng_array((n, 1), 80))
    got = analysis.max_aval_elements(core, b, torch.zeros(n, 1), 7)
    print(f"streamed CG n={n}: port {got}, reference {want} elements; "
          f"image {A.at_stack.numel()}")
    assert got <= A.at_stack.numel() == n * n
    assert want <= n * n


def test_max_aval_elements_resident_false_far_below_a():
    """A 1 x 1 ``resident=False`` distributed MVM of a 512^2 banded
    producer (an 8 x 8 grid of 64^2 capacity blocks), both ways: the
    reference's bound (< n^2 / 8, tests/test_distributed.py) and at most
    4 capacity blocks, beside the reference's traced number."""
    from repro.analysis import max_aval_elements as jmax
    from repro.analysis import pipelines as jpipe
    from repro.engine import AnalogEngine as JEngine
    from repro_torch.launch import make_mesh
    n, cap = 512, 64
    jeng = JEngine(jpipe._small_cfg(), execution="distributed",
                   mesh=jpipe._mesh((1, 1)))
    jA = jeng.program(jpipe._banded(n, cap).block, jpipe._key(),
                      shape=(n, n), resident=False)
    imp = ImplicitBandedMatrix(n=n, cap_m=cap, cap_n=cap, seed=2,
                               device="cpu")
    eng = AnalogEngine(_small_cfg(), execution="distributed",
                       mesh=make_mesh((1, 1), ("data", "model"),
                                      device="cpu"))
    A = eng.program(imp.block, 7, shape=(n, n), resident=False)
    v = torch.from_numpy(rng_array((n,), 81))
    for transpose in (False, True):
        want = jmax(jeng.mvm_fn(jA, transpose=transpose), jpipe._vec(n),
                    jpipe._key_spec())
        got = analysis.max_aval_elements(eng.mvm_fn(A, transpose=transpose),
                                         v, 7)
        print(f"resident=False {n}^2, transpose={transpose}: port {got}, "
              f"reference {want} elements; n^2/8 = {n * n // 8}, a "
              f"capacity block {cap * cap}")
        assert got < n * n // 8 and want < n * n // 8
        assert got <= 4 * cap * cap


# ------------------------------------------------------------- model FLOPs
def _archs():
    from repro_torch.configs.registry import ARCHS
    return ARCHS


def _shapes():
    from repro_torch.configs.base import SHAPES
    return list(SHAPES)


@pytest.mark.parametrize("shape", _shapes())
@pytest.mark.parametrize("arch", _archs())
def test_model_flops_equal_the_reference(arch, shape):
    """``param_count``, ``active_param_count`` and ``model_flops`` are the
    reference's exactly, over shapes alone (nothing allocated)."""
    from repro.analysis import model_flops as jmf
    from repro.configs.registry import get_arch as jget_arch
    from repro_torch.analysis import model_flops as tmf
    from repro_torch.configs.registry import get_arch
    ja, ta = jget_arch(arch), get_arch(arch)
    assert tmf.param_count(ta) == int(jmf.param_count(ja))
    assert tmf.active_param_count(ta) == int(jmf.active_param_count(ja))
    got, want = tmf.model_flops(ta, shape), jmf.model_flops(ja, shape)
    assert got == want
    assert [type(v) for v in got.values()] == \
        [type(v) for v in want.values()]


def test_model_flops_of_meliso_raises_in_both():
    from repro.analysis import model_flops as jmf
    from repro.configs.registry import get_arch as jget_arch
    from repro_torch.analysis import model_flops as tmf
    from repro_torch.configs.registry import get_arch
    with pytest.raises(KeyError):
        jmf.param_count(jget_arch("meliso-mvm"))
    with pytest.raises(KeyError):
        tmf.param_count(get_arch("meliso-mvm"))


# ------------------------------------------------- chip_smoke.py's [17]
def test_chip_smoke_analysis_phase_rehearses_on_cpu():
    """chip_smoke.py's phase 17 is a function with size arguments: on a
    512^2 virtual operator of 64^2 capacity blocks on the CPU
    (``lm_probe.py rehearse-analysis``: synchronise stubbed, the kernel
    wrappers counting their launches, the allocator peak not measured)
    every check passes: max elements within n^2/8 and 4 blocks, 64
    producer calls and 64 EC launches an MVM, the stencils a segment, the
    cores' iterates finite, on the 1 x 1 and the 2 x 4 mesh."""
    out = subprocess.run(
        [sys.executable, str(REPO / "lm_probe.py"), "rehearse-analysis"],
        text=True, capture_output=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1].startswith("rehearsal of [17]")
    assert any(ln.startswith("[17a] A @ x") for ln in lines)
    assert any(ln.startswith("[17b] lsqr") for ln in lines)


# ------------------------------------------------- chip_smoke.py's [18]
def test_chip_smoke_invariants_phase_rehearses_on_cpu():
    """chip_smoke.py's phase 18 takes its device and runs the registry at
    that device's scale: on the CPU (``lm_probe.py rehearse-invariants``,
    ``scale="cpu"``: the kernel wrappers counting their launches)
    each of the 29 records is printed, shows no violation and equals
    INVARIANTS_torch.json's ``cpu`` section; the counted launches are the
    small entries' the card's section holds (49 ``ec_matmul``, 169
    ``ec_rmatmul``, one of each grouped kernel, 158 stencils)."""
    out = subprocess.run(
        [sys.executable, str(REPO / "lm_probe.py"), "rehearse-invariants"],
        text=True, capture_output=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert sum(ln.startswith("[18] {") for ln in lines) == 29
    assert lines[-1].startswith("rehearsal of [18]")
    assert lines[-1].endswith(
        "{'ec_matmul': 49, 'ec_rmatmul': 169, 'ec_group_matmul': 1, "
        "'ec_group_rmatmul': 1, 'stencil_denoise': 158}")
