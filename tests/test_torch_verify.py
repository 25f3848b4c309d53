"""The port's invariant audits (``repro_torch.analysis.verify``), each pass
on a seeded violation and on its clean twin, mirroring the classes of
``tests/test_verify.py``: a dense A materialised over the budget, a
producer called twice a block, one key drawn at two sites against
``fold_in``-split keys, a baked key (flagged, then waived), a bfloat16
in-place accumulator against float32, a float64 leak, a psum over an
undeclared axis and a join with no budget.  Also: the hooks leave every
result bit for bit (a local, a streamed and a 2 x 4 distributed MVM, with
and without an observer), and an idle hook holds no observer."""
import re

import pytest
import torch

from _torch_port import few_threads, rng_array  # noqa: F401
from repro_torch import kernels
from repro_torch.analysis import max_aval_elements
from repro_torch.analysis import verify as V
from repro_torch.core import CrossbarConfig, MCAGeometry, get_device, prng
from repro_torch.core.matrices import ImplicitBandedMatrix
from repro_torch.core.prng import fold_in, generator
from repro_torch.engine import AnalogEngine
from repro_torch.launch import gather_to_lead, make_mesh, psum
from repro_torch.launch import mesh as mesh_mod
from repro_torch.solvers import as_operator

KEY = 7
N, CAP = 512, 64          # the registry's CPU-scale virtual operator


def small_cfg():
    return CrossbarConfig(device=get_device("taox-hfox"),
                          geom=MCAGeometry(2, 2, 32, 32), k_iters=5, ec=True)


def vec(n, seed=1):
    return torch.from_numpy(rng_array((n,), seed))


def virtual_handle(shape=(1, 1)):
    """A ``resident=False`` 512^2 banded producer on 64 blocks of 64^2."""
    imp = ImplicitBandedMatrix(n=N, cap_m=CAP, cap_n=CAP, seed=2,
                               device="cpu")
    counter = V.CallCounter(imp.block)
    eng = AnalogEngine(small_cfg(), execution="distributed",
                       mesh=make_mesh(shape, ("data", "model"),
                                      device="cpu"))
    return eng, eng.program(counter, KEY, shape=(N, N), resident=False), \
        counter


def streamed_handle(block_fn=None):
    n = 4 * CAP
    imp = ImplicitBandedMatrix(n=n, cap_m=CAP, cap_n=CAP, seed=2,
                               device="cpu")
    eng = AnalogEngine(small_cfg(), execution="streamed", device="cpu")
    return eng, eng.program(block_fn or imp.block, KEY, shape=(n, n)), imp


def _materializing_mvm(x):
    """The known-bad memory pipeline: forms the rank-1 'matrix'."""
    big = x[:, None] * x[None, :]
    return big @ x


# ----------------------------------------------------------- AvalBound
class TestAvalBound:
    def test_flags_dense_materialisation(self):
        """``op.dense()`` of the virtual operator holds all of A (the
        producer's 8 x 8 block stack): over a four-block budget, named by
        the tensor and the port's line that made it."""
        _, A, _ = virtual_handle()
        op = as_operator(A)
        report = V.aval_bound(lambda v, key: op.dense() @ v[:, None],
                              vec(N), KEY, budget=4 * CAP * CAP)
        assert not report.ok
        assert report.summary["max_elements"] == N * N
        assert report.summary["max_aval"] == "float32[8,8,64,64]"
        assert re.search(r"largest tensor float32\[8,8,64,64\] has 262144 "
                         r"elements > budget 16384 \[aten\.empty\S* @ "
                         r"crossbar\.py:\d+ \(in produce_blocks\)\]",
                         str(report.violations[0])), report.violations[0]

    def test_clean_mvm_under_budget(self):
        """The operator's own MVM holds one capacity block."""
        _, A, _ = virtual_handle()
        report = V.aval_bound(as_operator(A).matvec, vec(N)[:, None], KEY,
                              budget=4 * CAP * CAP)
        assert report.ok
        assert report.summary["max_elements"] == CAP * CAP

    def test_attribution_names_operator_and_line(self):
        msg = str(V.aval_bound(_materializing_mvm, torch.ones(512),
                               budget=1024).violations[0])
        assert re.search(
            r"AvalBound: largest tensor float32\[512,512\] has 262144 "
            r"elements > budget 1024 \[aten\.mul\.Tensor @ "
            r"test_torch_verify\.py:\d+ \(in _materializing_mvm\)\]",
            msg), msg

    def test_max_elements_is_max_aval_elements(self):
        """The pass runs ``memory.max_aval_elements``' census: the same
        number on the same call, intermediates, arguments and results; an
        argument no operator touches counts, named as the call's own."""
        x = torch.ones(10)
        _, A, _ = virtual_handle()
        for fn, args in ((lambda v: (v.repeat(4) * 2).sum(), (x,)),
                         (lambda v: v[:3] + 1, (x,)),
                         (lambda: torch.zeros(7), ()),
                         (as_operator(A).matvec, (vec(N)[:, None], KEY))):
            assert V.aval_bound(fn, *args).summary["max_elements"] == \
                max_aval_elements(fn, *args)
        untouched = (lambda v, big: v + 1, (x, torch.zeros(100)))
        assert max_aval_elements(untouched[0], *untouched[1]) == 100
        report = V.aval_bound(untouched[0], *untouched[1], budget=99)
        assert report.summary["max_elements"] == 100
        assert report.summary["at"] == "<arguments and result>"
        assert "budget 99 [<arguments and result>]" in \
            str(report.violations[0])

    def test_assert_ok_raises_with_sites(self):
        with pytest.raises(AssertionError, match="AvalBound failed"):
            V.aval_bound(_materializing_mvm, torch.ones(512),
                         budget=1024).assert_ok()


# ----------------------------------------------------------- DispatchCount
class TestDispatchCount:
    def test_flags_producer_called_twice_a_block(self):
        """A block_fn that runs the producer twice a block: 32 calls for
        one MVM over 16 blocks."""
        imp = ImplicitBandedMatrix(n=4 * CAP, cap_m=CAP, cap_n=CAP, seed=2,
                                   device="cpu")
        counter = V.CallCounter(imp.block)
        eng, A, _ = streamed_handle(
            lambda i, j: counter(i, j) + 0 * counter(i, j))
        report = V.dispatch_count(eng.mvm_fn(A), vec(4 * CAP), KEY,
                                  producer=counter, producer_per_mvm=16,
                                  mvms=lambda: A.calls)
        assert not report.ok
        assert report.summary["producer_calls"] == 32
        assert "producer invoked 32x > budget 16" in \
            str(report.violations[0])

    def test_once_a_block_clean(self):
        """The streamed MVM produces each block once; the solve's MVMs
        each once more (CG, 3 iterations: 4 MVMs, 64 calls)."""
        imp = ImplicitBandedMatrix(n=4 * CAP, cap_m=CAP, cap_n=CAP, seed=2,
                                   device="cpu")
        counter = V.CallCounter(imp.block)
        eng, A, _ = streamed_handle(counter)
        report = V.dispatch_count(eng.mvm_fn(A), vec(4 * CAP), KEY,
                                  producer=counter, producer_per_mvm=16,
                                  mvms=lambda: A.calls)
        assert report.ok
        assert report.summary["producer_calls"] == 16
        assert report.summary["mvms"] == 1
        from repro_torch.solvers import cg_pipeline
        core = cg_pipeline(as_operator(A), tol=1e-12, maxiter=3)
        report = V.dispatch_count(core, vec(4 * CAP)[:, None],
                                  torch.zeros(4 * CAP, 1), KEY,
                                  producer=counter, producer_per_mvm=16,
                                  mvms=lambda: A.calls)
        assert report.ok
        assert (report.summary["mvms"], report.summary["producer_calls"]) \
            == (4, 64)

    def test_resident_false_programs_nothing(self):
        """``resident=False``: no producer call at programming, one a
        block an MVM."""
        eng, A, counter = virtual_handle()
        assert counter.calls == 0
        report = V.dispatch_count(eng.mvm_fn(A, transpose=True), vec(N),
                                  KEY, producer=counter,
                                  producer_per_mvm=64,
                                  mvms=lambda: A.calls)
        assert report.ok and report.summary["producer_calls"] == 64

    def test_launch_budget(self, monkeypatch):
        """Launches are the change of ``kernels.LAUNCHES`` over the call
        (never reset); over ``max_launches`` is a violation."""
        monkeypatch.setitem(kernels.LAUNCHES, "ec_matmul",
                            kernels.LAUNCHES["ec_matmul"] + 5)

        def launches_three():
            kernels.LAUNCHES["ec_matmul"] += 3

        report = V.dispatch_count(launches_three, max_launches=2)
        assert report.summary["launches"] == {"ec_matmul": 3}
        assert "3 kernel launches {'ec_matmul': 3} > budget 2" in \
            str(report.violations[0])
        assert V.dispatch_count(launches_three, max_launches=3).ok


# ----------------------------------------------------------- KeyReuse
def _two_sites(x, key):
    a = torch.randn(4, generator=generator(key, "cpu"))
    b = torch.randn(4, generator=generator(key, "cpu"))
    return a + b + x


class TestKeyReuse:
    def test_flags_one_key_at_two_sites(self):
        report = V.key_reuse(_two_sites, torch.ones(4), KEY)
        assert not report.ok
        assert report.summary["consumptions"] == 2
        assert report.summary["distinct_keys"] == 1
        assert re.search(
            r"KeyReuse: one key consumed at 2 distinct sites \(sites: "
            r"generator @ test_torch_verify\.py:\d+ \(in _two_sites\), "
            r"generator @ test_torch_verify\.py:\d+ \(in _two_sites\)\)",
            str(report.violations[0])), report.violations[0]

    def test_split_keys_clean(self):
        def good(x, key):
            a = torch.randn(4, generator=generator(fold_in(key, 0), "cpu"))
            b = torch.randn(4, generator=generator(fold_in(key, 1), "cpu"))
            return a + b + x

        report = V.key_reuse(good, torch.ones(4), KEY)
        assert report.ok
        assert report.summary["distinct_keys"] == 2
        assert report.summary["baked"] == 0

    def test_same_site_again_is_a_repeat(self):
        """One key at one site three times (a layer loop that resets its
        salt): counted as repeats, not flagged."""
        def loop(x, key):
            for _ in range(3):
                x = x + torch.randn(4, generator=generator(key, "cpu"))
            return x

        report = V.key_reuse(loop, torch.ones(4), KEY)
        assert report.ok
        assert (report.summary["consumptions"], report.summary["repeats"]) \
            == (3, 2)

    def test_engine_sites_seen_through_the_helpers(self):
        """Two executes under one key draw at the engine's one site: on the
        reference backend ``crossbar.py``'s block loop (4 blocks), on the
        cuda backend ``engine.py``'s whole-vector pass -- repeats, no
        violation.  The same key drawn here too is two sites, and the
        violation names the engine's line."""
        x = vec(90)
        a = torch.from_numpy(rng_array((100, 90), 3, 0.1))
        for backend, per_call in (("reference", 4), ("cuda", 1)):
            eng = AnalogEngine(small_cfg(), backend=backend, device="cpu")
            A = eng.program(a, KEY)
            report = V.key_reuse(
                lambda v, key: eng.mvm(A, v, key=key) + eng.mvm(A, v,
                                                                key=key),
                x, KEY)
            assert report.ok, report.violations
            assert (report.summary["consumptions"],
                    report.summary["repeats"]) == (2 * per_call, per_call)
        eng = AnalogEngine(small_cfg(), backend="cuda", device="cpu")
        A = eng.program(a, KEY)

        def clash(v, key):
            torch.randn(4, generator=generator(fold_in(key, 1), "cpu"))
            return eng.mvm(A, v, key=key)

        report = V.key_reuse(clash, x, KEY)
        assert not report.ok
        msg = str(report.violations[0])
        assert "engine.py" in msg and "(in _dac_pass)" in msg, msg
        assert "test_torch_verify.py" in msg, msg

    def test_flags_baked_key(self):
        def baked(x, key):
            return torch.randn(4, generator=generator(0, "cpu")) + x

        report = V.key_reuse(baked, torch.ones(4), KEY)
        assert not report.ok
        assert report.summary["baked"] == 1
        assert "not derived from the call's key argument" in \
            str(report.violations[0])
        # procedural matrix content waives the baked check, not the reuse one
        assert V.key_reuse(baked, torch.ones(4), KEY, allow_baked=True).ok
        assert not V.key_reuse(_two_sites, torch.ones(4), KEY,
                               allow_baked=True).ok

    def test_call_without_key_argument_is_baked(self):
        def keyless(x):
            return torch.randn(4, generator=generator(3, "cpu")) + x

        assert not V.key_reuse(keyless, torch.ones(4), key_arg=None).ok
        assert V.key_reuse(keyless, torch.ones(4), key_arg=None,
                           allow_baked=True).ok


# ----------------------------------------------------------- PrecisionLint
def _bf16_accumulator(xs):
    acc = torch.zeros(4, dtype=torch.bfloat16)
    for x in xs:
        acc.add_(x.to(torch.bfloat16))
    return acc


class TestPrecisionLint:
    def test_flags_bf16_accumulator(self):
        report = V.precision_lint(_bf16_accumulator, torch.ones(5, 4))
        assert not report.ok
        assert report.summary["sub_f32_accumulators"] == 1
        assert re.search(
            r"PrecisionLint: bfloat16 tensor bfloat16\[4\] written in place "
            r"more than once \(sub-f32 accumulator\) \[aten\.add_\.Tensor @ "
            r"test_torch_verify\.py:\d+ \(in _bf16_accumulator\)\]",
            str(report.violations[0])), report.violations[0]

    def test_f32_accumulator_clean(self):
        def acc(xs):
            out = torch.zeros(4)
            for x in xs:
                out.add_(x)
            return out

        assert V.precision_lint(acc, torch.ones(5, 4)).ok
        # one in-place write of a bf16 tensor is not an accumulator
        assert V.precision_lint(
            lambda x: torch.zeros(4, dtype=torch.bfloat16).add_(x),
            torch.ones(4)).ok

    def test_flags_f64_leak(self):
        def leak(x):
            return x.double().sum() * 2.0

        report = V.precision_lint(leak, torch.ones(4))
        assert not report.ok
        assert report.summary["f64_tensors"] > 0
        assert "silent f64 leak" in str(report.violations[0])
        assert V.precision_lint(leak, torch.ones(4), allow_f64=True).ok

    def test_flags_sub_f32_psum_operand(self):
        mesh = make_mesh((1, 2), ("data", "model"), device="cpu")

        def reduce(x):
            return psum(mesh, [x, x], "model")[0]

        report = V.precision_lint(reduce, torch.ones(4, dtype=torch.float16))
        assert not report.ok
        assert "float16 psum operand" in str(report.violations[0])
        assert V.precision_lint(reduce, torch.ones(4)).ok


# ----------------------------------------------------------- CollectiveAudit
MESH = make_mesh((2, 2), ("data", "model"), device="cpu")


def _psum_over(axis):
    def body(x):
        return psum(MESH, [x] * MESH.size, axis)[0]
    return body


class TestCollectiveAudit:
    def test_flags_undeclared_psum_axis(self):
        report = V.collective_audit(_psum_over("data"), torch.ones(4),
                                    allowed_axes=("model",))
        assert not report.ok
        assert "psum over undeclared axes ['data']" in \
            str(report.violations[0])
        assert "test_torch_verify.py" in str(report.violations[0].site)

    def test_declared_psum_clean(self):
        report = V.collective_audit(_psum_over("model"), torch.ones(4),
                                    allowed_axes=("data", "model"))
        assert report.ok
        assert report.summary["psums"] == 1
        assert report.summary["axes"] == ["model"]

    def test_flags_join_without_budget(self):
        def join(x):
            return gather_to_lead(MESH, [x, x])

        report = V.collective_audit(join, torch.ones(4))
        assert not report.ok and report.summary["gathers"] == 1
        assert "gather_to_lead with no declared budget" in \
            str(report.violations[0])
        over = V.collective_audit(join, torch.ones(4), per_device_budget=7)
        assert "gather_to_lead moves 8 elements > per-device budget 7" in \
            str(over.violations[0])
        assert V.collective_audit(join, torch.ones(4),
                                  per_device_budget=8).ok

    def test_distributed_mvm_reduces_over_its_axes(self):
        """A 2 x 4 virtual MVM: one psum (over the contraction axis), one
        join of the 512 outputs, within the engine's declared axes."""
        eng, A, _ = virtual_handle((2, 4))
        for transpose, axis in ((False, "model"), (True, "data")):
            report = V.collective_audit(
                eng.mvm_fn(A, transpose=transpose), vec(N), KEY,
                allowed_axes=eng.collective_axes, per_device_budget=N)
            assert report.ok, report.violations
            assert (report.summary["psums"], report.summary["gathers"],
                    report.summary["axes"]) == (1, 1, [axis])


# ----------------------------------------------------------- run_all, hooks
def test_run_all_runs_the_call_once_plus_the_folded_run():
    calls = []

    def fn(x, key):
        calls.append(key)
        return x + torch.randn(4, generator=generator(key, "cpu"))

    reports = V.run_all(fn, torch.ones(4), KEY, allow_baked=True)
    assert calls == [KEY]
    assert sorted(reports) == ["AvalBound", "CollectiveAudit",
                               "DispatchCount", "KeyReuse", "PrecisionLint"]
    assert all(r.ok for r in reports.values())
    calls.clear()
    reports = V.run_all(fn, torch.ones(4), KEY)
    assert calls == [KEY, fold_in(KEY, 1)]
    assert reports["KeyReuse"].summary["baked"] == 0


@pytest.mark.parametrize("case", ["local", "streamed", "distributed-2x4"])
def test_hooks_leave_results_bit_for_bit(case):
    """The same call with and without the observers (all five audits on):
    equal bit for bit."""
    if case == "local":
        eng = AnalogEngine(small_cfg(), device="cpu")
        A = eng.program(torch.from_numpy(rng_array((100, 90), 3, 0.1)), KEY)
        fn, x = eng.mvm_fn(A), vec(90)
    elif case == "streamed":
        eng, A, _ = streamed_handle()
        fn, x = eng.mvm_fn(A, transpose=True), vec(4 * CAP)
    else:
        eng, A, _ = virtual_handle((2, 4))
        fn, x = eng.mvm_fn(A), vec(N)
    plain = fn(x, KEY)
    outs = []
    V.run_all(lambda v, key: outs.append(fn(v, key)) or outs[-1], x, KEY,
              allowed_axes=eng.collective_axes or None,
              per_device_budget=N)
    assert torch.equal(outs[0], plain)
    assert torch.equal(outs[1], fn(x, fold_in(KEY, 1)))


def test_idle_hooks_hold_no_observer():
    """No observer outside an audit, none left after one, nor after a call
    that raises inside one."""
    assert prng.OBSERVERS == [] and mesh_mod.OBSERVERS == []
    V.run_all(_psum_over("model"), torch.ones(4), key_arg=None)
    assert prng.OBSERVERS == [] and mesh_mod.OBSERVERS == []

    def boom(x):
        generator(1, "cpu")
        raise RuntimeError("inside the audited call")

    with pytest.raises(RuntimeError, match="inside the audited call"):
        V.run_all(boom, torch.ones(4), key_arg=None)
    assert prng.OBSERVERS == [] and mesh_mod.OBSERVERS == []
