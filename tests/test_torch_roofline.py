"""The port's cost model and roofline held to the JAX package's:
``analysis.cost.measure_cost`` against ``repro.analysis.hlo_cost`` on the
framework tests' two programs, ``analysis.wire.collective_wire`` against
``repro.analysis.hlo_parse`` for the five collectives, ``roofline_terms`` /
``format_row`` against the reference's over the same rates, a port record
rendered by the reference's report tables; and the declared cost of each
kernel function (``kernels.cost``), counted once a call, whichever
implementation ran it, and the wire bytes of a 2 x 4 mesh MVM."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import few_threads  # noqa: F401
from _torch_roofline import KERNEL_NAMES, kernel_calls
from repro.analysis import hlo_cost, hlo_parse
from repro.analysis import report as jreport
from repro.analysis import roofline as jroofline
from repro_torch import kernels
from repro_torch.analysis import (HW, analyze_run, collective_wire,
                                  collective_wire_bytes, count_op,
                                  format_row, measure_cost, roofline,
                                  roofline_terms)
from repro_torch.core import CrossbarConfig, MCAGeometry, get_device
from repro_torch.engine import AnalogEngine
from repro_torch.kernels import cost as kernel_cost
from repro_torch.launch import make_mesh
from repro_torch.launch import mesh as mesh_mod


def _jax_scan(x):
    def body(c, _):
        return c @ c, None
    return jax.lax.scan(body, x, None, length=7)[0]


def _torch_scan(c):
    for _ in range(7):
        c = c @ c
    return c


PROGRAMS = {
    # name: (jax function, torch function, argument shapes)
    "relu": (lambda x, w: jax.nn.relu(x @ w) @ w.T,
             lambda x, w: torch.relu(x @ w) @ w.T, ((64, 64), (64, 64))),
    "scan": (_jax_scan, _torch_scan, ((128, 128),)),
}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_measure_cost_against_reference_programs(name):
    """tests/test_framework.py's two programs: the relu program's flops
    and bytes equal to ``analyze_hlo_text``'s (1,052,672 / 131,072); the
    7-step scan's flops within 1e-6 and bytes within 1e-3 of it (the
    reference adds the loop counter's); each run's records sum to its
    totals."""
    jfn, tfn, shapes = PROGRAMS[name]
    comp = jax.jit(jfn).lower(*[jax.ShapeDtypeStruct(s, jnp.float32)
                                for s in shapes]).compile()
    want = hlo_cost.analyze_hlo_text(comp.as_text())
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes]
    rec = []
    got = measure_cost(tfn, *args, record=rec)
    if name == "relu":
        assert (got.flops, got.bytes) == (want.flops, want.bytes) \
            == (1_052_672, 131_072)
    else:
        assert got.flops == 2 * 7 * 128 ** 3
        assert abs(got.flops - want.flops) <= 1e-6 * want.flops
        assert abs(got.bytes - want.bytes) <= 1e-3 * want.bytes
    assert sum(r[0] for r in rec) == got.bytes
    assert sum(r[1] for r in rec) == got.flops
    assert got.wire == 0 and got.wire_by_op == {}


COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("op", COLLECTIVES)
def test_collective_wire_matches_parse_collectives(op, g):
    """The ring model on an f32[1024] output over groups of g, equal to
    what ``parse_collectives`` reads off the same HLO line."""
    line = (f"  %c = f32[1024]{{0}} {op}(f32[1024]{{0}} %p), "
            f"replica_groups=[{8 // g},{g}]<=[8], to_apply=%add")
    (want,) = hlo_parse.parse_collectives(line)
    assert want["group"] == g and want["bytes"] == 4096
    assert collective_wire(op, 4096, g) == want["wire"]
    if g == 4:
        assert want["wire"] == {"all-reduce": 6144, "all-gather": 3072,
                                "reduce-scatter": 12288, "all-to-all": 3072,
                                "collective-permute": 4096}[op]


def _port_hw_in_reference(monkeypatch):
    monkeypatch.setattr(jroofline, "HW", {
        "peak_flops": HW["peak_flops"], "hbm_bw": HW["hbm_bw"],
        "ici_bw": HW["nvlink_bw"], "hbm_bytes": HW["hbm_bytes"]})


@pytest.mark.parametrize("flops,nbytes,wire", [
    (4.3e9, 8.59e9, 0.0), (3.4e13, 1.2e9, 0.0), (1e6, 1e6, 6.4e9),
    (0.0, 0.0, 0.0)])
def test_roofline_terms_and_row_match_reference(monkeypatch, flops, nbytes,
                                                wire):
    """``roofline_terms`` and ``format_row`` equal the reference's with its
    ``HW`` set to the card's rates (its ICI link to one NVLink
    direction)."""
    _port_hw_in_reference(monkeypatch)
    got = roofline_terms(flops, nbytes, wire)
    assert got == jroofline.roofline_terms(flops, nbytes, wire)
    r = {**got, "useful_ratio": 0.5, "roofline_fraction": 0.25,
         "memory": {"peak_bytes": 3 * 2 ** 30}}
    assert format_row("cell", r) == jroofline.format_row("cell", r)


@pytest.mark.parametrize("flops,nbytes,want_by", [
    (4 * 32768 ** 2, 8 * 32768 ** 2 + 12 * 32768, "bytes"),
    (2 * 1024 * 6144 * 2048, 4 * (1024 * 6144 + 6144 * 2048), "operations"),
    (0, 0, "bytes")])
def test_bound_ms_is_the_dominant_roofline_term(flops, nbytes, want_by):
    """A kernel function's bound is the larger of the roofline's memory
    and compute times, in ms, and says which (bytes on a tie)."""
    t = roofline_terms(flops, nbytes, 0.0)
    ms, by = roofline.bound_ms(flops, nbytes)
    assert by == want_by
    assert ms == max(t["memory_s"], t["compute_s"]) * 1e3
    assert ms == max(nbytes / HW["hbm_bw"], flops / HW["peak_flops"]) * 1e3


def test_hw_holds_no_tpu_figure():
    """The card's rates, none of the reference's TPU v5e figures."""
    assert (HW["peak_flops"], HW["hbm_bw"], HW["nvlink_bw"]) == \
        (67e12, 3.35e12, 450e9)
    assert (HW["card"], HW["power_limit_w"]) == ("NVIDIA H100 80GB HBM3",
                                                  700.0)
    tpu = {197e12, 819e9, 50e9, 16 * 1024 ** 3}
    assert not tpu & set(v for v in HW.values() if not isinstance(v, str))


def _cpu_mvm():
    cfg = CrossbarConfig(device=get_device("taox-hfox"),
                         geom=MCAGeometry(2, 2, 32, 32))
    eng = AnalogEngine(cfg, backend="cuda", device="cpu")
    a = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (96, 80)).astype(np.float32))
    A = eng.program(a, 0)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (80, 2)).astype(np.float32))
    return A, x


def test_analyze_run_record_renders_in_reference_report():
    """A CPU corrected MVM's record carries the keys the reference's
    ``report.py`` reads and renders in its roofline and dry-run tables,
    beside the fields a dry run adds to each record."""
    A, x = _cpu_mvm()
    rec = analyze_run(lambda v: A @ v, x, model_flops=4 * 96 * 80 * 2)
    assert rec["memory"]["peak_bytes"] is None   # nothing measures it here
    assert "device_ms" not in rec and "by_kernel" not in rec
    ec = kernel_cost.ec_matmul(96, 80, 2)         # the live image
    assert ec.flops < rec["flops_per_device"] < 1.2 * ec.flops
    assert rec["dominant"] == "memory"
    assert rec["useful_ratio"] == pytest.approx(
        4 * 96 * 80 * 2 / rec["flops_per_device"])
    cell = {**rec, "arch": "meliso-mvm", "shape": "mvm_65536",
            "mesh": [1, 1], "kind": "mvm", "compile_s": 0.0, "_tag": ""}
    table = jreport.roofline_table([cell])
    assert f"| meliso-mvm x mvm_65536 | {rec['compute_s']:.3e} | " \
        f"{rec['memory_s']:.3e} | {rec['collective_s']:.3e} | " \
        f"**memory** | {rec['useful_ratio']:.3f} |" in table
    # The dry-run table prints a peak; on the card analyze_run measures
    # it, on the CPU the row is given the record's own argument and
    # result bytes in its place.
    mem = rec["memory"]
    cell["memory"] = {**mem, "peak_bytes": mem["argument_bytes"]
                      + mem["output_bytes"]}
    row = jreport.dryrun_table([cell]).splitlines()[-1]
    assert row.startswith("| meliso-mvm x mvm_65536 | 1x1 | mvm | yes | ")
    assert format_row("mvm", cell).startswith(
        f"| mvm | {rec['compute_s']:.3e} |")


@pytest.mark.parametrize("twin", [False, True])
@pytest.mark.parametrize("name", KERNEL_NAMES)
def test_kernel_function_counts_its_declared_cost(name, twin):
    """Each kernel function, as its wrapper or called directly as its plain
    twin, counts its declared cost (the hand count) once a call, and none
    of the operators run inside it."""
    wrap, plain, args, kw, pargs, pkw, want = kernel_calls("cpu")[name]
    fn, a, k = (plain, pargs, pkw) if twin else (wrap, args, kw)
    rec = []
    got = measure_cost(fn, *a, record=rec, **k)
    assert (got.flops, got.bytes) == tuple(map(float, want))
    assert [(r[3], r[4]) for r in rec] == \
        [(name, kernel_cost.range_name(name))]
    assert tuple(kernel_cost.of_call(name, *a, **k)) == want


@pytest.mark.parametrize("outer,args", [
    ("rram_encode_matmul", "encode"), ("ec_group_matmul_plain", "group"),
    ("encode_matmul_rng_plain", "rng"), ("ec_group_rmatmul", "rgroup")])
def test_nested_kernel_functions_count_once(outer, args):
    """A kernel function inside another (the entry point's wrapper, a
    grouped twin's solo twins, the rng twin's product, a wrapper's twin on
    the CPU) is part of the outer call: the observers see one entry and
    one exit, and the run counts the outer cost alone."""
    calls = kernel_calls("cpu")
    pick = {"encode": ("encode_matmul", 2), "group": ("ec_group_matmul", 4),
            "rng": ("encode_matmul_rng", 4), "rgroup": ("ec_group_rmatmul", 2)}
    name, slot = pick[args]
    a, k = calls[name][slot], calls[name][slot + 1]
    if outer == "rram_encode_matmul":
        k = {kk: v for kk, v in k.items() if kk not in ("block_k", "block_n")}
    events = []
    kernel_cost.OBSERVERS.append(lambda *e: events.append(e[:2]))
    try:
        got = measure_cost(getattr(kernels, outer), *a, **k)
    finally:
        kernel_cost.OBSERVERS.pop()
    assert events == [("enter", name), ("exit", name)]
    want = kernel_cost.of_call(name, *a, **k)
    assert (got.flops, got.bytes) == (want.flops, want.bytes)
    assert kernel_cost.OBSERVERS == [] and kernel_cost.outermost()


def test_observers_removed_when_the_call_raises():
    """The counting hooks are removed however the call ends, and an idle
    kernel function opens no profiler range."""
    def boom(p):
        kernels.stencil_denoise(p, 1e-2)
        raise KeyError("x")
    with pytest.raises(KeyError):
        measure_cost(boom, torch.ones(8, 1))
    assert kernel_cost.OBSERVERS == [] and mesh_mod.OBSERVERS == []
    assert kernel_cost.outermost()
    with torch.profiler.profile() as prof:
        kernels.stencil_denoise(torch.ones(8, 1), 1e-2)
    assert not any(e.name.startswith("repro_torch.kernels")
                   for e in prof.events())


def test_ec_launch_bytes_counts_the_re_reads():
    """Up to 8 columns the launches move the declared bytes; above, the
    images once more per further 8 columns."""
    m, k = 2048, 6144
    for b in (1, 4, 8):
        assert kernel_cost.ec_launch_bytes(m, k, b, transpose=True) == \
            kernel_cost.ec_rmatmul(m, k, b).bytes
    assert kernel_cost.ec_launch_bytes(m, k, 1024, transpose=True) - \
        kernel_cost.ec_rmatmul(m, k, 1024).bytes == 127 * 8 * m * k
    assert kernel_cost.ec_launch_bytes(m, k, 9, transpose=False) - \
        kernel_cost.ec_matmul(m, k, 9).bytes == 8 * m * k



def test_ec_launch_bytes_follow_the_launchers_column_cap(monkeypatch):
    """The launch traffic reads the launcher's own cap on the columns of
    one launch (``rram_mvm.MAX_KERNEL_BATCH``), not a copy of it."""
    from repro_torch.kernels import rram_mvm
    m, k = 64, 96
    monkeypatch.setattr(rram_mvm, "MAX_KERNEL_BATCH", 4)
    assert kernel_cost.ec_launch_bytes(m, k, 8, transpose=True) - \
        kernel_cost.ec_rmatmul(m, k, 8).bytes == 8 * m * k
    assert kernel_cost.ec_launch_bytes(m, k, 9, transpose=False, g=3) - \
        kernel_cost.ec_group_matmul(3, m, k, 9).bytes == 2 * 3 * 8 * m * k


@pytest.mark.parametrize("direction", ["forward", "transposed"])
def test_mesh_mvm_wire_equals_ring_formula(direction):
    """A 2 x 4 CPU mesh MVM: one psum (an all-reduce over the 4 column
    ranks forward, the 2 row ranks transposed) and one join (an all-gather
    over the 8 ranks), each at the ring formula over the tensors the mesh
    handed over."""
    cfg = CrossbarConfig(device=get_device("taox-hfox"),
                         geom=MCAGeometry(2, 2, 16, 16))
    grid = make_mesh((2, 4), ("data", "model"), device="cpu")
    eng = AnalogEngine(cfg, execution="distributed", mesh=grid)
    a = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (96, 160)).astype(np.float32))
    A = eng.program(a, 0)
    rows = 160 if direction == "forward" else 96
    v = torch.ones(rows, 3)
    seen = []
    mesh_mod.OBSERVERS.append(lambda kind, axes, ts, m: seen.append(
        (kind, sum(t.numel() * 4 for t in ts), ts[0].numel() * 4)))
    try:
        got = measure_cost((lambda u: A @ u) if direction == "forward"
                           else (lambda u: A.T @ u), v)
    finally:
        mesh_mod.OBSERVERS.pop()
    (psum_kind, _, partial), (join_kind, joined, _) = seen
    assert (psum_kind, join_kind) == ("psum", "gather")
    g = 4 if direction == "forward" else 2
    ring = {"all-reduce": 2 * partial * (g - 1) / g,
            "all-gather": joined * 7 / 8}
    assert got.wire_by_op == ring
    assert got.wire == sum(ring.values())
    records = [{"op": op, "wire": w} for op, w in ring.items()]
    assert collective_wire_bytes(records) == (got.wire, ring)
    assert count_op(records, "all-reduce") == 1


def test_roofline_module_exports():
    """The names the reference's roofline exports, on the card's rates."""
    assert set(roofline.__all__) >= {"HW", "analyze_run", "roofline_terms",
                                     "format_row"}


class _Event:
    """A raw profiler event: name, device, kind and span in ns."""

    def __init__(self, name, device, kind, start, end):
        self._v = (name, device, kind, start, end)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def activity_type(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def end_ns(self):
        return self._v[4]


def test_device_times_keep_the_run_and_its_kernel_functions():
    """The device time of a profile is the work that starts inside the
    run's host span: a kernel of earlier work (before it) and the flush
    launches (left out by name, wherever the device's clock puts them) are
    not the run's, a range's device-side span is not work, and each kernel
    function gets the kernels that ran inside its span (time the device
    waits between them is no one's)."""
    from types import SimpleNamespace
    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ec = kernel_cost.range_name("ec_matmul")
    run = [_Event(roofline._RUN_RANGE, cpu, "user_annotation", 100, 1_000),
           _Event(roofline._RUN_RANGE, gpu, "gpu_user_annotation", 200, 260)]
    events = [
        _Event("earlier_kernel", gpu, "kernel", 50, 90),
        _Event(ec, cpu, "user_annotation", 150, 200),
        _Event(ec, gpu, "gpu_user_annotation", 300, 700),
        _Event("pack_x_kernel", gpu, "kernel", 300, 340),
        _Event("ec_matmul_staged_kernel", gpu, "kernel", 500, 650),
        _Event("piece_sum_kernel", gpu, "kernel", 660, 700),
        _Event("dac_kernel", gpu, "kernel", 200, 260),
        _Event("Memset (Device)", gpu, "gpu_memset", 720, 730),
        _Event("launch_floor_kernel(float*)", gpu, "kernel", 990, 992),
    ]

    def times(evs):
        prof = SimpleNamespace(profiler=SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: evs)))
        return roofline._device_times(prof, ["ec_matmul", "cg_update"])

    total, per = times(run + events)
    assert total == pytest.approx((40 + 150 + 40 + 60 + 10) / 1e6)
    assert per == pytest.approx({"ec_matmul": (40 + 150 + 40) / 1e6,
                                 "cg_update": 0.0})
    with pytest.raises(RuntimeError, match="0 spans of its run"):
        times(events)


def test_device_times_count_overlapping_kernels_once():
    """Kernels launched with programmatic dependent launch start before
    the one before them ends and wait for it: their records overlap, and
    the device time, of the run and of a kernel function, is the union of
    the intervals, not their sum."""
    from types import SimpleNamespace
    cpu, gpu = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    st = kernel_cost.range_name("stencil_denoise")
    events = [
        _Event(roofline._RUN_RANGE, cpu, "user_annotation", 100, 1_000),
        _Event(st, gpu, "gpu_user_annotation", 300, 600),
        _Event("stencil_pass_one", gpu, "kernel", 300, 500),
        _Event("stencil_pass_two", gpu, "kernel", 350, 600),
        _Event("stencil_pass_three", gpu, "kernel", 400, 450),
        _Event("after_kernel", gpu, "kernel", 580, 700),
        _Event("apart_kernel", gpu, "kernel", 800, 850),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    total, per = roofline._device_times(prof, ["stencil_denoise"])
    assert total == pytest.approx((700 - 300 + 50) / 1e6)
    assert per == pytest.approx({"stencil_denoise": (700 - 300) / 1e6})
    assert roofline._busy_ns([]) == 0
    assert roofline._busy_ns([(5, 9), (0, 2), (1, 3), (9, 10)]) == 3 + 5
