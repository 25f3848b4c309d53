"""Three-term roofline of one run on the card (of :mod:`repro.analysis.roofline`).

    compute    = flops / peak_flops
    memory     = bytes / hbm_bw
    collective = per-device wire bytes (analysis.wire) / nvlink_bw

The counts come from :func:`repro_torch.analysis.cost.measure_cost`, which
runs the call (the reference reads a compiled program): each kernel
function by its declared cost, every other operator under the reference's
conventions.  The dominant term is the least time the card could take for
the run's work; :func:`analyze_run` also measures, on CUDA tensors, the
run's device time under ``torch.profiler`` and how close the run came to
that bound (``achieved``), per kernel function too.

The reference's ``_cpu_bf16_artifact_bytes``, ``peak_bytes_tpu`` and
``fits_hbm_raw_cpu`` have no counterpart: they correct for the float32
twins XLA's CPU backend makes of bfloat16 weights, which eager PyTorch
never makes.
"""
from __future__ import annotations

import bisect
from typing import Any, Dict, Optional

import torch

from .. import kernels
from ..kernels import cost as kernel_cost
from . import memory
from .cost import _measure
from .memory import _tensors

__all__ = ["HW", "analyze_run", "roofline_terms", "format_row", "bound_ms"]

HW = {
    # torch.cuda.get_device_name(0) and nvidia-smi's power.limit of the
    # card the port is measured on (700 W: the H100 SXM's maximum).
    "card": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700.0,
    # Float32 outside the tensor cores, the dtype of every port kernel
    # (TF32 is an opt-in, never the default): NVIDIA H100 SXM datasheet.
    "peak_flops": 67e12,
    # HBM3, NVIDIA H100 SXM datasheet.
    "hbm_bw": 3.35e12,
    # One direction of NVLink 4's 900 GB/s (NVIDIA H100 SXM datasheet).
    "nvlink_bw": 450e9,
    # torch.cuda.get_device_properties(0).total_memory on that card.
    "hbm_bytes": 85_017_493_504,
}

#: What the card's profile records (a test narrows it to show the raise).
_ACTIVITIES = ("CPU", "CUDA")
#: The profiler range the counted run is made in.  A profile can hold
#: device records of work from before it (the peak run's) and lose the
#: last ones of its own to the next profile: only the work that starts
#: inside this range's span on the host's clock is the run's, and
#: ``_FLUSH_LAUNCHES`` launches of ``kernels.launch_floor_probe`` (one
#: thread writes one float; left out by name, as the device's clock may
#: place them before the range's end) follow it, so that the records a
#: profile may lose are theirs.
_RUN_RANGE = "repro_torch.analysis.analyze_run"
_FLUSH_KERNEL = "launch_floor"
_FLUSH_LAUNCHES = 64


def roofline_terms(flops: float, bytes_acc: float,
                   wire: float) -> Dict[str, Any]:
    t_c = flops / HW["peak_flops"]
    t_m = bytes_acc / HW["hbm_bw"]
    t_x = wire / HW["nvlink_bw"]
    terms = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x}
    dom = max(terms, key=terms.get)
    return {**terms, "dominant": dom.replace("_s", ""),
            "dominant_time_s": terms[dom]}


def bound_ms(flops: float, nbytes: float):
    """``(ms, "bytes" or "operations")``: the larger of :func:`roofline_terms`'
    memory and compute times (bytes on a tie), in ms."""
    t = roofline_terms(flops, nbytes, 0.0)
    if t["memory_s"] >= t["compute_s"]:
        return t["memory_s"] * 1e3, "bytes"
    return t["compute_s"] * 1e3, "operations"


def format_row(name: str, r: Dict[str, Any]) -> str:
    peak = r["memory"]["peak_bytes"]
    peak_s = "-" if peak is None else f"{peak / 2**30:.2f}"
    return (f"| {name} | {r['compute_s']:.3e} | {r['memory_s']:.3e} | "
            f"{r['collective_s']:.3e} | {r['dominant']} | "
            f"{r.get('useful_ratio', 0):.3f} | "
            f"{r.get('roofline_fraction', 0):.3f} | "
            f"{peak_s} GiB |")


def _bytes_of(tree) -> int:
    seen = {id(t): t for t in _tensors(tree, [])}
    return sum(t.numel() * t.element_size() for t in seen.values())


#: Kineto's kinds of device work; its ``gpu_user_annotation`` events are
#: the device-side spans of ``record_function`` ranges, not work.
_WORK = {"kernel", "concurrent_kernel", "gpu_memcpy", "gpu_memset"}


def _busy_ns(intervals) -> int:
    """The length of the union of ``(start, end)`` intervals: a kernel
    launched with programmatic dependent launch starts before its
    predecessor ends and waits for it, so the records overlap and a plain
    sum would count the overlap twice."""
    busy, reach = 0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    return busy


def _device_times(prof, names):
    """``(device ms, {name: ms})`` of the counted run in a profile: the
    time the device was busy (the union of the intervals, :func:`_busy_ns`)
    with kernels, copies and sets that start inside the host-side span of
    :data:`_RUN_RANGE` (the flush launches left out), and with those that
    start inside the device-side span of each kernel function's range (from
    the start of the first kernel launched in the range to the end of the
    last; the stream runs them in order, so whatever runs inside it was
    launched in it, and time the device waits on the host in between is no
    one's).  Reads Kineto's raw events: building the profiler's event tree
    takes seconds on a run of many operators."""
    spans = {kernel_cost.range_name(n): n for n in names}
    cpu = torch.autograd.DeviceType.CPU
    events = prof.profiler.kineto_results.events()
    run = [e.start_ns() for e in events
           if e.device_type() == cpu and e.name() == _RUN_RANGE]
    if len(run) != 1:
        raise RuntimeError(f"analyze_run: {len(run)} spans of its run in "
                           f"the profile")
    work, marks = [], []
    for e in events:
        if e.device_type() == cpu:
            continue
        kind = (e.activity_type() if hasattr(e, "activity_type") else
                "gpu_user_annotation"
                if e.name() in spans or e.name() == _RUN_RANGE else "kernel")
        if kind == "gpu_user_annotation":
            if e.name() in spans:
                marks.append((e.start_ns(), e.end_ns(), spans[e.name()]))
        elif (kind in _WORK and e.start_ns() >= run[0]
              and _FLUSH_KERNEL not in e.name()):
            work.append((e.start_ns(), e.end_ns()))
    marks.sort()
    starts = [m[0] for m in marks]
    per = {n: [] for n in names}
    for start, end in work:
        i = bisect.bisect_right(starts, start) - 1
        if i >= 0 and start < marks[i][1]:
            per[marks[i][2]].append((start, end))
    return _busy_ns(work) / 1e6, {n: _busy_ns(iv) / 1e6
                                  for n, iv in per.items()}


def analyze_run(fn, *args: Any, n_devices: int = 1,
                model_flops: Optional[float] = None,
                **kwargs: Any) -> Dict[str, Any]:
    """The roofline record of ``fn(*args, **kwargs)``.

    On CPU tensors the call runs once, counted.  On CUDA tensors (decided
    by the tensor arguments, as :func:`~repro_torch.analysis.memory.peak_bytes`
    decides) it runs twice: once under ``peak_bytes`` (the allocator's
    peak over the start; it warms the call), then counted and under
    ``torch.profiler``, which adds ``device_ms`` (the time the device was
    busy with the run's work), ``achieved`` (``dominant_time_s`` over
    it) and ``by_kernel``: each kernel function's calls, launches (the
    change of ``kernels.LAUNCHES``), device ms (its profiler ranges),
    flops, bytes, ``bound_ms`` and ``achieved``.  A run on the card whose profile holds
    no device time raises ``RuntimeError``: no record goes without it.
    After many device-only profiles in the same process (torch 2.11 on an
    NVIDIA H100 80GB HBM3, 700.00 W) a profile was seen to hold device
    records of earlier work and to miss its own: measure in a process
    whose profiles are all ``analyze_run``'s.

    The counts are the run's on every rank of the placement; the terms are
    those of one of ``n_devices`` cards holding an equal share (divided by
    ``n_devices``); the wire bytes are per device already.  ``memory``
    holds the bytes of the arguments and the result, ``peak_bytes`` (None
    on the CPU, where nothing measures it) and ``fits_hbm``: the peak, or
    on the CPU the arguments and result, within ``HW["hbm_bytes"]``.
    """
    on_card = any(t.is_cuda for t in _tensors((args, kwargs), []))
    peak = memory.peak_bytes(fn, *args, **kwargs) if on_card else None
    launches0 = dict(kernels.LAUNCHES)
    if on_card:
        from torch.profiler import ProfilerActivity, profile
        acts = [getattr(ProfilerActivity, a) for a in _ACTIVITIES]
        torch.cuda.synchronize()
        flag = torch.zeros(1, device=next(
            t.device for t in _tensors((args, kwargs), []) if t.is_cuda))
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(_RUN_RANGE):
                mode, out = _measure(fn, args, kwargs, None)
                torch.cuda.synchronize()
            for _ in range(_FLUSH_LAUNCHES):
                kernels.launch_floor_probe(flag)
            torch.cuda.synchronize()
    else:
        mode, out = _measure(fn, args, kwargs, None)
    total = mode.total
    flops, nbytes = total.flops / n_devices, total.bytes / n_devices
    arg_b, out_b = _bytes_of((args, kwargs)), _bytes_of(out)
    rec: Dict[str, Any] = {
        "flops_per_device": flops,
        "bytes_per_device": nbytes,
        "collective_wire_bytes": total.wire,
        "collective_by_op": dict(total.wire_by_op),
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "peak_bytes": peak,
            "fits_hbm": bool((arg_b + out_b if peak is None else peak)
                             <= HW["hbm_bytes"]),
        },
        "n_devices": n_devices,
    }
    rec.update(roofline_terms(flops, nbytes, total.wire))
    if model_flops:
        per_dev_useful = model_flops / n_devices
        rec["model_flops"] = model_flops
        rec["useful_ratio"] = (per_dev_useful / flops) if flops else 0.0
        rec["useful_time_s"] = per_dev_useful / HW["peak_flops"]
        dom = rec["dominant_time_s"]
        rec["roofline_fraction"] = (rec["useful_time_s"] / dom) if dom \
            else 0.0
    if not on_card:
        return rec
    launched = {k: v - launches0[k] for k, v in kernels.LAUNCHES.items()
                if v != launches0[k]}
    names = sorted(set(mode.kernels) | set(launched))
    device_ms, range_ms = _device_times(prof, names)
    if device_ms <= 0.0:
        raise RuntimeError(
            "analyze_run: the profile of a call on the card holds no device "
            "time, so no roofline can be read against it")
    by_kernel = {}
    for name in names:
        k = mode.kernels.get(name, {"calls": 0, "flops": 0, "bytes": 0})
        b_ms, b_by = bound_ms(k["flops"], k["bytes"])
        ms = range_ms[name]
        by_kernel[name] = {**k, "launches": launched.get(name, 0),
                           "device_ms": ms, "bound_ms": b_ms,
                           "bound_by": b_by,
                           "achieved": b_ms / ms if ms else None}
    rec["device_ms"] = device_ms
    rec["by_kernel"] = by_kernel
    rec["achieved"] = rec["dominant_time_s"] * 1e3 / device_ms
    return rec
