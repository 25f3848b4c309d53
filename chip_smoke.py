#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU, full size.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (``$CUDA_HOME/bin`` or ``PATH``); exits
non-zero, printing no result, without them or without the repository's
``src/repro_torch`` beside it.  Phases, each of which raises on failure:

  1. build the four CUDA kernels from ``src/repro_torch/kernels/csrc``;
  2. program a 32,768 x 32,768 matrix (taox-hfox, EC on, default 8 x 8 MCAs
     of 512 x 512) and hold each kernel to its plain PyTorch version at the
     main path's shapes, timing kernel, plain version and library call;
  3. serve 8 single-vector requests and one batch of 8 through
     ``backend="cuda"``, against the digital ``a @ x``, the ``reference``
     backend on the same image, and -- with the input DAC off, where both
     are deterministic -- the reference pipeline to 1e-5;
  4. solve an SPD system (epiram, EC on) with CG and Richardson through
     ``backend="cuda"`` to x error <= 1e-3.

Launch counts are zeroed just before phases 3 and 4 and read just after:
every kernel must have run on that path.  The last three lines of output
are the kernel table as JSON, the card's name and power limit, and the
result line.  Peak rates are the published H100 SXM figures (3.35 TB/s of
HBM, 67 TFLOP/s float32 outside the tensor cores).
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

N = 32768
SEED = 0
STENCIL_CHECK_LAM = 1e-2  # large enough that the stencil term shows in fp32
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
EC_TOL = 1e-5          # ec_matmul vs its plain version (fp32 sums, other order)
ELEMENTWISE_TOL = 1e-6  # the three one-pass kernels
SOLVE_TOL = 1e-3
SLEEP_CYCLES = 100_000_000  # ~50 ms at the H100's clock: longer than queueing a run


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((got - want).double())
                 / torch.linalg.vector_norm(want.double()))


def device_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call of ``fn``: a sleep kernel holds the
    stream while the host queues all ``iters`` calls, so the CUDA events
    around them see the device's time and not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def call_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of one call of ``fn`` as a caller looping on it sees it:
    host clock around back-to-back calls, host overhead included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, kernel_fn, plain_fn, tol, nbytes, flops, iters,
            library_fn=None):
    """Kernel vs plain version on the same inputs: error, times, bound."""
    got, want = kernel_fn(), plain_fn()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(rel_l2(g, w) for g, w in zip(got, want))
    max_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"{name}: non-finite output")
    check(err <= tol, f"{name}: rel-L2 {err:.3e} against its plain version "
                      f"exceeds {tol:.0e}")
    b_ms, b_by = bound_ms(nbytes, flops)
    row = {"rel_l2": err, "max_abs_err": max_abs,
           "ms": device_time_ms(kernel_fn, iters),
           "call_ms": call_time_ms(kernel_fn, iters),
           "plain_ms": device_time_ms(plain_fn, iters),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": (device_time_ms(library_fn, iters)
                          if library_fn is not None else None)}
    lib = "-" if library_fn is None else f"{row['library_ms']:.4f} ms"
    print(f"  {name:34s} rel-L2 {err:.2e} max|err| {max_abs:.2e}  kernel "
          f"{row['ms']:.4f} ms (per call {row['call_ms']:.4f})  plain "
          f"{row['plain_ms']:.4f} ms  library {lib}  bound {b_ms:.4f} ms "
          f"({b_by})", flush=True)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch import kernels, solvers
    from repro_torch.core import CrossbarConfig, get_device
    from repro_torch.core import crossbar
    from repro_torch.core.prng import generator
    from repro_torch.engine import AnalogEngine, AnalogMatrix
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | tf32 off",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    build.library()
    print(f"[1] build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{build.build_seconds:.1f} s)", flush=True)
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("    " + line.strip())

    # -------------------------------------------- 2. program, kernels vs plain
    cfg = CrossbarConfig(device=get_device("taox-hfox"))
    engine = AnalogEngine(cfg, backend="cuda", device=dev)
    a = torch.randn(N, N, generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    A = engine.program(a, 1)
    torch.cuda.synchronize()
    gib = 2.0 ** 30
    print(f"[2] programmed {N} x {N} ({cfg.device.name}, "
          f"{cfg.geom.capacity[0]}^2 capacity blocks) in "
          f"{time.perf_counter() - t0:.2f} s; peak "
          f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB (A "
          f"{a.nbytes / gib:.0f} + image {A.image_nbytes / gib:.0f} GiB)",
          flush=True)
    check(A.at_pad.shape == (N, N), "unexpected padded image shape")

    rows = {}
    for batch in (1, 8):
        x = torch.randn(N, batch, generator=gen, device=dev)
        x_t = crossbar._encode_vec(x, cfg, gen=generator(batch, dev))
        at, da = A.at_pad, A.da_pad
        m, k = at.shape
        res = {"ec_matmul": compare(
            f"ec_matmul {m}x{k} batch {batch}",
            lambda: kernels.ec_matmul(at, da, x, x_t),
            lambda: kernels.ec_matmul_plain(at, da, x, x_t), EC_TOL,
            nbytes=4 * (2 * m * k + 2 * k * batch + m * batch),
            flops=4 * m * k * batch, iters=10,
            library_fn=lambda: torch.matmul(at, x) + torch.matmul(da, x_t))}
        p = kernels.ec_matmul(at, da, x, x_t)
        for lam in (cfg.lam, STENCIL_CHECK_LAM):
            # At the engine's lam = 1e-12 the stencil term is below fp32
            # resolution; STENCIL_CHECK_LAM checks the stencil itself.
            res[f"stencil_denoise@{lam:g}"] = compare(
                f"stencil_denoise {m}x{batch} lam {lam:g}",
                lambda: kernels.stencil_denoise(p, lam, cfg.h),
                lambda: kernels.stencil_denoise_plain(p, lam, cfg.h),
                ELEMENTWISE_TOL, nbytes=4 * 2 * m * batch,
                flops=6 * m * batch, iters=50)
        # Timed at the engine's lam; its error is the one at the check lam.
        res["stencil_denoise"] = res.pop(f"stencil_denoise@{cfg.lam:g}")
        checked = res.pop(f"stencil_denoise@{STENCIL_CHECK_LAM:g}")
        res["stencil_denoise"].update(
            rel_l2=checked["rel_l2"], max_abs_err=checked["max_abs_err"],
            err_lam=STENCIL_CHECK_LAM, ms_lam=cfg.lam)
        v = [torch.randn(m, batch, generator=gen, device=dev)
             for _ in range(4)]
        alpha = torch.rand(batch, generator=gen, device=dev)
        res["cg_update"] = compare(
            f"cg_update {m}x{batch}",
            lambda: kernels.cg_update(*v, alpha),
            lambda: kernels.cg_update_plain(*v, alpha), ELEMENTWISE_TOL,
            nbytes=4 * (6 * m * batch + batch), flops=4 * m * batch,
            iters=50)
        omega = torch.rand((), generator=gen, device=dev)
        res["richardson_update"] = compare(
            f"richardson_update {m}x{batch}",
            lambda: kernels.richardson_update(*v[:3], omega),
            lambda: kernels.richardson_update_plain(*v[:3], omega),
            ELEMENTWISE_TOL, nbytes=4 * (5 * m * batch + 1),
            flops=3 * m * batch, iters=50)
        rows[batch] = res
    torch.cuda.synchronize()

    # ------------------------------------------------------- 3. serve (main)
    xs = torch.randn(N, 8, generator=gen, device=dev)
    digital = torch.matmul(a, xs)
    kernels.reset_launches()
    t0 = time.perf_counter()
    singles = torch.stack([A @ xs[:, i] for i in range(8)], dim=1)
    batched = A @ xs
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    served = dict(kernels.LAUNCHES)
    check(served["ec_matmul"] > 0 and served["stencil_denoise"] > 0,
          f"serving did not launch the MVM kernels: {served}")
    check(tuple(singles.shape) == (N, 8) and tuple(batched.shape) == (N, 8),
          "unexpected output shapes")
    check(bool(torch.isfinite(singles).all() & torch.isfinite(batched).all()),
          "non-finite MVM output")
    err_cuda = rel_l2(singles, digital)
    err_batch = rel_l2(batched, digital)
    reference = AnalogEngine(cfg, backend="reference", device=dev)
    err_ref = rel_l2(reference.mvm(A, xs), digital)
    print(f"[3] served 8 requests + 1 batch of 8 in {serve_s * 1e3:.1f} ms; "
          f"launches {served}", flush=True)
    print(f"    rel-L2 vs digital a @ x: cuda {err_cuda:.4e} (batch "
          f"{err_batch:.4e}), reference backend {err_ref:.4e}", flush=True)
    check(err_cuda < 0.1 and 0.5 < err_cuda / err_ref < 2.0,
          "cuda and reference backends disagree in accuracy")
    # With the DAC off both backends are deterministic functions of the
    # image: the kernel path must equal the plain reference pipeline.
    exact = dataclasses.replace(cfg, encode_inputs=False)
    views = [AnalogMatrix(engine=AnalogEngine(exact, backend=be, device=dev),
                          shape=A.shape, base_key=0,
                          write_stats=A.write_stats, at_pad=A.at_pad,
                          da_pad=A.da_pad) for be in ("cuda", "reference")]
    det = [h @ xs for h in views]
    det_err = rel_l2(det[0], det[1])
    print(f"    DAC off: cuda vs reference pipeline rel-L2 {det_err:.3e} "
          f"(vs digital {rel_l2(det[0], digital):.3e})", flush=True)
    check(det_err <= 1e-5, "cuda path disagrees with the reference pipeline")
    x1 = xs[:, :1].contiguous()
    mvm_ms = {be: call_time_ms(lambda: AnalogEngine(cfg, backend=be,
                                                    device=dev).mvm(A, x1), 5)
              for be in ("cuda", "reference")}
    print(f"    corrected MVM, batch 1, per call: cuda {mvm_ms['cuda']:.3f} "
          f"ms, reference {mvm_ms['reference']:.3f} ms", flush=True)
    del A, a, digital, views, det, batched, singles
    torch.cuda.empty_cache()

    # ------------------------------------------------------- 4. solve (main)
    scfg = CrossbarConfig(device=get_device("epiram"))
    a = torch.randn(N, N, generator=gen, device=dev).div_(N)
    a = a + a.T
    a.diagonal().add_(2.0)
    x_true = torch.randn(N, generator=gen, device=dev)
    b = torch.matmul(a, x_true)
    A = AnalogEngine(scfg, backend="cuda", device=dev).program(a, 2)
    del a
    torch.cuda.empty_cache()
    kernels.reset_launches()
    solved = {}
    for name, solve in (("cg", solvers.cg), ("richardson", solvers.richardson)):
        for run in ("cold", "warm"):   # cold: first use of its ops' kernels
            before = dict(kernels.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve(A, b, tol=SOLVE_TOL, maxiter=50, backend="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            err = rel_l2(res.x, x_true)
            mvms = res.ledger.mvms + res.ledger.mvms_single
            used = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
            solved[name] = used
            print(f"[4] {name} ({run}): {res.iterations} iterations, {mvms} "
                  f"MVMs, converged={res.converged}, x err {err:.3e}, "
                  f"{wall * 1e3:.1f} ms = "
                  f"{wall * 1e3 / max(res.iterations, 1):.3f} ms/iteration "
                  f"({wall * 1e3 / mvms:.3f} ms/MVM); launches {used}",
                  flush=True)
            check(res.converged and err <= SOLVE_TOL,
                  f"{name} did not reach x error <= {SOLVE_TOL}")
    check(solved["cg"]["cg_update"] > 0 and
          solved["richardson"]["richardson_update"] > 0,
          f"the solvers did not launch their update kernels: {solved}")
    solve_counts = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()

    # ---------------------------------------------------------- report
    sources = {
        "ec_matmul": ("src/repro_torch/kernels/csrc/rram_mvm.cu",
                      "src/repro/kernels/rram_mvm.py:236"),
        "stencil_denoise": ("src/repro_torch/kernels/csrc/tridiag.cu",
                            "src/repro/kernels/tridiag.py:108"),
        "cg_update": ("src/repro_torch/kernels/csrc/solver_update.cu",
                      "src/repro/kernels/solver_update.py:83"),
        "richardson_update": ("src/repro_torch/kernels/csrc/solver_update.cu",
                              "src/repro/kernels/solver_update.py:46"),
    }
    table = []
    for name, (source, replaces) in sources.items():
        launches = served[name] + solve_counts[name]
        check(launches > 0, f"{name} was not launched on the main path")
        row = rows[1][name]
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "rel_l2": row["rel_l2"],
            **{k: row[k] for k in ("err_lam", "ms_lam") if k in row},
            "ms": row["ms"],
            "call_ms": row["call_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "batch": 1,
            "batch8": {k: rows[8][name][k] for k in
                       ("ms", "call_ms", "plain_ms", "bound_ms",
                        "library_ms")},
        })
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
