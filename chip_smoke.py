#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU, full size.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (``$CUDA_HOME/bin`` or ``PATH``); exits
non-zero, printing no result, without them or without the repository's
``src/repro_torch`` beside it.  Phases, each of which raises on failure:

  1. build the ten CUDA kernels from ``src/repro_torch/kernels/csrc`` and
     print what ``ptxas -v`` reports for each compiled kernel;
  2. program a 32,768 x 32,768 matrix (taox-hfox, EC on, default 8 x 8 MCAs
     of 512 x 512) and hold each kernel to its plain PyTorch version at the
     main path's shapes, timing kernel, plain version and library call; both
     EC products also bit for bit run to run, and the layout each launcher
     chose printed: a persistent one-wave grid over units of the image
     (forward: 16 rows x a 4,096-column piece of K, the pieces added in
     piece order by a second pass; transposed: 16 rows x 512 columns, the
     blocks' partials added in block order), fed by a TMA ring -- the
     staged kernel, which both must take here, in phase 5 and in phase 6;
  3. serve 8 single-vector requests and one batch of 8 through
     ``backend="cuda"``, against the digital ``a @ x``, the ``reference``
     backend on the same image, and -- with the input DAC off, where both
     are deterministic -- the reference pipeline to 1e-5;
  3t. the same for ``A.T @ y`` on the same image, and, DAC off, an engine
     with the exact Thomas tier-2 (lam = 1e-2) in both directions against
     the reference pipeline to 1e-5;
  4. solve an SPD system (epiram, EC on) with CG and Richardson through
     ``backend="cuda"`` to x error <= 1e-3;
  5. solve a consistent 32,768 x 16,384 least-squares problem with LSQR and
     LSMR to normal-equations residual <= 1e-3 and a 16,384 x 32,768 random
     feasible LP with PDHG to KKT residual <= 1e-3 (epiram, EC on); each of
     the two images first holds ec_matmul, ec_rmatmul (batch 1) and
     stencil_denoise (on its 16,384-row panel) to their plain versions, and,
     DAC off, A.T @ y on the cuda path to the reference pipeline to 1e-5
     (Neumann, and Thomas at lam = 1e-2);
  6. program the 8 experts' w1 of one Mixtral-8x7B MoE layer (14,336 x
     4,096 each, A ~ N(0, 1/4,096), taox-hfox, EC on) as one group, hold the
     grouped EC kernels to their plain versions, and run group_mvm /
     group_rmvm at batch 1 and 8 on both backends (a group of one equal to
     the solo kernel bit for bit, both directions): one grouped EC launch and
     one tier-2 launch per call, each member equal to its solo execute, the
     DAC-off cuda path equal to the reference pipeline (Neumann and Thomas
     at lam = 1e-2) to 1e-5;
  6c. chain 32 square 4,096^2 layers (Mixtral's d_model and depth, He
     init, relu) through chain_mvm on both backends: 32 ec_matmul launches
     per chain, DAC off cuda equal to reference to 1e-4 after 32 layers;
  7. x (256, 4,096) @ encode(W (4,096, 14,336)) in 512^2 MCA tiles through
     rram_encode_matmul and encode_matmul_rng (taox-hfox levels and
     effective sigma): each held to its plain version, the rng kernel at
     sigma = 0 equal to encode_matmul with zero eps, bit for bit run to
     run, and its draws' moments read back through the product; for both
     product kernels the ptxas report (registers, stack frame, spills), the
     SM clock and power sampled while they run, the rate reached and each
     CUDA kernel's share of a call, and for the rng kernel a second bound
     that counts its generator.

Launch counts are zeroed just before each solve of phases 4 and 5, and
before phases 3, 3t, 6, 6c and 7's main calls, and read just after: every
kernel must have run on the path that uses it.  The last three
lines of output are the kernel table as JSON, the card's name and power
limit, and the result line.  Peak rates are the published H100 SXM figures
(3.35 TB/s of HBM, 67 TFLOP/s float32 outside the tensor cores).
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

N = 32768
SEED = 0
STENCIL_CHECK_LAM = 1e-2  # large enough that the stencil term shows in fp32
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
EC_TOL = 1e-5          # ec_(r)matmul vs its plain version (fp32 sums, other order)
ELEMENTWISE_TOL = 1e-6  # the one-pass kernels, and thomas_solve (a contraction)
SOLVE_TOL = 1e-3
LSTSQ_SHAPE = (N, N // 2)   # rows, columns of the least-squares matrix
LP_SHAPE = (N // 2, N)      # constraints, variables of the LP
PDHG_MAXITER = 5000
# Mixtral-8x7B (src/repro/configs/mixtral_8x7b.py): one MoE layer's experts.
D_MODEL, D_FF, N_EXPERTS, N_LAYERS = 4096, 14336, 8, 32
CHAIN_TOL = 1e-4        # cuda vs reference after N_LAYERS chained layers
ENCODE_ROWS = 256       # rows of x in phase 7
ENCODE_SEED = 2024
# Thomas: each row is a dependent FMA + multiply forward and an FMA backward,
# about 12 cycles in all; at the H100 SXM's 1.98 GHz boost clock.
THOMAS_CYCLES_PER_ROW = 12
SM_CLOCK_HZ = 1.98e9
SLEEP_CYCLES = 100_000_000  # ~50 ms at the H100's clock: longer than queueing a run
# Instructions a draw of encode_matmul_rng's generator issues at the least,
# counted from the source (philox_normal in csrc/encode_matmul.cu):
# Philox4x32-10, 10 rounds of 2 wide multiplies and 2 three-way XORs (40; the
# key schedule is shared by a thread's draws); the two 24-bit uniforms and
# the clamp (7); logf's branch-free fast path as CUDA 12.9 compiles it (28);
# sqrt_fast (5); cos_small (20).
GEN_INSTRUCTIONS_PER_DRAW = 100


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


def clock_under_load(fn, seconds: float = 1.5):
    """Median SM clock (MHz) and power draw (W) that ``nvidia-smi`` samples
    every 50 ms while ``fn`` runs back to back for about ``seconds``, and the
    number of samples (``(None, None, 0)`` if none came while it ran)."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    samples = []
    reader = threading.Thread(target=lambda: samples.extend(
        (time.perf_counter(), line) for line in proc.stdout), daemon=True)
    reader.start()
    try:
        wait = time.perf_counter()
        while not samples and time.perf_counter() - wait < 10:
            time.sleep(0.01)
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(8):
                fn()
            torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        reader.join(timeout=10)
    under = []
    for t, line in samples:
        parts = [p.strip() for p in line.split(",")]
        if t0 + 0.1 <= t <= t1 and len(parts) == 2:
            try:
                under.append((float(parts[0]), float(parts[1])))
            except ValueError:
                continue
    if not under:
        return None, None, 0
    return (statistics.median(u[0] for u in under),
            statistics.median(u[1] for u in under), len(under))


def kernel_split(fn, iters: int = 5):
    """Mean device ms per call of each CUDA kernel (and memset) ``fn``
    launches, from ``torch.profiler``; empty if the trace has no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.key_averages():
        total = getattr(evt, "device_time_total", None)
        if total is None:
            total = getattr(evt, "cuda_time_total", 0)
        if total:
            split[evt.key] = total / 1e3 / iters
    return split


def short_kernel_name(key: str) -> str:
    """``void (anonymous namespace)::encode_matmul_kernel<false>(float ...)``
    -> ``encode_matmul_kernel<false>``: a profiler key without namespace,
    return type and parameters."""
    key = key.replace("(anonymous namespace)::", "").removeprefix("void ")
    return (key.split("(")[0] or key).strip()


def layout_line(name: str, lay) -> str:
    """What the forward or transposed launcher chose
    (``kernels.matmul_layout`` / ``rmatmul_layout``)."""
    waves = lay.blocks / (lay.blocks_per_sm * lay.sms)
    kind = "staged (TMA)" if lay.staged else "register loads"
    last = (f"{lay.pieces} pieces of K" if hasattr(lay, "pieces") else
            f"<= {lay.partials_per_block} partials a block")
    return (f"    {name} layout: {kind}, {lay.blocks} blocks on "
            f"{lay.blocks_per_sm} x {lay.sms} resident slots ({waves:.3f} "
            f"waves), {lay.units} units of {lay.rows_per_unit} x "
            f"{lay.cols_per_unit}, {last}, workspace "
            f"{lay.workspace_floats} floats")


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, kernel_fn, plain_fn, tol, nbytes, flops, iters,
            library_fn=None, plain_iters=None, plain_warmup=2):
    """Kernel vs plain version on the same inputs: error, times, bound.
    ``plain_iters`` / ``plain_warmup`` time a slow plain version with fewer
    calls than the kernel."""
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
           "plain_ms": device_time_ms(plain_fn, plain_iters or iters,
                                      plain_warmup),
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
    from repro_torch.core.devices import effective_sigma_py
    from repro_torch.core.prng import fold_in, generator
    from repro_torch.engine import (AnalogEngine, AnalogMatrix,
                                    AnalogMatrixGroup)
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
    t_start = time.perf_counter()

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    build.library()
    print(f"[1] build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{build.build_seconds:.1f} s)", flush=True)
    ptxas = build.ptxas_report()
    for name, rep in ptxas.items():
        print(f"    {rep['source']:18s} {name:34s} {rep['registers']:3d} "
              f"registers, {rep['stack']} B stack frame, "
              f"{rep['spill_stores']} / {rep['spill_loads']} B spill stores "
              f"/ loads, {rep['smem']} B static shared memory")

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
        lay = kernels.matmul_layout(at, da, batch)
        res["ec_matmul"]["layout"] = lay._asdict()
        print(layout_line(f"ec_matmul batch {batch}", lay), flush=True)
        check(lay.staged, "ec_matmul did not take the staged kernel on the "
                          "main path's image")
        p = kernels.ec_matmul(at, da, x, x_t)
        check(torch.equal(p, kernels.ec_matmul(at, da, x, x_t)),
              "ec_matmul is not the same run to run")
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
        # The same image read backwards: A_tilde^T y + dA^T y_tilde.
        y = torch.randn(m, batch, generator=gen, device=dev)
        y_t = crossbar._encode_vec(y, cfg, gen=generator(100 + batch, dev))
        res["ec_rmatmul"] = compare(
            f"ec_rmatmul {m}x{k} batch {batch}",
            lambda: kernels.ec_rmatmul(at, da, y, y_t),
            lambda: kernels.ec_rmatmul_plain(at, da, y, y_t), EC_TOL,
            nbytes=4 * (2 * m * k + 2 * m * batch + k * batch),
            flops=4 * m * k * batch, iters=10,
            library_fn=lambda: torch.matmul(at.T, y) + torch.matmul(da.T, y_t))
        lay = kernels.rmatmul_layout(at, da, batch)
        res["ec_rmatmul"]["layout"] = lay._asdict()
        print(layout_line(f"ec_rmatmul batch {batch}", lay), flush=True)
        check(lay.staged, "ec_rmatmul did not take the staged kernel on the "
                          "main path's image")
        check(torch.equal(kernels.ec_rmatmul(at, da, y, y_t),
                          kernels.ec_rmatmul(at, da, y, y_t)),
              "ec_rmatmul is not the same run to run")
        # Thomas: checked at STENCIL_CHECK_LAM (the identity in fp32 at the
        # engine's lam), timed at the engine's lam (the same work).  The
        # plain version is 2n small steps from the host: 1 warmup, 1 timed.
        checked = compare(
            f"thomas_solve {m}x{batch} lam {STENCIL_CHECK_LAM:g} (check)",
            lambda: kernels.thomas_solve(p, STENCIL_CHECK_LAM, cfg.h),
            lambda: kernels.thomas_solve_plain(p, STENCIL_CHECK_LAM, cfg.h),
            ELEMENTWISE_TOL, nbytes=4 * (2 * m * batch + 2 * m),
            flops=5 * m * batch, iters=3, plain_iters=1, plain_warmup=0)
        res["thomas_solve"] = compare(
            f"thomas_solve {m}x{batch} lam {cfg.lam:g}",
            lambda: kernels.thomas_solve(p, cfg.lam, cfg.h),
            lambda: kernels.thomas_solve_plain(p, cfg.lam, cfg.h),
            ELEMENTWISE_TOL, nbytes=4 * (2 * m * batch + 2 * m),
            flops=5 * m * batch, iters=20, plain_iters=1, plain_warmup=1)
        res["thomas_solve"].update(
            rel_l2=checked["rel_l2"], max_abs_err=checked["max_abs_err"],
            err_lam=STENCIL_CHECK_LAM, ms_lam=cfg.lam,
            chain_ms=THOMAS_CYCLES_PER_ROW * m / SM_CLOCK_HZ * 1e3)
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
    del digital, det, batched, singles

    # ------------------------------------- 3t. serve transposed + Thomas (main)
    ys = torch.randn(N, 8, generator=gen, device=dev)
    digital_t = torch.matmul(a.T, ys)
    # DAC off, the exact Thomas tier-2 at a lam where it is not the identity.
    thomas_cfg = dataclasses.replace(exact, denoise_method="thomas",
                                     lam=STENCIL_CHECK_LAM)
    thomas = {be: AnalogMatrix(
        engine=AnalogEngine(thomas_cfg, backend=be, device=dev),
        shape=A.shape, base_key=0, write_stats=A.write_stats,
        at_pad=A.at_pad, da_pad=A.da_pad) for be in ("cuda", "reference")}
    kernels.reset_launches()
    t0 = time.perf_counter()
    singles = torch.stack([A.T @ ys[:, i] for i in range(8)], dim=1)
    batched = A.T @ ys
    torch.cuda.synchronize()
    serve_t_s = time.perf_counter() - t0
    th_cuda = (thomas["cuda"] @ xs, thomas["cuda"].T @ ys)
    torch.cuda.synchronize()
    served_t = dict(kernels.LAUNCHES)
    check(served_t["ec_rmatmul"] > 0 and served_t["thomas_solve"] > 0,
          f"transposed serving did not launch its kernels: {served_t}")
    check(tuple(singles.shape) == (N, 8) and tuple(batched.shape) == (N, 8),
          "unexpected transposed output shapes")
    check(bool(torch.isfinite(singles).all() & torch.isfinite(batched).all()
               & torch.isfinite(th_cuda[0]).all()
               & torch.isfinite(th_cuda[1]).all()),
          "non-finite transposed MVM output")
    err_cuda = rel_l2(singles, digital_t)
    err_batch = rel_l2(batched, digital_t)
    err_ref = rel_l2(reference.rmvm(A, ys), digital_t)
    print(f"[3t] served 8 A.T @ y requests + 1 batch of 8 in "
          f"{serve_t_s * 1e3:.1f} ms; with the Thomas engine, launches "
          f"{served_t}", flush=True)
    print(f"    rel-L2 vs digital a.T @ y: cuda {err_cuda:.4e} (batch "
          f"{err_batch:.4e}), reference backend {err_ref:.4e}", flush=True)
    check(err_cuda < 0.1 and 0.5 < err_cuda / err_ref < 2.0,
          "cuda and reference backends disagree in transposed accuracy")
    det = [h.T @ ys for h in views]
    det_err = rel_l2(det[0], det[1])
    print(f"    DAC off: cuda vs reference pipeline, A.T @ y, rel-L2 "
          f"{det_err:.3e} (vs digital {rel_l2(det[0], digital_t):.3e})",
          flush=True)
    check(det_err <= 1e-5,
          "transposed cuda path disagrees with the reference pipeline")
    t0 = time.perf_counter()
    th_ref = (thomas["reference"] @ xs, thomas["reference"].T @ ys)
    torch.cuda.synchronize()
    th_ref_s = time.perf_counter() - t0
    th_err = [rel_l2(g, w) for g, w in zip(th_cuda, th_ref)]
    print(f"    DAC off, Thomas tier-2 at lam {STENCIL_CHECK_LAM:g}: cuda vs "
          f"reference pipeline rel-L2 {th_err[0]:.3e} (A @ x), "
          f"{th_err[1]:.3e} (A.T @ y); the reference pair took "
          f"{th_ref_s:.1f} s (host-loop Thomas)", flush=True)
    check(max(th_err) <= 1e-5,
          "Thomas cuda path disagrees with the reference pipeline")
    y1 = ys[:, :1].contiguous()
    rmvm_ms = {be: call_time_ms(lambda: AnalogEngine(cfg, backend=be,
                                                     device=dev).rmvm(A, y1), 5)
               for be in ("cuda", "reference")}
    print(f"    corrected A.T @ y, batch 1, per call: cuda "
          f"{rmvm_ms['cuda']:.3f} ms, reference {rmvm_ms['reference']:.3f} ms",
          flush=True)
    # at / da (phase 2's names for the image) go too, or the 8 GiB image
    # stays alive through every later phase.
    del A, a, at, da, digital_t, views, det, batched, singles, thomas, \
        th_cuda, th_ref
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
    del A, b, x_true
    torch.cuda.empty_cache()

    # ------------------------------ 5. least squares and LP (main, A.T @ y)
    def check_image(A):
        """The MVM kernels at batch 1 on a phase-5 image, with its own M, K
        and transposed layout, against their plain versions; the stencil on
        its shorter output panel; DAC off, A.T @ y against the reference."""
        at, da = A.at_pad, A.da_pad
        m, k = at.shape
        x = torch.randn(k, 1, generator=gen, device=dev)
        x_t = crossbar._encode_vec(x, scfg, gen=generator(1, dev))
        y = torch.randn(m, 1, generator=gen, device=dev)
        y_t = crossbar._encode_vec(y, scfg, gen=generator(101, dev))
        res = {"ec_matmul": compare(
            f"ec_matmul {m}x{k} batch 1",
            lambda: kernels.ec_matmul(at, da, x, x_t),
            lambda: kernels.ec_matmul_plain(at, da, x, x_t), EC_TOL,
            nbytes=4 * (2 * m * k + 2 * k + m), flops=4 * m * k, iters=10,
            library_fn=lambda: torch.matmul(at, x) + torch.matmul(da, x_t)),
            "ec_rmatmul": compare(
            f"ec_rmatmul {m}x{k} batch 1",
            lambda: kernels.ec_rmatmul(at, da, y, y_t),
            lambda: kernels.ec_rmatmul_plain(at, da, y, y_t), EC_TOL,
            nbytes=4 * (2 * m * k + 2 * m + k), flops=4 * m * k, iters=10,
            library_fn=lambda: torch.matmul(at.T, y) + torch.matmul(da.T, y_t))}
        for name, query in (("ec_matmul", kernels.matmul_layout),
                            ("ec_rmatmul", kernels.rmatmul_layout)):
            lay = query(at, da, 1)
            res[name]["layout"] = lay._asdict()
            print(layout_line(f"{name} {m}x{k}", lay), flush=True)
            check(lay.staged, f"{name} did not take the staged kernel on "
                              f"the {m}x{k} image")
        # DAC off, A.T @ y through the kernels equals the reference
        # pipeline, with the Neumann stencil and with Thomas at lam 1e-2.
        det_err = {}
        for label, dcfg in (("neumann", dataclasses.replace(
                scfg, encode_inputs=False)), ("thomas", dataclasses.replace(
                scfg, encode_inputs=False, denoise_method="thomas",
                lam=STENCIL_CHECK_LAM))):
            det = [AnalogMatrix(
                engine=AnalogEngine(dcfg, backend=be, device=dev),
                shape=A.shape, base_key=0, write_stats=A.write_stats,
                at_pad=at, da_pad=da).T @ y[:A.shape[0]]
                for be in ("cuda", "reference")]
            det_err[label] = rel_l2(det[0], det[1])
        print(f"    DAC off, A.T @ y: cuda vs reference pipeline rel-L2 "
              f"{det_err['neumann']:.3e} (Neumann), {det_err['thomas']:.3e} "
              f"(Thomas at lam {STENCIL_CHECK_LAM:g})", flush=True)
        check(max(det_err.values()) <= 1e-5,
              f"transposed cuda path disagrees with the reference pipeline "
              f"on the {m}x{k} image")
        p = (kernels.ec_matmul(at, da, x, x_t) if m < k
             else kernels.ec_rmatmul(at, da, y, y_t))
        res["stencil_denoise"] = compare(
            f"stencil_denoise {p.shape[0]}x1 lam {STENCIL_CHECK_LAM:g}",
            lambda: kernels.stencil_denoise(p, STENCIL_CHECK_LAM, scfg.h),
            lambda: kernels.stencil_denoise_plain(p, STENCIL_CHECK_LAM,
                                                  scfg.h),
            ELEMENTWISE_TOL, nbytes=4 * 2 * p.shape[0], flops=6 * p.shape[0],
            iters=50)
        res["stencil_denoise"].update(err_lam=STENCIL_CHECK_LAM,
                                      ms_lam=STENCIL_CHECK_LAM)
        for row in res.values():
            row.update(shape=f"{m}x{k}", batch=1)
        return res

    more_shapes = []
    m, n = LSTSQ_SHAPE
    a = torch.randn(m, n, generator=gen, device=dev).div_(m ** 0.5)
    x_true = torch.randn(n, generator=gen, device=dev)
    b = torch.matmul(a, x_true)
    # kappa of a Gaussian m x n matrix: (1 + sqrt(n/m)) / (1 - sqrt(n/m))
    kappa = (1 + (n / m) ** 0.5) / (1 - (n / m) ** 0.5)
    A = AnalogEngine(scfg, backend="cuda", device=dev).program(a, 3)
    del a
    torch.cuda.empty_cache()
    print(f"[5] {m}x{n} image: kernels vs plain", flush=True)
    more_shapes.append(check_image(A))
    kernels.reset_launches()
    for name in ("lsqr", "lsmr"):
        for run in ("cold", "warm"):
            before = dict(kernels.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = getattr(solvers, name)(A, b, tol=SOLVE_TOL, maxiter=200)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            err = rel_l2(res.x, x_true)
            led = res.ledger
            used = {k: v - before[k] for k, v in kernels.LAUNCHES.items()}
            print(f"[5] {name} ({run}) {m}x{n}: {res.iterations} iterations, "
                  f"{led.mvms} + {led.mvms_t} transposed MVMs, normal "
                  f"residual {res.final_residual:.3e}, converged="
                  f"{res.converged}, x err {err:.3e} (bound kappa^2 tol = "
                  f"{kappa ** 2 * SOLVE_TOL:.2e}), {wall * 1e3:.1f} ms = "
                  f"{wall * 1e3 / max(res.iterations, 1):.3f} ms/iteration; "
                  f"launches {used}", flush=True)
            check(res.converged and bool(torch.isfinite(res.x).all()),
                  f"{name} did not reach normal residual <= {SOLVE_TOL}")
            check(err <= kappa ** 2 * SOLVE_TOL,
                  f"{name}: x error {err:.3e} above kappa^2 tol")
            check(used["ec_rmatmul"] == led.mvms_t,
                  f"{name} did not run every A.T @ u through ec_rmatmul")
    lstsq_counts = dict(kernels.LAUNCHES)
    del A, b, x_true
    torch.cuda.empty_cache()

    m, n = LP_SHAPE
    a, b, c, x_star, y_star = solvers.random_feasible_lp(SEED, m, n,
                                                         device=dev)
    obj = float(torch.dot(c, x_star))
    A = AnalogEngine(scfg, backend="cuda", device=dev).program(a, 4)
    del a
    torch.cuda.empty_cache()
    print(f"[5] {m}x{n} image: kernels vs plain", flush=True)
    more_shapes.append(check_image(A))
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solvers.pdhg(A, b, c, tol=SOLVE_TOL, maxiter=PDHG_MAXITER)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    led = res.ledger
    lp_counts = dict(kernels.LAUNCHES)
    gap = abs(float(torch.dot(c, res.x)) - obj) / (1 + abs(obj))
    print(f"[5] pdhg {m}x{n}: {res.iterations} iterations, {led.mvms} + "
          f"{led.mvms_t} transposed MVMs (+ {led.mvms_single} + "
          f"{led.mvms_single_t} power-iteration), KKT "
          f"{res.final_residual:.3e}, converged={res.converged}, objective "
          f"gap vs c'x* {gap:.3e}, {wall:.2f} s = "
          f"{wall * 1e3 / max(res.iterations, 1):.3f} ms/iteration; "
          f"launches {lp_counts}", flush=True)
    check(res.converged and bool(torch.isfinite(res.x).all()),
          f"pdhg did not reach KKT <= {SOLVE_TOL} in {PDHG_MAXITER} "
          f"iterations")
    check(lp_counts["ec_rmatmul"] == led.mvms_t + led.mvms_single_t,
          "pdhg did not run every A.T @ y through ec_rmatmul")
    del A, b, c, x_star, y_star
    torch.cuda.synchronize()

    torch.cuda.empty_cache()

    # ---------------------------- 6. Mixtral-8x7B expert group (main, groups)
    def group_view(G, gcfg, backend):
        """The same stacks under another engine configuration / backend."""
        return AnalogMatrixGroup(
            engine=AnalogEngine(gcfg, backend=backend, device=dev),
            size=G.size, shape=G.shape, base_key=G.base_key,
            member_keys=G.member_keys, write_stats=G.write_stats,
            at_pad=G.at_pad, da_pad=G.da_pad)

    geng = AnalogEngine(cfg, backend="cuda", device=dev)
    gref = AnalogEngine(cfg, backend="reference", device=dev)
    w1 = torch.randn(N_EXPERTS, D_FF, D_MODEL, generator=gen,
                     device=dev).div_(D_MODEL ** 0.5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    G = geng.program_group(w1, 5)
    torch.cuda.synchronize()
    print(f"[6] programmed {N_EXPERTS} experts' w1 ({D_FF} x {D_MODEL}) as "
          f"one group in {time.perf_counter() - t0:.2f} s; stacks "
          f"{tuple(G.at_pad.shape)}, {G.image_nbytes / 1e9:.3f} GB; peak "
          f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB (A "
          f"{w1.nbytes / gib:.2f} GiB)", flush=True)
    g_, mp, np_ = G.at_pad.shape
    check((g_, mp, np_) == (N_EXPERTS, 16384, D_MODEL),
          "unexpected group stack shape")
    # A group call hands the kernels the live (14,336, 4,096) view of each
    # member (the padding is zeros), so they and the bound read real rows.
    mr = D_FF
    check(not (G.at_pad[:, mr:].any() or G.da_pad[:, mr:].any()),
          "the padding rows of the group stacks are not zero")
    at, da = G.at_pad[:, :mr], G.da_pad[:, :mr]
    for batch in (1, 8):
        x = torch.randn(np_, g_ * batch, generator=gen, device=dev)
        x_t = crossbar._encode_vec(x, cfg, gen=generator(200 + batch, dev))
        y = torch.randn(mr, g_ * batch, generator=gen, device=dev)
        y_t = crossbar._encode_vec(y, cfg, gen=generator(300 + batch, dev))

        def members(u):    # (rows, g * b) panel -> (g, rows, b) for bmm
            return u.view(u.shape[0], g_, batch).permute(1, 0, 2)

        image_bytes = 2 * g_ * mr * np_
        rows[batch]["ec_group_matmul"] = compare(
            f"ec_group_matmul {g_}x{mr}x{np_} batch {batch}",
            lambda: kernels.ec_group_matmul(at, da, x, x_t),
            lambda: kernels.ec_group_matmul_plain(at, da, x, x_t), EC_TOL,
            nbytes=4 * (image_bytes + 2 * np_ * g_ * batch
                        + mr * g_ * batch),
            flops=4 * g_ * mr * np_ * batch, iters=10,
            library_fn=lambda: torch.bmm(at, members(x))
            + torch.bmm(da, members(x_t)))
        rows[batch]["ec_group_rmatmul"] = compare(
            f"ec_group_rmatmul {g_}x{mr}x{np_} batch {batch}",
            lambda: kernels.ec_group_rmatmul(at, da, y, y_t),
            lambda: kernels.ec_group_rmatmul_plain(at, da, y, y_t), EC_TOL,
            nbytes=4 * (image_bytes + 2 * mr * g_ * batch
                        + np_ * g_ * batch),
            flops=4 * g_ * mr * np_ * batch, iters=10,
            library_fn=lambda: torch.bmm(at.transpose(1, 2), members(y))
            + torch.bmm(da.transpose(1, 2), members(y_t)))
        for name in ("ec_group_matmul", "ec_group_rmatmul"):
            rows[batch][name]["shape"] = f"{g_}x{mr}x{np_} (of {mp})"
        for name, query in (("ec_group_matmul", kernels.matmul_layout),
                            ("ec_group_rmatmul", kernels.rmatmul_layout)):
            lay = query(at, da, batch)
            rows[batch][name]["layout"] = lay._asdict()
            print(layout_line(f"{name} batch {batch}", lay), flush=True)
            check(lay.staged, f"{name} did not take the staged kernel on "
                              f"the group's live views")
        # A group of one is the solo call, bit for bit.
        u, u_t = x[:, :batch].contiguous(), x_t[:, :batch].contiguous()
        check(torch.equal(kernels.ec_group_matmul(at[:1], da[:1], u, u_t),
                          kernels.ec_matmul(at[0], da[0], u, u_t)),
              "ec_group_matmul on one member differs from ec_matmul")
        v, v_t = y[:, :batch].contiguous(), y_t[:, :batch].contiguous()
        check(torch.equal(kernels.ec_group_rmatmul(at[:1], da[:1], v, v_t),
                          kernels.ec_rmatmul(at[0], da[0], v, v_t)),
              "ec_group_rmatmul on one member differs from ec_rmatmul")
        del x, x_t, y, y_t, u, u_t, v, v_t
    gx = {b: torch.randn(N_EXPERTS, D_MODEL, b, generator=gen, device=dev)
          for b in (1, 8)}
    gy = {b: torch.randn(N_EXPERTS, D_FF, b, generator=gen, device=dev)
          for b in (1, 8)}
    kernels.reset_launches()
    t0 = time.perf_counter()
    fwd = {b: G @ gx[b] for b in (1, 8)}
    bwd = {b: geng.group_rmvm(G, gy[b]) for b in (1, 8)}
    torch.cuda.synchronize()
    group_s = time.perf_counter() - t0
    group_counts = dict(kernels.LAUNCHES)
    print(f"[6] 2 group_mvm + 2 group_rmvm (batch 1, 8) in "
          f"{group_s * 1e3:.1f} ms; launches {group_counts}", flush=True)
    check(group_counts["ec_group_matmul"] == 2
          and group_counts["ec_group_rmatmul"] == 2
          and group_counts["stencil_denoise"] == 4
          and sum(group_counts.values()) == 8,
          f"a group call is not one grouped EC + one tier-2 launch: "
          f"{group_counts}")
    for b in (1, 8):
        check(tuple(fwd[b].shape) == (N_EXPERTS, D_FF, b)
              and tuple(bwd[b].shape) == (N_EXPERTS, D_MODEL, b)
              and bool(torch.isfinite(fwd[b]).all()
                       & torch.isfinite(bwd[b]).all()),
              "group outputs: wrong shape or non-finite")
    digital = {b: (torch.bmm(w1, gx[b]), torch.bmm(w1.transpose(1, 2), gy[b]))
               for b in (1, 8)}
    ref_out = {b: (gref.group_mvm(G, gx[b]), gref.group_rmvm(G, gy[b]))
               for b in (1, 8)}
    for b in (1, 8):
        errs = [rel_l2(fwd[b], digital[b][0]), rel_l2(bwd[b], digital[b][1]),
                rel_l2(ref_out[b][0], digital[b][0]),
                rel_l2(ref_out[b][1], digital[b][1])]
        print(f"    batch {b}: rel-L2 vs digital bmm: cuda {errs[0]:.4e} "
              f"(A.T: {errs[1]:.4e}), reference {errs[2]:.4e} (A.T: "
              f"{errs[3]:.4e})", flush=True)
        check(max(errs[:2]) < 0.1 and 0.5 < errs[0] / errs[2] < 2.0
              and 0.5 < errs[1] / errs[3] < 2.0,
              "group cuda and reference backends disagree in accuracy")
    # Member g of a group call under key k is its solo execute under
    # fold_in(k, g): the same DAC draw, the same image.  Forward the grouped
    # kernel sums each row as the solo one does (bit for bit); transposed
    # the group's rows are cut otherwise than a member's alone (equal to
    # fp32 rounding).
    same_fwd, solo_err_t = True, 0.0
    out, out_t = geng.group_mvm(G, gx[8], key=7), geng.group_rmvm(G, gy[8],
                                                                key=7)
    for i in range(N_EXPERTS):
        k_i = fold_in(7, i)
        same_fwd &= torch.equal(out[i], geng.mvm(G.member(i), gx[8][i],
                                                 key=k_i))
        solo_err_t = max(solo_err_t, rel_l2(
            out_t[i], geng.rmvm(G.member(i), gy[8][i], key=k_i)))
    print(f"    member g vs solo member(g) under the same key: forward bit "
          f"for bit {same_fwd}, transposed max rel-L2 {solo_err_t:.3e}",
          flush=True)
    check(same_fwd and solo_err_t <= EC_TOL,
          "a group member differs from its solo execute")
    det_err = {}
    for label, gcfg in (("neumann", exact), ("thomas", thomas_cfg)):
        views = [group_view(G, gcfg, be) for be in ("cuda", "reference")]
        t0 = time.perf_counter()
        det = [(h.engine.group_mvm(h, gx[8]), h.engine.group_rmvm(h, gy[8]))
               for h in views]
        torch.cuda.synchronize()
        det_err[label] = (rel_l2(det[0][0], det[1][0]),
                          rel_l2(det[0][1], det[1][1]),
                          time.perf_counter() - t0)
    print(f"    DAC off, cuda vs reference pipeline: rel-L2 "
          f"{det_err['neumann'][0]:.3e} / {det_err['neumann'][1]:.3e} "
          f"(G @ x / G.T @ y); Thomas at lam {STENCIL_CHECK_LAM:g} "
          f"{det_err['thomas'][0]:.3e} / {det_err['thomas'][1]:.3e} (the "
          f"pair took {det_err['thomas'][2]:.1f} s with the reference's "
          f"host-loop Thomas)", flush=True)
    check(max(max(e[:2]) for e in det_err.values()) <= 1e-5,
          "group cuda path disagrees with the reference pipeline")
    group_ms = {}
    for b in (1, 8):
        group_ms[b] = {
            "cuda": call_time_ms(lambda: geng.group_mvm(G, gx[b], key=1), 5),
            "cuda_t": call_time_ms(lambda: geng.group_rmvm(G, gy[b], key=1),
                                   5),
            "reference": call_time_ms(lambda: gref.group_mvm(G, gx[b], key=1),
                                      3),
            "reference_t": call_time_ms(
                lambda: gref.group_rmvm(G, gy[b], key=1), 3)}
        print(f"    per group call, batch {b}: cuda {group_ms[b]['cuda']:.3f}"
              f" ms (G.T: {group_ms[b]['cuda_t']:.3f} ms), reference "
              f"{group_ms[b]['reference']:.3f} ms (G.T: "
              f"{group_ms[b]['reference_t']:.3f} ms)", flush=True)
    for name in ("ec_group_matmul", "ec_group_rmatmul"):
        for b in (1, 8):
            rows[b][name]["group_call_ms"] = \
                group_ms[b]["cuda_t" if "rmatmul" in name else "cuda"]
    del G, w1, at, da, fwd, bwd, digital, ref_out, det, views, gx, gy, out, \
        out_t
    torch.cuda.empty_cache()

    # ------------------------ 6c. 32 chained 4,096^2 layers (main, chain_mvm)
    layers = torch.randn(N_LAYERS, D_MODEL, D_MODEL, generator=gen,
                         device=dev).mul_((2.0 / D_MODEL) ** 0.5)
    t0 = time.perf_counter()
    C = geng.program_group(layers, 6)
    torch.cuda.synchronize()
    print(f"[6c] programmed {N_LAYERS} layers of {D_MODEL}^2 in "
          f"{time.perf_counter() - t0:.2f} s ({C.image_nbytes / 1e9:.3f} GB)",
          flush=True)
    h = torch.randn(D_MODEL, 1, generator=gen, device=dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    chained = geng.chain_mvm(C, h, activation="relu")
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    chain_counts = dict(kernels.LAUNCHES)
    want = h
    for g in range(N_LAYERS):
        want = torch.relu(torch.matmul(layers[g], want))
    chain_ref = gref.chain_mvm(C, h, activation="relu")
    views = [group_view(C, exact, be) for be in ("cuda", "reference")]
    det = [v.engine.chain_mvm(v, h, activation="relu", key=3) for v in views]
    chain_det = rel_l2(det[0], det[1])
    chain_ms = {"cuda": call_time_ms(
        lambda: geng.chain_mvm(C, h, activation="relu", key=1), 3),
        "reference": call_time_ms(
        lambda: gref.chain_mvm(C, h, activation="relu", key=1), 3)}
    print(f"[6c] chain of {N_LAYERS} (relu, batch 1): {chain_s * 1e3:.1f} ms "
          f"cold, {chain_ms['cuda']:.3f} ms per chain warm (reference "
          f"{chain_ms['reference']:.3f} ms); launches {chain_counts}; rel-L2 "
          f"vs digital: cuda {rel_l2(chained, want):.4e}, reference "
          f"{rel_l2(chain_ref, want):.4e}; DAC off cuda vs reference "
          f"{chain_det:.3e}; bound {bound_ms(N_LAYERS * 2 * 4 * D_MODEL ** 2, 0)[0]:.3f} ms",
          flush=True)
    check(bool(torch.isfinite(chained).all())
          and tuple(chained.shape) == (D_MODEL, 1), "chain output")
    check(chain_counts["ec_matmul"] == N_LAYERS,
          f"chain did not run one ec_matmul per layer: {chain_counts}")
    check(chain_det <= CHAIN_TOL,
          "chain cuda path disagrees with the reference pipeline")
    del C, layers, chained, chain_ref, want, views, det
    torch.cuda.empty_cache()

    # ------------------------- 7. single-pass encode (main, rram_encode_matmul)
    taox = get_device("taox-hfox")
    sigma = effective_sigma_py(taox, cfg.k_iters)
    m, k, n = ENCODE_ROWS, D_MODEL, D_FF
    x = torch.randn(m, k, generator=gen, device=dev)
    wt = torch.randn(k, n, generator=gen, device=dev).div_(k ** 0.5)
    eps = torch.randn(k, n, generator=gen, device=dev)
    kw = dict(sigma=sigma, levels=taox.levels)
    kernels.reset_launches()
    y = kernels.rram_encode_matmul(x, wt, eps, **kw)
    y_rng = kernels.encode_matmul_rng(ENCODE_SEED, x, wt, **kw)
    torch.cuda.synchronize()
    encode_counts = dict(kernels.LAUNCHES)
    check(encode_counts["encode_matmul"] == 1
          and encode_counts["encode_matmul_rng"] == 1,
          f"the encode entry points did not launch their kernels: "
          f"{encode_counts}")
    check(tuple(y.shape) == (m, n) and bool(torch.isfinite(y).all()
                                           & torch.isfinite(y_rng).all()),
          "encode outputs: wrong shape or non-finite")
    tiles = dict(block_k=512, block_n=512)
    q = kernels.quantize_tile_plain(wt, taox.levels, 512, 512)
    w_tilde = q * (1.0 + sigma * eps)
    print(f"[7] x {m}x{k} @ encode(W {k}x{n}), 512^2 tiles, levels "
          f"{taox.levels}, sigma {sigma:.4g}; rel-L2 vs digital x @ W "
          f"{rel_l2(y, torch.matmul(x, wt)):.4e}; launches {encode_counts}",
          flush=True)
    rows[1]["encode_matmul"] = compare(
        f"encode_matmul {m}x{k}x{n}",
        lambda: kernels.encode_matmul(x, wt, eps, **kw, **tiles),
        lambda: kernels.encode_matmul_plain(x, wt, eps, sigma, taox.levels,
                                            512, 512), EC_TOL,
        nbytes=4 * (m * k + 2 * k * n + m * n), flops=2 * m * k * n, iters=5,
        library_fn=lambda: torch.matmul(x, w_tilde))
    del w_tilde
    w_rng = q * (1.0 + sigma * kernels.philox_normal_plain(
        ENCODE_SEED, k, n, 512, 512, dev))
    rows[1]["encode_matmul_rng"] = compare(
        f"encode_matmul_rng {m}x{k}x{n}",
        lambda: kernels.encode_matmul_rng(ENCODE_SEED, x, wt, **kw, **tiles),
        lambda: kernels.encode_matmul_rng_plain(ENCODE_SEED, x, wt, **kw,
                                                **tiles), EC_TOL,
        nbytes=4 * (m * k + k * n + m * n), flops=2 * m * k * n, iters=5,
        plain_iters=1, plain_warmup=1,
        library_fn=lambda: torch.matmul(x, w_rng))
    # What holds the product back: registers and spills (ptxas), the SM clock
    # and power while it runs (the fp32 bound assumes the 1.98 GHz boost
    # clock), the rate reached and the share of each CUDA kernel in a call.
    # encode_matmul_rng's second bound counts the generator's instructions
    # on the FMAs' issue slots.
    flops = 2.0 * m * k * n
    timed = {"encode_matmul": lambda: kernels.encode_matmul(x, wt, eps, **kw,
                                                            **tiles),
             "encode_matmul_rng": lambda: kernels.encode_matmul_rng(
                 ENCODE_SEED, x, wt, **kw, **tiles)}
    for name, fn in timed.items():
        row = rows[1][name]
        row["shape"] = f"{m}x{k}x{n}"
        instance = "true" if name.endswith("rng") else "false"
        row["ptxas"] = ptxas.get(f"encode_matmul_kernel<{instance}>")
        mhz, watts, samples = clock_under_load(fn)
        row.update(sm_mhz=mhz, watts=watts, tflops=flops / row["ms"] / 1e9,
                   split_ms=kernel_split(fn))
        print(f"    {name}: {row['tflops']:.2f} TFLOP/s "
              f"({row['tflops'] / (FP32_FLOPS_PER_S / 1e12):.1%} of fp32 "
              f"peak) at SM {mhz} MHz, {watts} W ({samples} nvidia-smi "
              f"samples); ptxas {row['ptxas']}; per call "
              + ", ".join(f"{short_kernel_name(key)} {ms:.4f} ms"
                          for key, ms in row["split_ms"].items()), flush=True)
    gen_ms = (k * n * GEN_INSTRUCTIONS_PER_DRAW
              / (FP32_FLOPS_PER_S / 2) * 1e3)
    rows[1]["encode_matmul_rng"].update(
        bound_gen_ms=rows[1]["encode_matmul_rng"]["bound_ms"] + gen_ms,
        bound_gen_by=f"operations + generator ({GEN_INSTRUCTIONS_PER_DRAW} "
                     f"instructions a draw, counted from the source)")
    print(f"    encode_matmul_rng bound with the generator: "
          f"{rows[1]['encode_matmul_rng']['bound_gen_ms']:.4f} ms "
          f"({gen_ms:.4f} ms of it for {k * n} draws)", flush=True)
    zero = dict(kw, sigma=0.0)
    same_zero = torch.equal(
        kernels.encode_matmul_rng(ENCODE_SEED, x, wt, **zero),
        kernels.encode_matmul(x, wt, torch.zeros_like(wt), **zero))
    same_run = torch.equal(y_rng, kernels.encode_matmul_rng(ENCODE_SEED, x,
                                                            wt, **kw))
    # W of ones quantizes to ones, so eye @ encode(W) = 1 + sigma * eta
    # (64 rows of x: the 256-row output tile masks the rest).
    eye, ones = torch.eye(64, device=dev), torch.ones(64, 32768, device=dev)
    eta = (kernels.encode_matmul_rng(ENCODE_SEED, eye, ones, sigma=0.5,
                                     levels=taox.levels) - 1.0) / 0.5
    moments = (float(eta.mean()), float(eta.var()))
    print(f"    rng kernel: sigma = 0 equals encode_matmul with zero eps: "
          f"{same_zero}; bit for bit run to run: {same_run}; {eta.numel()} "
          f"draws read back: mean {moments[0]:.2e}, variance "
          f"{moments[1]:.4f}", flush=True)
    check(same_zero and same_run, "encode_matmul_rng is not deterministic "
                                  "or not encode_matmul at sigma = 0")
    check(abs(moments[0]) <= 0.01 and abs(moments[1] - 1.0) <= 0.02,
          "encode_matmul_rng's draws are not standard normal")
    del x, wt, eps, q, w_rng, y, y_rng, eta, eye, ones
    torch.cuda.synchronize()

    # ---------------------------------------------------------- report
    sources = {
        "ec_matmul": ("src/repro_torch/kernels/csrc/rram_mvm.cu",
                      "src/repro/kernels/rram_mvm.py:236"),
        # The same pallas_call read backwards by the JAX engine.
        "ec_rmatmul": ("src/repro_torch/kernels/csrc/rram_mvm.cu",
                       "src/repro/engine.py:613"),
        "stencil_denoise": ("src/repro_torch/kernels/csrc/tridiag.cu",
                            "src/repro/kernels/tridiag.py:108"),
        "thomas_solve": ("src/repro_torch/kernels/csrc/tridiag.cu",
                         "src/repro/kernels/tridiag.py:54"),
        "cg_update": ("src/repro_torch/kernels/csrc/solver_update.cu",
                      "src/repro/kernels/solver_update.py:83"),
        "richardson_update": ("src/repro_torch/kernels/csrc/solver_update.cu",
                              "src/repro/kernels/solver_update.py:46"),
        # The grouped wrappers reach the pallas_call of ec_matmul per member.
        "ec_group_matmul": ("src/repro_torch/kernels/csrc/rram_mvm.cu",
                            "src/repro/kernels/ops.py:150"),
        "ec_group_rmatmul": ("src/repro_torch/kernels/csrc/rram_mvm.cu",
                             "src/repro/kernels/ops.py:174"),
        "encode_matmul": ("src/repro_torch/kernels/csrc/encode_matmul.cu",
                          "src/repro/kernels/rram_mvm.py:79"),
        "encode_matmul_rng": ("src/repro_torch/kernels/csrc/encode_matmul.cu",
                              "src/repro/kernels/rram_mvm.py:166"),
    }
    table = []
    for name, (source, replaces) in sources.items():
        launches = sum(counts[name] for counts in
                       (served, served_t, solve_counts, lstsq_counts,
                        lp_counts, group_counts, chain_counts,
                        encode_counts))
        check(launches > 0, f"{name} was not launched on the main path")
        row = rows[1][name]
        table.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "rel_l2": row["rel_l2"],
            **{k: row[k] for k in ("err_lam", "ms_lam", "chain_ms", "shape",
                                   "layout", "group_call_ms", "ptxas",
                                   "sm_mhz", "watts", "tflops", "split_ms",
                                   "bound_gen_ms", "bound_gen_by")
               if k in row},
            "ms": row["ms"],
            "call_ms": row["call_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "batch": 1,
            "batch8": ({k: rows[8][name][k] for k in
                        ("ms", "call_ms", "plain_ms", "bound_ms",
                         "library_ms", "group_call_ms", "layout")
                        if k in rows[8][name]}
                       if name in rows[8] else None),
            # The phase-5 images: other M, K and layouts, batch 1.
            "shapes": [res[name] for res in more_shapes if name in res],
        })
    print(f"total wall time {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
