#!/usr/bin/env python3
"""Probe the port's reliability path outside chip_smoke.py.

    python3 reliability_probe.py seeds [--count 20] [--torch-device cuda]
    python3 reliability_probe.py lp-floor [--m 4096 --n 8192 --cell 512]
    python3 reliability_probe.py rehearse [--n 4096]

``seeds`` runs examples/meliso_reliability_torch.py's lifetime act (ag-si,
n = 256, 2 x 2 MCAs of 32^2, aged to about 8 latched cells) over matrix
seeds 0..count-1 and prints, per seed, the fresh and aged digital
residuals, the cells the age changed and how many of them lie in diagonal
blocks, and how often the example's ``aged > fresh`` assert holds.  The
fault set is a function of the handle's key and the device's generator,
not of the matrix, so every seed sees the same faults on one device.

``lp-floor`` runs ``ft_pdhg`` at digital KKT tolerance 1e-3 on
``random_feasible_lp(0, m, n)`` (epiram, 8 x 8 MCAs of cell^2, the
``cuda`` backend) and prints the digital KKT residual of every accepted
segment: where the analog iterate's digital KKT stalls.

``rehearse`` runs chip_smoke.py's phase 11 (``reliability_phase``) on the
CPU at n^2 (8 x 8 MCAs of (n / 64)^2, the LP n/2 x n, the group 8 x 7n/16
x n/8) with ``torch.cuda``'s synchronise and memory calls and the
profiler split stubbed and the ``kernels.*`` wrappers counting their
calls: its checks and launch counts, without a GPU (the phase's times are
then the CPU's, not device numbers).

``--torch-device`` defaults to ``cuda`` for ``seeds`` and ``lp-floor``
(an error without a GPU; pass ``cpu`` to run there); ``rehearse`` always
runs on the CPU.
"""
import argparse
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


def seeds(args, dev) -> None:
    from repro_torch.core import CrossbarConfig, MCAGeometry, get_device
    from repro_torch.core.prng import fold_in
    from repro_torch.engine import AnalogEngine
    from repro_torch.reliability import aged_blocks, attach_age
    from repro_torch.solvers import cg
    n, fdev = 256, get_device("ag-si")
    cfg = CrossbarConfig(device=fdev, geom=MCAGeometry(2, 2, 32, 32),
                         k_iters=5, ec=True)
    mvms = max(1, int(8.0 / (fdev.fault_rate * n * n)))
    held = 0
    for seed in range(args.count):
        gen = torch.Generator(device=dev).manual_seed(seed)
        r = torch.randn(n, n, generator=gen, device=dev) / n
        a = r + r.T + 2.0 * torch.eye(n, device=dev)
        b = a @ torch.randn(n, generator=gen, device=dev)
        A = AnalogEngine(cfg, device=dev).program(a, fold_in(0, 7))
        attach_age(A)

        def rel(salt):
            res = cg(A, b, tol=1e-6, maxiter=120, key=fold_in(0, salt))
            return float(torch.linalg.vector_norm(b - a @ res.x)
                         / torch.linalg.vector_norm(b))

        fresh = rel(11)
        A.age = A.age.advanced(mvms)
        moved = aged_blocks(A.at_blocks, A.age, fdev) != A.at_blocks
        diag = sum(int(moved[i, i].sum()) for i in range(moved.shape[0]))
        aged = rel(11)          # the fresh solve's DAC key, as the example
        held += aged > fresh
        print(f"seed {seed:3d}: fresh {fresh:.4e} aged {aged:.4e} "
              f"cells changed {int(moved.sum())} (diagonal blocks {diag}) "
              f"aged > fresh {aged > fresh}", flush=True)
    print(f"aged > fresh on {held} of {args.count} seeds ({dev}, {mvms} "
          f"MVMs)")


def lp_floor(args, dev) -> None:
    from repro_torch.core import CrossbarConfig, MCAGeometry, get_device
    from repro_torch.engine import AnalogEngine
    from repro_torch.reliability import ft_pdhg
    from repro_torch.solvers import random_feasible_lp
    cfg = CrossbarConfig(device=get_device("epiram"),
                         geom=MCAGeometry(8, 8, args.cell, args.cell))
    a, b, c, _, _ = random_feasible_lp(0, args.m, args.n, device=dev)
    L = AnalogEngine(cfg, backend="cuda", device=dev).program(a, 4)
    t0 = time.perf_counter()
    res = ft_pdhg(L, b, c, tol=1e-3, maxiter=5000, segment=200, key=12)
    print(f"ft_pdhg {args.m}x{args.n} ({args.cell}^2 MCAs, {dev}) at tol "
          f"1e-3: converged={res.converged}, {res.iterations} accepted "
          f"segments, {res.ledger.mvms} MVMs, digital KKT a segment "
          + ", ".join(f"{float(v):.4e}" for v in res.residuals.flatten())
          + f"; {time.perf_counter() - t0:.1f} s")


def rehearse(args) -> None:
    from repro_torch import kernels
    from repro_torch.core import MCAGeometry
    from repro_torch.kernels import build
    for name in list(build.LAUNCHES):
        def counted(*a, _run=getattr(kernels, name), _name=name, **kw):
            build.LAUNCHES[_name] += 1
            return _run(*a, **kw)
        setattr(kernels, name, counted)
    for stub in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        setattr(torch.cuda, stub, lambda *a, **k: None)
    torch.cuda.memory_allocated = lambda *a, **k: 0
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    chip_smoke.kernel_split = lambda fn, iters=5: {}   # no device trace here
    n, dev = args.n, torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    t0 = time.perf_counter()
    counts = chip_smoke.reliability_phase(
        dev, gen, n=n, geom=MCAGeometry(8, 8, n // 64, n // 64),
        lp_shape=(n // 2, n), d_ff=n * 7 // 16, d_model=n // 8)
    print(f"rehearsal at {n}^2 on the CPU passed in "
          f"{time.perf_counter() - t0:.1f} s; calls "
          f"{ {k: v for k, v in counts.items() if v} }")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("seeds", "lp-floor", "rehearse"))
    ap.add_argument("--count", type=int, default=20)
    ap.add_argument("--m", type=int, default=4096)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--cell", type=int, default=512)
    ap.add_argument("--torch-device", default="cuda")
    args = ap.parse_args(argv)
    if args.what == "rehearse":
        args.n = args.n or 4096
        rehearse(args)
        return 0
    dev = torch.device(args.torch_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("reliability_probe: no CUDA device (torch.cuda.is_available() "
              "is False); pass --torch-device cpu to run on the CPU",
              file=sys.stderr)
        return 1
    if args.what == "seeds":
        seeds(args, dev)
    else:
        args.n = args.n or 8192
        lp_floor(args, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
