"""Box-constrained portfolio selection on ONE programmed crossbar image
(linearized ADMM) through the PyTorch/CUDA port (the twin of
examples/meliso_portfolio.py).

A factor-model mean-variance portfolio:

    min_x  (1/2)||F x||^2 - lam * mu'x    s.t.  0 <= x <= cap

where ``F`` is the (k, n) factor-loading matrix (so ``F'F`` is the
low-rank risk model), ``mu`` the expected returns, and the box keeps every
position long and capped.  This is the :func:`repro_torch.solvers.admm`
form ``min (1/2)||Ax - b||^2 + q'x`` with ``b = 0`` and ``q = -lam * mu``:
the loadings are programmed ONCE and every ADMM iteration is one corrected
forward MVM (``F x``, the factor exposures) plus one corrected TRANSPOSED
MVM (``F'u``, the risk gradient) against the same image, plus a handful of
power-iteration MVMs up front to size the linearized step, all billed to
the ledger.

The digital oracle is the same algorithm on the exact operator; the
acceptance metric is the relative objective gap.  ``--device`` names the
RRAM device, as in the JAX example; ``--torch-device`` says where the
tensors live: ``cuda`` (the default, an error where there is no GPU) or
``cpu``, only when asked for.  The image runs on the ``cuda`` backend: the
hand-written kernels on the GPU, their plain versions on the CPU.

    PYTHONPATH=src python examples/meliso_portfolio_torch.py
    PYTHONPATH=src python examples/meliso_portfolio_torch.py --assets 192 --cap 0.1
    PYTHONPATH=src python examples/meliso_portfolio_torch.py --device taox-hfox
    PYTHONPATH=src python examples/meliso_portfolio_torch.py --torch-device cpu
"""
import argparse
import math
import sys

import torch

from repro_torch import solvers
from repro_torch.core import CrossbarConfig, MCAGeometry, get_device, rel_l2
from repro_torch.engine import AnalogEngine


def objective(f, q, x) -> float:
    return float(0.5 * torch.sum((f @ x) ** 2) + q @ x)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--assets", type=int, default=96, help="universe size n")
    ap.add_argument("--factors", type=int, default=32,
                    help="risk factors k (rows of F)")
    ap.add_argument("--cap", type=float, default=0.08,
                    help="per-position upper bound")
    ap.add_argument("--lam", type=float, default=0.5,
                    help="return-seeking weight on mu'x")
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--maxiter", type=int, default=2000)
    ap.add_argument("--device", default="epiram")
    ap.add_argument("--cell", type=int, default=32)
    ap.add_argument("--torch-device", default="cuda",
                    help="where the image and the solves live (default cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.torch_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("meliso_portfolio_torch: no CUDA device "
                 "(torch.cuda.is_available() is False); pass --torch-device "
                 "cpu to run on the CPU")

    n, k = args.assets, args.factors
    gen = torch.Generator(device=dev).manual_seed(0)
    f = torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)
    mu = 0.05 + 0.02 * torch.randn(n, generator=gen, device=dev)
    b = torch.zeros(k, device=dev)
    q = -args.lam * mu
    lo, hi = torch.zeros(n, device=dev), torch.full((n,), args.cap,
                                                    device=dev)

    geom = MCAGeometry(tile_rows=1, tile_cols=1,
                       cell_rows=args.cell, cell_cols=args.cell)
    cfg = CrossbarConfig(device=get_device(args.device), geom=geom,
                         k_iters=5, ec=True)
    engine = AnalogEngine(cfg, backend="cuda", device=dev)
    F = engine.program(f, 2)                   # programmed ONCE

    print(f"portfolio: {n} assets, {k} factors, box [0, {args.cap}], "
          f"device={args.device}, torch_device={dev}")
    print(f"one-time write energy = {F.write_stats.energy_j:.3e} J\n")

    digital = solvers.admm(f, b, q, lo=lo, hi=hi, tol=args.tol,
                           maxiter=args.maxiter)
    analog = solvers.admm(F, b, q, lo=lo, hi=hi, tol=args.tol,
                          maxiter=args.maxiter, key=2)

    print(f"{'solver':16s} {'iters':>6s} {'kkt':>9s} {'objective':>11s} "
          f"{'gross':>7s} {'at cap':>6s} {'E_iters J':>10s}")
    for tag, res in (("admm digital", digital), ("admm analog", analog)):
        w = torch.clamp(res.x, 0.0, args.cap)
        at_cap = int(torch.sum(w >= args.cap - 1e-6))
        print(f"{tag:16s} {res.iterations:6d} {res.final_residual:9.2e} "
              f"{objective(f, q, res.x):11.6f} {float(torch.sum(w)):7.3f} "
              f"{at_cap:6d} {res.ledger.iteration_energy_j:10.3e}")

    assert digital.converged and analog.converged
    obj_d, obj_a = objective(f, q, digital.x), objective(f, q, analog.x)
    obj_gap = abs(obj_a - obj_d) / (1 + abs(obj_d))
    assert obj_gap <= 1e-3, (obj_a, obj_d)
    # The split copy (res.dual) is the box-feasible iterate.
    assert float(torch.min(analog.dual)) >= -1e-6
    assert float(torch.max(analog.dual)) <= args.cap + 1e-6
    w_gap = float(rel_l2(analog.x, digital.x))

    led = analog.ledger
    print(f"\nledger: {led.mvms + led.mvms_single} forward + "
          f"{led.mvms_t + led.mvms_single_t} transposed MVMs (incl. the "
          f"power-iteration step sizing) against one programmed image, "
          f"write {led.write_energy_j:.3e} J")
    print(f"analog objective within {obj_gap:.1e} of the digital oracle, "
          f"weights within {w_gap:.1e}")


if __name__ == "__main__":
    main()
