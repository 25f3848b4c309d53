"""Distributed MELISO+ solve through the PyTorch/CUDA port's solvers (the
twin of examples/meliso_solver.py).

A diagonally dominant SPD matrix is programmed ONCE across a mesh of ranks
(rows over 'data', the contraction over 'model'; each rank keeps its window
of the conductance image), then reused by matvec-only iterative solvers:

  * the fixed-omega Richardson loop (omega = 1/3) as the baseline;
  * Richardson with auto-omega from a matvec-only power-iteration spectral
    estimate;
  * conjugate gradients.

Every solver iteration re-executes against the SAME programmed image --
tier-1 EC on each rank's window, the partials summed over the contraction
axis, tier-2 on each row segment -- so the one-time write cost amortizes
across the whole solve, and each ``SolveResult`` ledger splits energy into
the one-time programming cost and the per-iteration input-write cost.

``--mesh R,C`` picks the placement (R row shards x C contraction shards,
default 2,4 as in the JAX example; ``1,1`` is draw-identical to the
streamed engine with ``--producer``).  Every rank of the mesh lives on the
one ``--torch-device``.  ``--producer`` programs through a ``block_fn(i,
j)`` producer instead of the dense array: each rank programs only its
window of the global block grid (here the producer reads the dense copy
kept for the ground truth, so this shows the producer-driven path, not the
memory saving of a procedural producer).  ``--device`` names the RRAM
device, as in the JAX example; ``--torch-device`` says where the tensors
live: ``cuda`` (the default, an error where there is no GPU) or ``cpu``,
only when asked for.  The image and the solvers run on the ``cuda``
backend: the hand-written kernels on the GPU, their plain versions on the
CPU.

    PYTHONPATH=src python examples/meliso_solver_torch.py
    PYTHONPATH=src python examples/meliso_solver_torch.py --n 2048 --tol 1e-3
    PYTHONPATH=src python examples/meliso_solver_torch.py --mesh 4,2 --producer
    PYTHONPATH=src python examples/meliso_solver_torch.py --torch-device cpu --n 1024
"""
import argparse
import sys

import torch

from repro_torch import solvers
from repro_torch.core import CrossbarConfig, MCAGeometry, get_device, rel_l2
from repro_torch.engine import AnalogEngine
from repro_torch.launch import make_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--tol", type=float, default=1e-3,
                    help="relative-residual stopping tolerance")
    ap.add_argument("--maxiter", type=int, default=50)
    # epiram (64 levels) by default: the 8-level devices' quantization noise
    # floor caps the corrected solve around ~5e-3 relative error, while the
    # precision device reaches <= 1e-3.
    ap.add_argument("--device", default="epiram")
    ap.add_argument("--cell", type=int, default=256)
    ap.add_argument("--no-ec", action="store_true")
    ap.add_argument("--mesh", default="2,4", metavar="R,C",
                    help="mesh shape: R row shards x C contraction shards")
    ap.add_argument("--producer", action="store_true",
                    help="program from a block_fn(i, j) producer, each rank "
                         "its window (here over the dense copy kept for the "
                         "ground truth)")
    ap.add_argument("--torch-device", default="cuda",
                    help="where images and solves live (default cuda)")
    args = ap.parse_args(argv)
    try:
        rows, cols = (int(v) for v in args.mesh.split(","))
    except ValueError:
        sys.exit(f"--mesh must be 'R,C' integers, got {args.mesh!r}")
    dev = torch.device(args.torch_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("meliso_solver_torch: no CUDA device "
                 "(torch.cuda.is_available() is False); pass --torch-device "
                 "cpu to run on the CPU")
    mesh = make_mesh((rows, cols), ("data", "model"), device=dev)

    n = args.n
    gen = torch.Generator(device=dev).manual_seed(0)
    # Diagonally dominant SPD system (spectrum ~2 +- O(1/sqrt(n))).
    r = torch.randn(n, n, generator=gen, device=dev) / n
    a = r + r.T + 2.0 * torch.eye(n, device=dev)
    x_true = torch.randn(n, generator=gen, device=dev)
    b = a @ x_true

    # One rank's window sets the MCA count, as in the JAX example.
    local = (n // rows, n // cols)
    geom = MCAGeometry(tile_rows=max(local[0] // args.cell, 1),
                       tile_cols=max(local[1] // args.cell, 1),
                       cell_rows=args.cell, cell_cols=args.cell)
    cfg = CrossbarConfig(device=get_device(args.device), geom=geom,
                         k_iters=5, ec=not args.no_ec)
    engine = AnalogEngine(cfg, execution="distributed", backend="cuda",
                          mesh=mesh)
    if args.producer:
        cap_m, cap_n = geom.capacity
        mb, nb = -(-n // cap_m), -(-n // cap_n)
        a_pad = torch.zeros(mb * cap_m, nb * cap_n, device=dev)
        a_pad[:n, :n] = a
        blocks = a_pad.view(mb, cap_m, nb, cap_n).permute(0, 2, 1, 3)
        A = engine.program(lambda i, j: blocks[i, j], 0,
                           shape=(n, n))       # programmed ONCE, per window
    else:
        A = engine.program(a, 0)               # programmed ONCE
    print(f"n={n} device={args.device} ec={not args.no_ec} "
          f"placement={engine.execution} mesh={rows}x{cols} "
          f"producer={args.producer} torch_device={dev}")
    print(f"one-time write energy (mean over ranks) = "
          f"{A.write_stats.energy_j:.3e} J, "
          f"latency = {A.write_stats.latency_s:.4f} s\n")

    # The analog noise floor of ONE corrected MVM: a tighter --tol than this
    # is unreachable on this device / EC configuration.
    noise_floor = float(rel_l2(A @ x_true, b))
    below_floor = args.tol < noise_floor
    if below_floor:
        print(f"WARNING: --tol {args.tol:.1e} is below the analog noise "
              f"floor ~{noise_floor:.1e} of this configuration; solvers will "
              "stall at the floor (use repro_torch.solvers.refine to "
              "converge below it).  Reporting achieved residuals instead of "
              "asserting convergence.\n")

    kw = dict(tol=args.tol, maxiter=args.maxiter, backend="cuda")
    runs = [
        ("richardson omega=1/3 (old loop)",
         lambda: solvers.richardson(A, b, omega=1.0 / 3.0, **kw)),
        ("richardson auto-omega", lambda: solvers.richardson(A, b, **kw)),
        ("cg", lambda: solvers.cg(A, b, **kw)),
    ]
    # The convergence asserts hold for the default precision configuration;
    # the 8-level devices, --no-ec and a below-floor --tol are
    # demonstrations, not expected to reach --tol.
    check = args.device == "epiram" and not args.no_ec and not below_floor
    print(f"{'solver':34s} {'iters':>5s} {'resid':>9s} {'x err':>9s} "
          f"{'E_write J':>10s} {'E_iters J':>10s}")
    baseline_iters = None
    for name, run in runs:
        res = run()
        err = float(rel_l2(res.x, x_true))
        led = res.ledger
        print(f"{name:34s} {res.iterations:5d} {res.final_residual:9.2e} "
              f"{err:9.2e} {led.write_energy_j:10.3e} "
              f"{led.iteration_energy_j:10.3e}")
        if baseline_iters is None:
            baseline_iters = res.iterations
        elif check:
            assert res.iterations < baseline_iters, \
                (name, res.iterations, baseline_iters)
            assert err <= args.tol, (name, err)
        assert led.write_energy_j > 0 and led.iteration_energy_j > 0
    if below_floor:
        print(f"\nnoise floor ~{noise_floor:.1e} (requested tol "
              f"{args.tol:.1e} not reachable without refinement)")

    print("\nper-MVM input-write energy = "
          f"{A.input_write_stats(batch=1).energy_j:.3e} J "
          "(amortized against one programmed image)")


if __name__ == "__main__":
    main()
