"""Linear programming on ONE programmed crossbar image (PDHG) through the
PyTorch/CUDA port (the twin of examples/meliso_lp.py).

The companion RRAM-PDHG paper's regime: a standard-form LP

    min c'x   s.t.   A x = b,  x >= 0

is solved by the primal-dual hybrid gradient method, which touches the
constraint matrix only through ``A @ x`` and ``A.T @ y``.  Both directions
read the SAME conductance image -- the matrix is programmed exactly once and
every PDHG iteration (one corrected forward MVM + one corrected TRANSPOSED
MVM) amortizes that write, with forward and transposed input-write costs
billed separately in the :class:`~repro_torch.solvers.SolveLedger`.

The LP is generated with a KNOWN optimal primal-dual pair
(:func:`repro_torch.solvers.random_feasible_lp`), so the example reports
the true objective gap of both the digital PDHG oracle and the analog
solve.

``--mesh R,C`` distributes the solve: the image is cut over an R x C mesh
of ranks (all on the one ``--torch-device``), the forward MVM sums its
partials over the contraction columns and the transposed one over the
rows, each output segment denoised on its own; ``1,1`` (the default)
programs one local image, as the JAX example does.  ``--producer``
programs a distributed image through a ``block_fn(i, j)`` producer instead
of the dense array.  ``--device`` names the RRAM device; ``--torch-device``
says where the tensors live: ``cuda`` (the default, an error where there is
no GPU) or ``cpu``, only when asked for.  The image runs on the ``cuda``
backend: the hand-written kernels on the GPU, their plain versions on the
CPU.

    PYTHONPATH=src python examples/meliso_lp_torch.py
    PYTHONPATH=src python examples/meliso_lp_torch.py --n 1024 --m 768
    PYTHONPATH=src python examples/meliso_lp_torch.py --mesh 2,4 --producer
    PYTHONPATH=src python examples/meliso_lp_torch.py --torch-device cpu
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
    ap.add_argument("--m", type=int, default=256, help="LP constraints (rows)")
    ap.add_argument("--n", type=int, default=512, help="LP variables (cols)")
    ap.add_argument("--tol", type=float, default=2e-4,
                    help="KKT-residual stopping tolerance")
    ap.add_argument("--maxiter", type=int, default=20000)
    ap.add_argument("--device", default="epiram")
    ap.add_argument("--cell", type=int, default=64)
    ap.add_argument("--mesh", default="1,1", metavar="R,C",
                    help="mesh shape (1,1 = one local image)")
    ap.add_argument("--producer", action="store_true",
                    help="program a distributed image through a block "
                         "producer, each rank its window")
    ap.add_argument("--torch-device", default="cuda",
                    help="where the image and the solves live (default cuda)")
    args = ap.parse_args(argv)
    try:
        rows, cols = (int(v) for v in args.mesh.split(","))
    except ValueError:
        sys.exit(f"--mesh must be 'R,C' integers, got {args.mesh!r}")
    dev = torch.device(args.torch_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("meliso_lp_torch: no CUDA device "
                 "(torch.cuda.is_available() is False); pass --torch-device "
                 "cpu to run on the CPU")

    a, b, c, x_star, y_star = solvers.random_feasible_lp(0, args.m, args.n,
                                                         device=dev)
    obj_star = float(c @ x_star)

    geom = MCAGeometry(tile_rows=1, tile_cols=1,
                       cell_rows=args.cell, cell_cols=args.cell)
    cfg = CrossbarConfig(device=get_device(args.device), geom=geom,
                         k_iters=5, ec=True)
    if rows * cols == 1:
        engine = AnalogEngine(cfg, backend="cuda", device=dev)
        A = engine.program(a, 0)
    else:
        engine = AnalogEngine(cfg, execution="distributed", backend="cuda",
                              mesh=make_mesh((rows, cols), ("data", "model"),
                                             device=dev))
        if args.producer:
            cap_m, cap_n = cfg.geom.capacity
            mb, nb = -(-args.m // cap_m), -(-args.n // cap_n)
            a_pad = torch.zeros(mb * cap_m, nb * cap_n, device=dev)
            a_pad[:args.m, :args.n] = a
            blocks = a_pad.view(mb, cap_m, nb, cap_n).permute(0, 2, 1, 3)
            A = engine.program(lambda i, j: blocks[i, j], 0,
                               shape=tuple(a.shape))
        else:
            A = engine.program(a, 0)

    print(f"LP: {args.m} constraints x {args.n} vars, device={args.device}, "
          f"mesh={args.mesh}, producer={args.producer}, "
          f"placement={engine.execution}, torch_device={dev}")
    print(f"known optimum c'x* = {obj_star:.6f} (= b'y* = "
          f"{float(b @ y_star):.6f})")
    print(f"one-time write energy = {A.write_stats.energy_j:.3e} J\n")

    # Oracle: the same algorithm on the exact digital operator, run to the
    # same tolerance (PDHG is O(1/k); a much tighter digital tol would just
    # burn iterations without changing the comparison).
    kw = dict(tol=args.tol, maxiter=args.maxiter)
    digital = solvers.pdhg(a, b, c, **kw)
    analog = solvers.pdhg(A, b, c, key=0, **kw)

    print(f"{'solver':20s} {'iters':>6s} {'kkt':>9s} {'objective':>11s} "
          f"{'gap to *':>9s} {'E_write J':>10s} {'E_iters J':>10s}")
    for name, res in (("pdhg digital", digital), ("pdhg analog", analog)):
        obj = float(c @ res.x)
        gap = abs(obj - obj_star) / (1 + abs(obj_star))
        led = res.ledger
        print(f"{name:20s} {res.iterations:6d} {res.final_residual:9.2e} "
              f"{obj:11.6f} {gap:9.2e} {led.write_energy_j:10.3e} "
              f"{led.iteration_energy_j:10.3e}")

    obj_a, obj_d = float(c @ analog.x), float(c @ digital.x)
    obj_gap = abs(obj_a - obj_d) / (1 + abs(obj_d))
    assert analog.converged and digital.converged
    assert obj_gap <= 1e-3, (obj_a, obj_d)
    assert float(rel_l2(a @ analog.x, b)) < 10 * args.tol

    led = analog.ledger
    print(f"\nledger: {led.mvms} forward MVMs @ "
          f"{led.input_stats.energy_j:.3e} J + {led.mvms_t} "
          f"transposed MVMs @ {led.input_stats_t.energy_j:.3e} J + "
          f"{led.mvms_single}+{led.mvms_single_t} setup MVMs, one matrix write "
          f"{led.write_energy_j:.3e} J")
    print(f"analog objective within {obj_gap:.1e} of the digital oracle")


if __name__ == "__main__":
    main()
