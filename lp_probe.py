#!/usr/bin/env python3
"""The spread of examples/meliso_lp_torch.py's objective gap over LP draws.

The LP example asserts that analog PDHG (one local epiram image, one 64^2
MCA, EC on, the ``cuda`` backend) ends within 1e-3 of the digital PDHG's
objective at tol 2e-4.  This probe runs that solve on the LPs of
``random_feasible_lp(seed, 256, 512)`` for a range of seeds and prints, a
seed a line: seed, analog iterations, analog converged, digital
iterations, and the relative objective gap the example asserts on.  The
LP and the noise come from the device's own generator, so the CPU and the
card draw different problems for one seed.

    PYTHONPATH=src python3 lp_probe.py FIRST LAST DEVICE
    PYTHONPATH=src python3 lp_probe.py 0 12 cuda
"""
import sys

import torch

from repro_torch import solvers
from repro_torch.core import CrossbarConfig, MCAGeometry, get_device
from repro_torch.engine import AnalogEngine


def main(argv):
    first, last, dev = int(argv[0]), int(argv[1]), argv[2]
    torch.set_num_threads(2)
    cfg = CrossbarConfig(device=get_device("epiram"),
                         geom=MCAGeometry(1, 1, 64, 64), k_iters=5, ec=True)
    for seed in range(first, last):
        a, b, c, _, _ = solvers.random_feasible_lp(seed, 256, 512, device=dev)
        A = AnalogEngine(cfg, backend="cuda", device=dev).program(a, 0)
        d = solvers.pdhg(a, b, c, tol=2e-4, maxiter=20000)
        an = solvers.pdhg(A, b, c, tol=2e-4, maxiter=20000, key=0)
        oa, od = float(c @ an.x), float(c @ d.x)
        print(seed, an.iterations, an.converged, d.iterations,
              abs(oa - od) / (1 + abs(od)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
