"""Quickstart on the PyTorch/CUDA port: program once, execute many corrected
MVMs (the twin of examples/quickstart.py).

    PYTHONPATH=src python examples/quickstart_torch.py                 # GPU
    PYTHONPATH=src python examples/quickstart_torch.py --torch-device cpu

Programs the paper's 66 x 66 bcsstk02 matrix onto a simulated multi-MCA
crossbar ONCE per device, then reuses the image for a stream of 8 corrected
MVMs -- the paper's serving model: the write energy is paid once and every
later MVM pays only the input-DAC write.  Prints the Table-1-style grid
(EpiRAM raw; TaOx-HfOx raw and with error correction): mean rel-L2 against
the digital product, E_program and E_per_mvm.

It runs on the GPU (``--torch-device cuda``, the default) through the
hand-written kernels (``--backend cuda``) and exits with an error where
there is none; the CPU is used only when asked for.  ``--backend
reference`` runs the plain block pipeline instead.
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.core import CrossbarConfig, MCAGeometry, get_device, rel_l2
from repro_torch.core.matrices import paper_matrix
from repro_torch.engine import AnalogEngine

GRID = (("epiram", False), ("taox-hfox", False), ("taox-hfox", True))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--torch-device", default="cuda",
                    help="where images and MVMs live (default cuda)")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "reference"))
    args = ap.parse_args(argv)
    dev = torch.device(args.torch_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("quickstart_torch: no CUDA device (torch.cuda.is_available() "
                 "is False); pass --torch-device cpu to run on the CPU")

    a = torch.from_numpy(paper_matrix("bcsstk02").astype(np.float32)) \
        .to(dev)                                             # kappa = 4325
    gen = torch.Generator().manual_seed(0)
    xs = torch.randn(66, 8, generator=gen).to(dev)           # a serving stream
    geom = MCAGeometry(tile_rows=1, tile_cols=1, cell_rows=66, cell_cols=66)

    print(f"torch device {dev}, backend {args.backend}")
    print(f"{'device':<12} {'EC':<6} {'rel_l2':>9} {'E_program (J)':>14} "
          f"{'E_per_mvm (J)':>14}")
    for dev_name, ec in GRID:
        cfg = CrossbarConfig(device=get_device(dev_name), geom=geom,
                             k_iters=5, ec=ec)
        engine = AnalogEngine(cfg, backend=args.backend, device=dev)
        A = engine.program(a, 1)                             # one-time write
        errs = [float(rel_l2(A @ xs[:, i], a @ xs[:, i]))    # many executions
                for i in range(xs.shape[1])]
        per_call = A.input_write_stats(batch=1)
        print(f"{dev_name:<12} {str(ec):<6} {sum(errs) / len(errs):>9.4f} "
              f"{A.write_stats.energy_j:>14.3e} {per_call.energy_j:>14.3e}")

    print("\n-> the noisy-but-fast TaOx-HfOx device + error correction reaches "
          "EpiRAM-class accuracy at ~1000x less write energy (the paper's "
          "headline result) -- and under program-once serving the matrix "
          "write is paid a single time across the whole MVM stream.")


if __name__ == "__main__":
    main()
