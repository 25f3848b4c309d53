"""Device-lifetime reliability end to end through the PyTorch/CUDA port: age,
probe, refresh, recover (the twin of examples/meliso_reliability.py).

Act 1 -- the lifetime of ONE programmed image on a faulty device: an SPD
system is programmed once, solved fresh, then aged by the device's own
read-disturb fault process (drift and replayable stuck-at latches, applied
by the engine's ``reference`` backend to every execute of the aged handle).
The aged solve degrades; one batched probe call localizes the damage to
capacity tiles; a tile-selective refresh re-runs closed-loop
write-and-verify on those tiles only and restores the solve at a fraction of
the full-reprogram energy.

Act 2 -- surviving a fault in the middle of a solve: the same kind of
system is programmed across a mesh of ranks (``--mesh R,C``, default 2,4;
every rank on the one ``--torch-device``) and handed to the fault-tolerant
CG wrapper.  A stuck column is written into the ranks' conductance windows
during segment 1; the digital residual check (against the healthy matrix
captured at entry) flags the divergence, the iterate rolls back to the last
good checkpoint on disk, the ``on_fault`` callback repairs the operator,
and the solve converges anyway.  Its image and inner CG run on the ``cuda``
backend (the hand-written kernels on a GPU, their plain versions on the
CPU).

``--torch-device`` says where the tensors live: ``cuda`` (the default, an
error where there is no GPU) or ``cpu``, only when asked for.  The fault
draws come from ``torch.Generator``s, which differ between the CPU and a
GPU, so the two devices latch different cells.

    PYTHONPATH=src python examples/meliso_reliability_torch.py
    PYTHONPATH=src python examples/meliso_reliability_torch.py --mesh 4,2
    PYTHONPATH=src python examples/meliso_reliability_torch.py \
        --torch-device cpu
"""
import argparse
import sys

import torch

from repro_torch.core import CrossbarConfig, MCAGeometry, get_device
from repro_torch.core.prng import fold_in
from repro_torch.engine import AnalogEngine
from repro_torch.launch import make_mesh
from repro_torch.reliability import (RefreshPolicy, attach_age, ft_cg,
                                     predicted_residual, probe_tile_scores,
                                     refresh_tiles)
from repro_torch.solvers import cg


def _spd(n: int, seed: int, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = torch.randn(n, n, generator=gen, device=dev) / n
    a = r + r.T + 2.0 * torch.eye(n, device=dev)
    x_true = torch.randn(n, generator=gen, device=dev)
    return a, a @ x_true


def lifetime_act(n: int, device: str, dev) -> None:
    a, b = _spd(n, 0, dev)
    bn = float(torch.linalg.vector_norm(b))
    fdev = get_device(device)
    cfg = CrossbarConfig(device=fdev, geom=MCAGeometry(2, 2, 32, 32),
                         k_iters=5, ec=True)
    engine = AnalogEngine(cfg, device=dev)
    A = engine.program(a, fold_in(0, 7))                 # programmed ONCE
    attach_age(A)

    def digital_rel(salt: int) -> float:
        res = cg(A, b, tol=1e-6, maxiter=120, key=fold_in(0, salt))
        return float(torch.linalg.vector_norm(b - a @ res.x)) / bn

    # The fresh and the aged solve run under one DAC key, so that what
    # differs between them is the age, not the input noise.
    fresh = digital_rel(11)
    # Age until ~8 cells of the image have latched under read disturb.
    mvms = max(1, int(8.0 / (fdev.fault_rate * n * n)))
    A.age = A.age.advanced(mvms)
    pred = predicted_residual(fdev, k_iters=cfg.k_iters, seconds=0.0,
                              mvms=mvms, n=n)
    aged = digital_rel(11)
    print(f"[lifetime] n={n} device={device} torch_device={dev}: fresh "
          f"solve {fresh:.2e}, after {mvms} MVMs aged solve {aged:.2e} "
          f"(analytic prediction {pred:.2e})")
    assert aged > fresh, "aging should visibly degrade the solve"

    report = probe_tile_scores(A, key=fold_in(0, 13))
    print("[lifetime] per-tile probe scores (rel l2):")
    for row in report.scores.tolist():
        print("            " + "  ".join(f"{s:8.2e}" for s in row))

    rr = refresh_tiles(A, report.scores, RefreshPolicy(threshold=0.01),
                       key=fold_in(0, 14))
    restored = digital_rel(15)
    print(f"[lifetime] refreshed {len(rr.tiles)}/{report.scores.numel()} "
          f"tiles {list(rr.tiles)}: solve {restored:.2e}, energy "
          f"{rr.write_stats.energy_j:.3e} J vs full reprogram "
          f"{rr.full_rewrite_stats.energy_j:.3e} J "
          f"({rr.energy_saving:.0%} saved)")
    assert restored <= 2.0 * fresh, (restored, fresh)
    assert rr.write_stats.energy_j < rr.full_rewrite_stats.energy_j


def fault_act(n: int, mesh_shape, dev) -> None:
    mesh = make_mesh(mesh_shape, ("data", "model"), device=dev)
    a, b = _spd(n, 2, dev)
    cfg = CrossbarConfig(device=get_device("epiram"),
                         geom=MCAGeometry(2, 2, 16, 16), k_iters=5, ec=True)
    engine = AnalogEngine(cfg, execution="distributed", backend="cuda",
                          mesh=mesh)
    A = engine.program(a, fold_in(2, 7))
    cols = n // mesh_shape[1]          # each rank's contraction window
    state = {"saved": None}

    def inject(seg, h):
        if seg == 1 and state["saved"] is None:
            state["saved"] = [w.clone() for w in h.at_ranks]
            rail = max(float(w.abs().max()) for w in h.at_ranks)
            for w, (r, c) in zip(h.at_ranks, engine._rank_grid.rc):
                if c == 5 // cols:     # column stuck at the G_on rail
                    w[:, 5 % cols] = rail
            print("[fault]    segment 1: column 5 latched at the G_on rail")

    def repair(event, h):
        for w, saved in zip(h.at_ranks, state["saved"]):
            w.copy_(saved)
        print(f"[fault]    detected ({event.kind}, digital residual "
              f"{event.residual:.2e}) -> rolled back to checkpoint step "
              f"{event.restored_step}, operator repaired")

    res = ft_cg(A, b, tol=1e-4, maxiter=400, segment=25, key=fold_in(2, 9),
                segment_hook=inject, on_fault=repair, backend="cuda")
    print(f"[fault]    converged={res.converged} after {res.iterations} "
          f"accepted segments, {res.restores} restore(s), final digital "
          f"residual {res.final_residual:.2e} on a "
          f"{mesh_shape[0]} x {mesh_shape[1]} mesh")
    assert res.converged and res.restores >= 1, (res.converged, res.restores)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256)
    # ag-si: the highest fault-rate device in the zoo -- damage shows up in
    # few MVMs, which keeps the example quick.
    ap.add_argument("--device", default="ag-si")
    ap.add_argument("--mesh", default="2,4", metavar="R,C")
    ap.add_argument("--torch-device", default="cuda",
                    help="where images and solves live (default cuda)")
    args = ap.parse_args(argv)
    try:
        rows, cols = (int(v) for v in args.mesh.split(","))
    except ValueError:
        sys.exit(f"--mesh must be 'R,C' integers, got {args.mesh!r}")
    dev = torch.device(args.torch_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("meliso_reliability_torch: no CUDA device "
                 "(torch.cuda.is_available() is False); pass --torch-device "
                 "cpu to run on the CPU")

    lifetime_act(args.n, args.device, dev)
    print()
    fault_act(min(args.n, 128), (rows, cols), dev)


if __name__ == "__main__":
    main()
