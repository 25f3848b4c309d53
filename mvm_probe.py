#!/usr/bin/env python3
"""Probe the EC kernels of one or more source trees on one NVIDIA GPU, both
directions (forward ``ec_matmul`` / ``ec_group_matmul``, transposed
``ec_rmatmul`` / ``ec_group_rmatmul``), in turns, at the main path's
shapes: a 32,768^2 image at batch 1 and 8, the two least-squares / LP
images (32,768 x 16,384 and 16,384 x 32,768) at batch 1, and the 8 experts'
w1 of a Mixtral-8x7B layer (live 14,336 x 4,096 views of (8, 16,384, 4,096)
stacks) at batch 1 and 8.

    python3 mvm_probe.py [--src DIR]... [--rounds N] [--iters N]

The tree beside this script comes first; each ``--src`` names the ``src``
directory of another (a parent unpacked with ``git archive``, a variant).
All trees are loaded into this one process, each under its own copy of the
``repro_torch`` package and its own kernel library, and every shape is timed
tree after tree, in ``--rounds`` rounds that alternate the order (A B, B A,
...), on the same inputs.  For each tree it prints what ``ptxas -v`` reports
for its ``rram_mvm.cu`` kernels and, where the tree reports it
(``matmul_layout``, ``rmatmul_layout``), the layout its launcher chose:
kernel, blocks against resident slots (blocks an SM x SMs) and waves, units,
pieces of K (forward) or partials a block (transposed).  For each direction,
shape and tree: rel-L2 against the plain version (must be <= 1e-5), run to
run bit for bit, device ms per call (CUDA events) in each round, and the
share of each CUDA kernel of a call (``torch.profiler``: the product against
the pass that sums its partials); beside them the library call (cuBLAS
``at @ x + da @ x_t`` / ``at.T @ y + da.T @ y_t``, or ``bmm`` on the
members) and the bound (the images' and panels' bytes at 3.35 TB/s).  The
last line is one JSON object.  Needs a CUDA device; exits non-zero without
one.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import torch

from chip_smoke import (D_FF, D_MODEL, EC_TOL, HBM_BYTES_PER_S, N,
                        N_EXPERTS, device_time_ms, kernel_split, rel_l2,
                        short_kernel_name)

HERE = Path(__file__).resolve().parent


def load_tree(src: Path) -> SimpleNamespace:
    """The kernels of the ``repro_torch`` package under ``src``, imported as
    a copy of its own: the package is taken out of ``sys.modules`` before
    and after, so trees do not share modules."""
    def purge():
        for name in [n for n in sys.modules
                     if n == "repro_torch" or n.startswith("repro_torch.")]:
            del sys.modules[name]

    purge()
    sys.path.insert(0, str(src))
    try:
        rram = importlib.import_module("repro_torch.kernels.rram_mvm")
        build = importlib.import_module("repro_torch.kernels.build")
    finally:
        sys.path.remove(str(src))
        purge()
    build.library()
    return SimpleNamespace(rram=rram, build=build, layout={
        "forward": getattr(rram, "matmul_layout", None),
        "transposed": getattr(rram, "rmatmul_layout", None)})


def layout_text(lay) -> str:
    if lay is None:
        return "layout not reported"
    last = (f"{lay['pieces']} pieces of K" if "pieces" in lay else
            f"<= {lay['partials_per_block']} partials a block")
    return (f"{'staged' if lay['staged'] else 'register loads'}, "
            f"{lay['blocks']} blocks on {lay['blocks_per_sm']} x "
            f"{lay['sms']} slots ({lay['waves']:.3f} waves), {lay['units']} "
            f"units of {lay['rows_per_unit']} x {lay['cols_per_unit']}, "
            f"{last}, workspace {lay['workspace_floats']} floats")


def probe(direction, name, a, d, batch, gen, labels, trees, args):
    """One direction at one shape: every tree against the plain version,
    then timed in turns; returns the shape's record."""
    dev = a.device
    forward = direction == "forward"
    group = a.ndim == 3
    g = a.shape[0] if group else 1
    m, k = a.shape[-2:]
    rows_in = k if forward else m     # rows of the input panels
    u = torch.randn(rows_in, g * batch, generator=gen, device=dev)
    u_t = torch.randn(rows_in, g * batch, generator=gen, device=dev)

    def members(v):    # (rows, g * b) panel -> (g, rows, b) for bmm
        return v.view(v.shape[0], g, batch).permute(1, 0, 2)

    ai, di = (a, d) if forward else (a.transpose(-2, -1), d.transpose(-2, -1))
    if group:
        library = (lambda: torch.bmm(ai, members(u))
                   + torch.bmm(di, members(u_t)))
    else:
        library = lambda: torch.matmul(ai, u) + torch.matmul(di, u_t)
    fn_name = ("ec_group_" if group else "ec_") + \
        ("matmul" if forward else "rmatmul")
    want = getattr(trees[0].rram, fn_name + "_plain")(a, d, u, u_t)
    rows_out = m if forward else k
    bound = 4 * (2 * g * m * k + 2 * g * rows_in * batch
                 + g * rows_out * batch) / HBM_BYTES_PER_S * 1e3
    shape = {"direction": direction, "shape": name, "batch": batch,
             "bound_ms": bound, "trees": {}}
    calls = []
    for label, tree in zip(labels, trees):
        run = getattr(tree.rram, fn_name)
        fn = (lambda run=run: run(a, d, u, u_t))
        got = fn()
        err = rel_l2(got, want)
        same = torch.equal(got, fn())
        if err > EC_TOL or not same:
            raise SystemExit(f"{label} {fn_name} {name} batch {batch}: "
                             f"rel-L2 {err:.3e} against the plain version, "
                             f"bit for bit run to run {same}")
        row = {"rel_l2": err, "ms": [], "split_ms": {
            short_kernel_name(key): ms
            for key, ms in kernel_split(fn).items()}}
        query = tree.layout[direction]
        if query is not None:
            lay = query(a, d, batch)._asdict()
            lay["waves"] = lay["blocks"] / (lay["blocks_per_sm"] * lay["sms"])
            row["layout"] = lay
        shape["trees"][label] = row
        calls.append((label, fn))
    for r in range(args.rounds):
        for label, fn in (calls if r % 2 == 0 else calls[::-1]):
            shape["trees"][label]["ms"].append(device_time_ms(fn, args.iters))
    shape["library_ms"] = device_time_ms(library, args.iters)
    print(f"{fn_name} {name} batch {batch}: bound {bound:.4f} ms, library "
          f"{shape['library_ms']:.4f} ms", flush=True)
    for label, row in shape["trees"].items():
        split = ", ".join(f"{key} {v:.4f}" for key, v in row["split_ms"]
                          .items())
        mean = sum(row["ms"]) / len(row["ms"])
        print(f"  [{label}] ms {' / '.join(f'{t:.4f}' for t in row['ms'])} "
              f"(mean {mean:.4f}, {bound / mean:.1%} of bound, "
              f"{mean / shape['library_ms']:.3f}x library), rel-L2 "
              f"{row['rel_l2']:.2e}; {layout_text(row.get('layout'))}; split "
              f"{split}", flush=True)
    return shape


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", action="append", default=[],
                        help="src directory of another tree (repeatable)")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("mvm_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    srcs = [HERE / "src"] + [Path(s).resolve() for s in args.src]
    labels = [str(s.parent.relative_to(HERE)) if s.parent.is_relative_to(HERE)
              else str(s.parent) for s in srcs]
    trees = [load_tree(s) for s in srcs]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "trees": labels, "ptxas": {}, "shapes": []}
    print(f"device: {result['device']} | {smi}", flush=True)
    for label, tree in zip(labels, trees):
        rows = {name: row for name, row in tree.build.ptxas_report().items()
                if row["source"] == "rram_mvm.cu"}
        result["ptxas"][label] = rows
        for name, row in rows.items():
            print(f"[{label}] ptxas {name:32s} {row['registers']:3d} "
                  f"registers, {row['stack']} B stack frame, "
                  f"{row['spill_stores']} / {row['spill_loads']} B spill "
                  f"stores / loads", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    at = torch.randn(N, N, generator=gen, device=dev)
    da = torch.randn(N, N, generator=gen, device=dev)

    def reshaped(t, *shape):   # a contiguous tensor of this shape in t
        n = 1
        for s in shape:
            n *= s
        return t.view(-1)[:n].view(*shape)

    mr = D_FF
    stack = (reshaped(at, N_EXPERTS, 16384, D_MODEL)[:, :mr],
             reshaped(da, N_EXPERTS, 16384, D_MODEL)[:, :mr])
    shapes = [(f"{N}x{N}", at, da, 1), (f"{N}x{N}", at, da, 8),
              (f"{N}x{N // 2}", reshaped(at, N, N // 2),
               reshaped(da, N, N // 2), 1),
              (f"{N // 2}x{N}", reshaped(at, N // 2, N),
               reshaped(da, N // 2, N), 1),
              (f"{N_EXPERTS}x{mr}x{D_MODEL}", *stack, 1),
              (f"{N_EXPERTS}x{mr}x{D_MODEL}", *stack, 8)]
    for direction in ("forward", "transposed"):
        for name, a, d, batch in shapes:
            result["shapes"].append(probe(direction, name, a, d, batch, gen,
                                          labels, trees, args))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
