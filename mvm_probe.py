#!/usr/bin/env python3
"""Probe the kernels of one or more source trees on one NVIDIA GPU, in turns,
at the main path's shapes.

    python3 mvm_probe.py [ec] [--src DIR]... [--rounds N] [--iters N]
    python3 mvm_probe.py tier2 [--src DIR]... [--rounds N]

``ec`` (the default) probes the EC kernels in both directions (forward
``ec_matmul`` / ``ec_group_matmul``, transposed ``ec_rmatmul`` /
``ec_group_rmatmul``): a 32,768^2 image at batch 1 and 8, the two
least-squares / LP images (32,768 x 16,384 and 16,384 x 32,768) at batch
1, and the 8 experts' w1 of a Mixtral-8x7B layer (live 14,336 x 4,096
views of (8, 16,384, 4,096) stacks) at batch 1 and 8.

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
members) and the bound (the images' and panels' bytes at 3.35 TB/s).

``tier2`` probes ``stencil_denoise``, ``cg_update`` and
``richardson_update`` of every tree: first each tree's outputs against the
first tree's on the same inputs, bit for bit or the largest gap in units in
the last place, at chip_smoke.py's TIER2_STENCIL_SHAPES (lam 1e-12 and
1e-2) and TIER2_CG_SHAPES (``richardson_update`` also on 1 x 1) and on the
EC + stencil pair of a corrected MVM (32,768^2, batch 1 and 8); then
chip_smoke.py's own measurements with each tree's modules, in turns over
``--rounds`` rounds (other, this, this, other for two trees): its
``launch_floor`` (the plain floor probe where a tree has it, and
``richardson_update``, ``stencil_denoise`` and ``cg_update`` on 1 x 1) and
``tier2_phase`` (those shapes against the plain version, and the 197 panels
of a qwen3-1.7b 1 x 1,024 prefill), the pair (``ec_stencil_pair_ms``) and a
CG and a Richardson step on a programmed 32,768^2 epiram image
(``cg_step``, ``richardson_step``, with each tree's engine and solvers).

The last line is one JSON object.  Needs a CUDA device; exits non-zero
without one.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import torch

from chip_smoke import (D_FF, D_MODEL, EC_TOL, N, N_EXPERTS,
                        STENCIL_CHECK_LAM, TIER2_CG_SHAPES,
                        TIER2_STENCIL_SHAPES, cg_step, device_time_ms,
                        ec_stencil_pair_ms, kernel_split, launch_floor,
                        rel_l2, richardson_step, short_kernel_name,
                        tier2_phase)

HERE = Path(__file__).resolve().parent


def own_modules() -> dict:
    """The ``repro_torch`` modules in ``sys.modules``."""
    return {n: m for n, m in sys.modules.items()
            if n == "repro_torch" or n.startswith("repro_torch.")}


@contextlib.contextmanager
def active(tree):
    """``tree``'s ``repro_torch`` modules in ``sys.modules`` and its ``src``
    first on ``sys.path`` while its code runs, so that the imports its
    functions make when called find its own package; taken out again
    after, so trees do not share modules."""
    for name in own_modules():
        del sys.modules[name]
    sys.modules.update(tree.modules)
    sys.path.insert(0, str(tree.src))
    try:
        yield tree
    finally:
        tree.modules.update(own_modules())
        sys.path.remove(str(tree.src))
        for name in own_modules():
            del sys.modules[name]


def load_tree(src: Path) -> SimpleNamespace:
    """The ``repro_torch`` package under ``src``, imported as a copy of its
    own; call its functions under ``active``."""
    tree = SimpleNamespace(src=src, modules={})
    with active(tree):
        tree.kernels = importlib.import_module("repro_torch.kernels")
        tree.rram = importlib.import_module("repro_torch.kernels.rram_mvm")
        tree.build = importlib.import_module("repro_torch.kernels.build")
        tree.core = importlib.import_module("repro_torch.core")
        tree.engine = importlib.import_module("repro_torch.engine")
        tree.solvers = importlib.import_module("repro_torch.solvers")
        tree.build.library()
    tree.layout = {"forward": getattr(tree.rram, "matmul_layout", None),
                   "transposed": getattr(tree.rram, "rmatmul_layout", None)}
    return tree


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
    with active(trees[0]):
        hw = importlib.import_module("repro_torch.analysis.roofline").HW
    bound = 4 * (2 * g * m * k + 2 * g * rows_in * batch
                 + g * rows_out * batch) / hw["hbm_bw"] * 1e3
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


def ulp_gap(a, b) -> int:
    """Largest distance between two float32 tensors in units in the last
    place (0: equal bit for bit)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(1 << 31) - i, i)
    return int((ordered(a) - ordered(b)).abs().max())


def turns(fns, rounds):
    """What each of ``fns`` returns in each round, called in turns: the
    order reversed in even rounds (the other trees, then this tree first:
    other, this, this, other for two trees and two rounds)."""
    out = [[] for _ in fns]
    order = list(range(len(fns)))
    for r in range(rounds):
        for i in (order[::-1] if r % 2 == 0 else order):
            out[i].append(fns[i]())
    return out


def tier2(labels, trees, args, dev) -> dict:
    """The ``tier2`` probe (module docstring); returns its record."""
    def each(fn):   # fn(tree) of each tree, under ``active``
        out = []
        for t in trees:
            with active(t):
                out.append(fn(t))
        return out

    def timed(fn):  # fn(tree) of each tree in turns, under ``active``
        def under(t):
            with active(t):
                return fn(t)
        return dict(zip(labels, turns([lambda t=t: under(t) for t in trees],
                                      args.rounds)))

    cfg = trees[0].core.CrossbarConfig(
        device=trees[0].core.get_device("taox-hfox"))
    lam, h = cfg.lam, cfg.h
    gen = torch.Generator(device=dev).manual_seed(0)
    at = torch.randn(N, N, generator=gen, device=dev)
    da = torch.randn(N, N, generator=gen, device=dev)
    record = {"ulps": {}, "phase": {}}

    # Each tree's outputs against the first tree's on the same inputs.
    def gaps(what, outs):
        outs = [o if isinstance(o, tuple) else (o,) for o in outs]
        record["ulps"][what] = {
            label: max(ulp_gap(o, w) for o, w in zip(out, outs[0]))
            for label, out in zip(labels, outs)}
        print(f"  {what}: " + ", ".join(
            f"[{label}] " + ("bit for bit" if g == 0 else f"{g} ulps")
            for label, g in record["ulps"][what].items()), flush=True)

    print("outputs against the first tree's", flush=True)
    for n, batch in TIER2_STENCIL_SHAPES:
        p = torch.randn(n, batch, generator=gen, device=dev)
        for lam_ in (lam, STENCIL_CHECK_LAM):
            gaps(f"stencil_denoise {n}x{batch} lam {lam_:g}",
                 each(lambda t: t.kernels.stencil_denoise(p, lam_, h)))
        del p
    for n, batch in TIER2_CG_SHAPES:
        v = [torch.randn(n, batch, generator=gen, device=dev)
             for _ in range(4)]
        alpha = torch.rand(batch, generator=gen, device=dev)
        gaps(f"cg_update {n}x{batch}",
             each(lambda t: t.kernels.cg_update(*v, alpha)))
    for n, batch in ((1, 1),) + TIER2_CG_SHAPES:
        v = [torch.randn(n, batch, generator=gen, device=dev)
             for _ in range(3)]
        omega = torch.rand((), generator=gen, device=dev)
        gaps(f"richardson_update {n}x{batch}",
             each(lambda t: t.kernels.richardson_update(*v, omega)))
    xs = {batch: (torch.randn(N, batch, generator=gen, device=dev),
                  torch.randn(N, batch, generator=gen, device=dev))
          for batch in (1, 8)}
    for batch, (x, x_t) in xs.items():
        gaps(f"ec_matmul + stencil_denoise {N}x{N} batch {batch}",
             each(lambda t: t.kernels.stencil_denoise(
                 t.kernels.ec_matmul(at, da, x, x_t), lam, h)))

    # chip_smoke.py's measurements, each tree's kernels in turns.
    phase = timed(lambda t: {"floor": launch_floor(dev, t.kernels, lam, h),
                             "rows": tier2_phase(dev, t.kernels, lam, h)})
    pairs = {batch: timed(lambda t: ec_stencil_pair_ms(
                 t.kernels, at, da, x, x_t, lam, h))
             for batch, (x, x_t) in xs.items()}
    del at, da, xs
    torch.cuda.empty_cache()
    a = torch.randn(N, N, generator=gen, device=dev).div_(N)
    a = a + a.T
    a.diagonal().add_(2.0)
    b = torch.matmul(a, torch.randn(N, generator=gen, device=dev))
    images = dict(zip(map(id, trees), each(lambda t: t.engine.AnalogEngine(
        t.core.CrossbarConfig(device=t.core.get_device("epiram")),
        backend="cuda", device=dev).program(a, 2))))
    del a
    torch.cuda.empty_cache()
    cg = timed(lambda t: cg_step(t.solvers, images[id(t)], b))
    rich = timed(lambda t: richardson_step(t.solvers, images[id(t)], b))
    del images

    print(f"device ms in {args.rounds} rounds (chip_smoke.py's phases: "
          f"stencil_denoise timed at lam {STENCIL_CHECK_LAM:g} and "
          f"{lam:g})", flush=True)

    def line(what, per_tree, bound=None, unit=1.0, fmt=".5f"):
        """A tree whose values are None (it lacks the function) prints
        "none"."""
        record["phase"][what] = {"bound_ms": bound, "ms": per_tree}

        def text(t):
            if any(x is None for x in t):
                return "none"
            mean = sum(t) / len(t)
            return (f"{' / '.join(f'{x * unit:{fmt}}' for x in t)} (mean "
                    f"{mean * unit:{fmt}}" + (
                        f", {bound / mean:.1%} of the bound" if bound
                        else "") + ")")
        print(f"  {what}" + (f" (bound {bound:{fmt}})" if bound else "")
              + ": " + ", ".join(f"[{label}] {text(t)}"
                                 for label, t in per_tree.items()),
              flush=True)

    def per_tree(get):   # get(a round's result) of each tree, each round
        return {label: [get(r) for r in runs]
                for label, runs in phase.items()}

    line("launch_floor_probe, a plain launch (us)",
         per_tree(lambda r: r["floor"].get("launch_floor_probe")),
         unit=1e3, fmt=".3f")
    for name in ("richardson_update", "stencil_denoise", "cg_update"):
        line(f"{name} 1 x 1 (us)", per_tree(lambda r: r["floor"][name]),
             unit=1e3, fmt=".3f")
    for j, entry in enumerate(phase[labels[0]][0]["rows"]):
        (name, row), = entry.items()
        what = f"{name} {row['shape']}"
        if "lam_ms" in row:
            line(f"{what} lam {STENCIL_CHECK_LAM:g}",
                 per_tree(lambda r: r["rows"][j][name]["ms"]),
                 bound=row["bound_ms"])
            line(f"{what} lam {lam:g}",
                 per_tree(lambda r: r["rows"][j][name]["lam_ms"][f"{lam:g}"]),
                 bound=row["bound_ms"])
        else:
            line(what, per_tree(lambda r: r["rows"][j][name]["ms"]),
                 bound=row["bound_ms"])
    for batch, ms in pairs.items():
        line(f"EC + stencil pair {N}x{N} batch {batch}", ms, fmt=".4f")
    line("a CG step on a 32,768^2 epiram image", {
        label: [step[1] for step in t] for label, t in cg.items()},
         fmt=".4f")
    line("  of which stencil_denoise + cg_update", {
        label: [step[2] for step in t] for label, t in cg.items()})
    line("a Richardson step on the same image", {
        label: [step[1] for step in t] for label, t in rich.items()},
         fmt=".4f")
    line("  of which stencil_denoise + richardson_update", {
        label: [step[2] for step in t] for label, t in rich.items()})
    return record


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("what", nargs="?", default="ec",
                        choices=("ec", "tier2"))
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
    sources = (("tridiag.cu", "solver_update.cu") if args.what == "tier2"
               else ("rram_mvm.cu",))
    for label, tree in zip(labels, trees):
        rows = {name: row for name, row in tree.build.ptxas_report().items()
                if row["source"] in sources}
        result["ptxas"][label] = rows
        for name, row in rows.items():
            print(f"[{label}] ptxas {name:32s} {row['registers']:3d} "
                  f"registers, {row['stack']} B stack frame, "
                  f"{row['spill_stores']} / {row['spill_loads']} B spill "
                  f"stores / loads", flush=True)

    if args.what == "tier2":
        result["tier2"] = tier2(labels, trees, args, dev)
        print(json.dumps(result))
        return 0
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
