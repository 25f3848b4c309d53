#!/usr/bin/env python
"""Invariant gate of the PyTorch/CUDA port: the five audits over every
registered pipeline, against ``INVARIANTS_torch.json``.

Runs each pipeline of ``repro_torch.analysis.pipelines`` once under the
passes of ``repro_torch.analysis.verify`` (AvalBound, DispatchCount,
KeyReuse, PrecisionLint, CollectiveAudit) and compares its record -- the
largest tensor, producer calls, the key census, psums and joins, MVMs,
and on the card the kernel launches -- with the manifest's section for the
device, field for field.  A change that holds an A-sized tensor, produces
a block twice, draws from one key at two places, accumulates in float16,
or reduces over an undeclared axis fails here.

``--device cuda`` (the default) runs the paper-scale registry on the card
(the ``cuda`` section, with each kernel's launches); ``--device cpu`` runs
the reduced registry on the CPU (the ``cpu`` section).  Every count is
deterministic, so the comparison is exact.

Usage:

    PYTHONPATH=src python tools/check_invariants_torch.py --device cpu
    PYTHONPATH=src python tools/check_invariants_torch.py            # card
    PYTHONPATH=src python tools/check_invariants_torch.py --update  # rebaseline
    PYTHONPATH=src python tools/check_invariants_torch.py --report out.json

``--update`` rewrites the device's section after an intentional pipeline
change: commit the diff and say why in the PR.  ``--report`` writes the
full per-pass summaries.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
MANIFEST = REPO / "INVARIANTS_torch.json"
sys.path.insert(0, str(REPO / "src"))

from repro_torch.analysis import pipelines as P  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=sorted(P.SCALE_OF), default="cuda",
                    help="cuda: the paper-scale registry on the card "
                         "(default); cpu: the reduced registry")
    ap.add_argument("--update", action="store_true",
                    help="rewrite the device's section of "
                         "INVARIANTS_torch.json from the measured values")
    ap.add_argument("--report", metavar="PATH",
                    help="write the full per-pass report JSON")
    args = ap.parse_args()
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs a GPU (torch.cuda.is_available()"
                         " is False); pass --device cpu")

    manifest = json.loads(MANIFEST.read_text()) if MANIFEST.exists() else {}
    errors = []
    if args.device not in manifest and not args.update:
        errors.append(f"{MANIFEST.name} has no {args.device!r} section -- "
                      "generate it with --update and commit it")
    rows, reports = {}, {}
    for c in P.check_section(args.device, manifest):
        if c.row is None:               # --update drops it
            if not args.update:
                errors.append(f"{c.name}: in manifest but not registered")
            continue
        rows[c.name] = row = c.row
        reports[c.name] = {
            name: {"ok": r.ok, "summary": r.summary,
                   "violations": [str(v) for v in r.violations]}
            for name, r in c.reports.items()}
        print(f"[invariants] {c.name}: "
              f"{'FAIL' if row['violations'] else 'ok'} ({c.seconds:.2f} s) "
              f"max_elements={row['max_elements']} "
              f"producer_calls={row['producer_calls']} "
              f"keys={row['key_consumptions']}/{row['distinct_keys']}",
              flush=True)
        errors += [f"{c.name}: {v}" for v in row["violations"]]
        if not args.update:
            errors += [f"{c.name}.{k}: measured {got!r} != manifest {want!r} "
                       "(intentional? run --update and explain in the PR)"
                       for k, (got, want) in c.diff.items()]
    if args.report:
        pathlib.Path(args.report).write_text(
            json.dumps(reports, indent=2, sort_keys=True) + "\n")
        print(f"[invariants] report written to {args.report}")

    if args.update:
        manifest[args.device] = rows
        MANIFEST.write_text(json.dumps(manifest, indent=2, sort_keys=True)
                            + "\n")
        print(f"[invariants] section {args.device!r} of {MANIFEST.name} "
              f"rewritten ({len(rows)} pipelines)")
    if errors:
        print("\n".join(["", "INVARIANT FAILURES:"] + errors), file=sys.stderr)
        return 1
    print(f"invariants OK ({len(rows)} pipelines, 5 passes each, "
          f"device {args.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
