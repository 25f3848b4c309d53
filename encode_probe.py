#!/usr/bin/env python3
"""Probe the single-pass encode kernels on one NVIDIA GPU at the main path's
shape: x (256, 4,096) @ encode(W (4,096, 14,336)), 512^2 MCA tiles,
taox-hfox levels and effective sigma.

    python3 encode_probe.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory of the tree to probe (default: the one
beside this script), so two trees -- a parent unpacked with ``git archive``
and this one -- can be probed in turns in one session on one card.  It
prints what ``ptxas -v`` reports for the encode kernels and, for each of
``encode_matmul`` and ``encode_matmul_rng``, checks the kernel against its
plain version (rel-L2 <= 1e-5; the rng kernel bit for bit run to run and
equal to ``encode_matmul`` with zero eps at sigma = 0) and times it: the
device time of a call (CUDA events), the share of each CUDA kernel in it
(``torch.profiler``), and the SM clock and power that ``nvidia-smi``
samples while it runs.  It also prints a digest of the rng kernel's draws
for 256 x 14,336 weights: two trees that draw the same noise print the same
digest.  The last line is one JSON object.
Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import torch

from chip_smoke import (D_FF, D_MODEL, EC_TOL, ENCODE_ROWS, ENCODE_SEED,
                        FP32_FLOPS_PER_S, clock_under_load, device_time_ms,
                        kernel_split, rel_l2)

ITERS = 20
HERE = Path(__file__).resolve().parent


def own_build_module():
    """This tree's ``build.py`` under its own name: its report parsers then
    read the build of whichever tree ``--src`` names."""
    spec = importlib.util.spec_from_file_location(
        "encode_probe_build", HERE / "src/repro_torch/kernels/build.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", default=str(HERE / "src"))
    parser.add_argument("--label", default="tree")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("encode_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch import kernels
    from repro_torch.core import CrossbarConfig, get_device
    from repro_torch.core.devices import effective_sigma_py
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build.library()
    reports = own_build_module()
    ptxas = {k: v for k, v in reports.ptxas_report(build.build_log).items()
             if v["source"] == "encode_matmul.cu"}
    print(f"[{args.label}] {build.__file__}", flush=True)
    for name, row in ptxas.items():
        print(f"  ptxas {name}: {row}", flush=True)

    taox = get_device("taox-hfox")
    sigma = effective_sigma_py(taox, CrossbarConfig(device=taox).k_iters)
    m, k, n = ENCODE_ROWS, D_MODEL, D_FF
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(m, k, generator=gen, device=dev)
    w = torch.randn(k, n, generator=gen, device=dev).div_(k ** 0.5)
    eps = torch.randn(k, n, generator=gen, device=dev)
    kw = dict(sigma=sigma, levels=taox.levels, block_k=512, block_n=512)
    calls = {
        "encode_matmul": (
            lambda: kernels.encode_matmul(x, w, eps, **kw),
            lambda: kernels.encode_matmul_plain(x, w, eps, sigma, taox.levels,
                                                512, 512)),
        "encode_matmul_rng": (
            lambda: kernels.encode_matmul_rng(ENCODE_SEED, x, w, **kw),
            lambda: kernels.encode_matmul_rng_plain(ENCODE_SEED, x, w, **kw)),
    }
    flops = 2.0 * m * k * n
    result = {"label": args.label, "ptxas": ptxas}
    for name, (kernel_fn, plain_fn) in calls.items():
        got = kernel_fn()
        err = rel_l2(got, plain_fn())
        if err > EC_TOL:
            raise SystemExit(f"{name}: rel-L2 {err:.3e} against its plain "
                             f"version exceeds {EC_TOL:.0e}")
        ms = device_time_ms(kernel_fn, ITERS)
        mhz, watts, samples = clock_under_load(kernel_fn)
        split = kernel_split(kernel_fn)
        result[name] = {"ms": ms, "rel_l2": err, "tflops": flops / ms / 1e9,
                        "fp32_peak_share": flops / ms / 1e-3
                        / FP32_FLOPS_PER_S, "sm_mhz": mhz, "watts": watts,
                        "clock_samples": samples, "split_ms": split}
        print(f"  {name}: {ms:.4f} ms, {flops / ms / 1e9:.2f} TFLOP/s, "
              f"rel-L2 {err:.2e}; SM {mhz} MHz, {watts} W ({samples} "
              f"samples); split {json.dumps(split)}", flush=True)
    zero = dict(kw, sigma=0.0)
    result["rng_sigma0_equal"] = torch.equal(
        kernels.encode_matmul_rng(ENCODE_SEED, x, w, **zero),
        kernels.encode_matmul(x, w, torch.zeros_like(w), **zero))
    result["rng_run_to_run_equal"] = torch.equal(
        calls["encode_matmul_rng"][0](), calls["encode_matmul_rng"][0]())
    if not (result["rng_sigma0_equal"] and result["rng_run_to_run_equal"]):
        raise SystemExit("encode_matmul_rng: not bit for bit")
    # x = I reads W_tilde back exactly whatever the summation order, and W
    # of ones quantizes to ones: the digest is that of the draws 1 + 0.5 eta
    # of the first 256 x 14,336 weights, for comparing two trees' draws.
    draws = kernels.encode_matmul_rng(ENCODE_SEED, torch.eye(m, device=dev),
                                      torch.ones(m, n, device=dev), sigma=0.5,
                                      levels=taox.levels)
    result["draws_sha256"] = hashlib.sha256(
        draws.cpu().numpy().tobytes()).hexdigest()
    print(f"  draws of 256 x {n} weights: sha256 {result['draws_sha256']}",
          flush=True)
    result["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
