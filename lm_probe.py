#!/usr/bin/env python3
"""Probe the port's LM serving path outside chip_smoke.py.

    python3 lm_probe.py host [--steps 4]
    python3 lm_probe.py rehearse [--arch qwen3-1.7b]
    python3 lm_probe.py rehearse-families
    python3 lm_probe.py rehearse-recurrent

``host`` serves phase 12's first request (qwen3-1.7b, full size, DAC on)
on the card and runs ``--steps`` decode steps under ``cProfile``, each
step synchronised: the host functions a step spends its wall time in
(own and cumulative seconds a step), beside the step's wall time.  The
profiler's cost is in those numbers.  It needs a GPU.

``rehearse`` runs chip_smoke.py's phase 12 (``lm_phase``) on the CPU at the
arch's reduced config (2 layers, d_model 64, float32; cells of 32^2) with
two small requests, the second one's prefill over a lowered flash
threshold, ``torch.cuda``'s synchronise and memory calls and the profiler
split stubbed, the timing of the kernel rows replaced by one checked call,
and the ``kernels.*`` wrappers counting their launches as the CUDA path
does (one ``ec_rmatmul`` launch per 8 columns): its checks and launch
counts, without a GPU (its times are then the CPU's, not device numbers).
``rehearse-families`` does the same for phase 13 (``families_phase``) at
the reduced mixtral-8x7b, whisper-tiny and llama-3.2-vision-11b, and
``rehearse-recurrent`` for phase 14 (``recurrent_phase``) at the reduced
rwkv6-1.6b and zamba2-1.2b at 5 layers (two groups and an analog tail).
"""
import argparse
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# (batch, prompt tokens, new tokens, max_len): the second prefill's t x s
# (24 x 32) is over the rehearsal's flash threshold.
REHEARSAL_REQUESTS = ((4, 8, 4, 16), (1, 24, 3, 32))
REHEARSAL_RT_KW = {"flash_threshold": 256, "q_chunk": 8, "kv_chunk": 16}


def _rehearsal_shims():
    """Import chip_smoke with the CPU stand-ins: the ``kernels.*`` wrappers
    count their launches as the CUDA path does, ``torch.cuda``'s
    synchronise and memory calls do nothing, a kernel row is one checked
    call, the profiler split and the device timers run the call once and
    report nothing."""
    from repro_torch import kernels
    from repro_torch.kernels import build

    def launches(name, at, u):
        # The CUDA wrappers' count: ec products one launch per 8 columns
        # (of one member, for the grouped ones).
        if not name.startswith("ec_"):
            return 1
        cols = u.shape[1] // (at.shape[0] if "group" in name else 1)
        return -(-cols // 8)

    for name in list(build.LAUNCHES):
        def counted(*a, _run=getattr(kernels, name), _name=name, **kw):
            build.LAUNCHES[_name] += launches(
                _name, a[0], a[2] if len(a) > 2 else a[0])
            return _run(*a, **kw)
        setattr(kernels, name, counted)
    for stub in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        setattr(torch.cuda, stub, lambda *a, **k: None)
    torch.cuda.memory_allocated = lambda *a, **k: 0
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    def compare_once(name, kernel_fn, plain_fn, tol, **kw):
        err = chip_smoke.rel_l2(kernel_fn(), plain_fn())
        chip_smoke.check(err <= tol, f"{name}: rel-L2 {err:.3e}")
        return {"rel_l2": err}

    def split_none(fn, iters=5):
        fn()                    # the card's warm-up call: the cache moves on
        return {}               # no device trace here

    def time_none(fn, iters, warmup=2):
        fn()
        return 0.0

    chip_smoke.compare = compare_once
    chip_smoke.kernel_split = split_none
    chip_smoke.device_time_ms = chip_smoke.call_time_ms = time_none
    return chip_smoke


def rehearse(args) -> None:
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RRAMBackendConfig

    chip_smoke = _rehearsal_shims()
    cfg = get_arch(args.arch).reduced()
    rram = RRAMBackendConfig(enabled=True, dw_dtype="float32", cell_rows=32,
                             cell_cols=32)
    t0 = time.perf_counter()
    counts = chip_smoke.lm_phase(
        torch.device("cpu"), [], cfg=cfg, rram=rram,
        requests=REHEARSAL_REQUESTS, dense_rows=(1, 4, 8, 13),
        rt_kw=REHEARSAL_RT_KW, profile_steps=2)
    print(f"rehearsal of {args.arch} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}) on the CPU passed in "
          f"{time.perf_counter() - t0:.1f} s; calls "
          f"{ {k: v for k, v in counts.items() if v} }")


def rehearse_families(args) -> None:
    """chip_smoke.py's phase 13 at the reduced mixtral-8x7b, whisper-tiny
    (40 frames, the encoder's attention over a lowered flash threshold)
    and llama-3.2-vision-11b (two super layers of one self + one cross
    layer), cells of 32^2."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RRAMBackendConfig

    chip_smoke = _rehearsal_shims()
    cfgs = {"moe": get_arch("mixtral-8x7b").reduced(),
            "whisper": get_arch("whisper-tiny").reduced(),
            "vision": dataclasses.replace(
                get_arch("llama-3.2-vision-11b").reduced(), n_layers=4)}
    rram = RRAMBackendConfig(enabled=True, dw_dtype="float32", cell_rows=32,
                             cell_cols=32)
    t0 = time.perf_counter()
    counts = chip_smoke.families_phase(
        torch.device("cpu"), [], cfgs=cfgs, rram=rram,
        moe_request=(4, 8, 4, 16), expert_tokens=(4, 64),
        whisper_request=(1, 4, 3, 16), frames=40,
        whisper_rt_kw=REHEARSAL_RT_KW | {"q_chunk": 8, "kv_chunk": 8},
        vision_request=(1, 4, 3, 16), profile_steps=2)
    print(f"rehearsal of phase 13 (mixtral-8x7b, whisper-tiny, "
          f"llama-3.2-vision-11b reduced) on the CPU passed in "
          f"{time.perf_counter() - t0:.1f} s; calls "
          f"{ {k: v for k, v in counts.items() if v} }")


def rehearse_recurrent(args) -> None:
    """chip_smoke.py's phase 14 at the reduced rwkv6-1.6b (4 x 8 -> 4, then
    1 x 64 -> 3: two chunks of the inter-chunk scan) and zamba2-1.2b at 5
    layers (4 x 8 -> 4), the chunked forms alone over 64 tokens, cells of
    32^2."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RRAMBackendConfig

    chip_smoke = _rehearsal_shims()
    cfgs = {"rwkv6": get_arch("rwkv6-1.6b").reduced(),
            "zamba2": dataclasses.replace(get_arch("zamba2-1.2b").reduced(),
                                          n_layers=5)}
    rram = RRAMBackendConfig(enabled=True, dw_dtype="float32", cell_rows=32,
                             cell_cols=32)
    t0 = time.perf_counter()
    counts = chip_smoke.recurrent_phase(
        torch.device("cpu"), [], cfgs=cfgs, rram=rram,
        rwkv_requests=((4, 8, 4, 16), (1, 64, 3, 72)),
        zamba_request=(4, 8, 4, 16), scan_tokens=64, profile_steps=2)
    print(f"rehearsal of phase 14 (rwkv6-1.6b, zamba2-1.2b reduced) on "
          f"the CPU passed in {time.perf_counter() - t0:.1f} s; calls "
          f"{ {k: v for k, v in counts.items() if v} }")


def host(args, dev=None, cfg=None) -> int:
    """``dev`` / ``cfg`` default to the card and phase 12's model."""
    if dev is None and not torch.cuda.is_available():
        print("lm_probe: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    import cProfile
    import dataclasses
    import pstats
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import Runtime
    from repro_torch.train.serve import Server
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = dev or torch.device("cuda")
    cfg = cfg or dataclasses.replace(get_arch(chip_smoke.LM_ARCH).model,
                                     param_dtype="float32",
                                     compute_dtype="float32")
    b, t, _, ml = chip_smoke.LM_REQUESTS[0]
    params = PM.materialize(tf.init_specs(cfg), chip_smoke.LM_SEED,
                            device=dev)
    srv = Server(tf, cfg, params, rt=Runtime(
        rram=RRAMBackendConfig(enabled=True, dw_dtype="float32"),
        key=chip_smoke.LM_DAC_KEY, **chip_smoke.LM_RT_KW), max_len=ml)
    tokens = torch.randint(0, cfg.vocab, (b, t), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(chip_smoke.LM_SEED + 10))
    tok, caches = srv.prefill({"tokens": tokens})
    tok, caches = srv.decode_tokens(tok[:, :1], caches, 2)   # warm
    torch.cuda.synchronize()

    def steps():
        nonlocal tok, caches
        for _ in range(args.steps):
            toks, caches = srv.decode_tokens(tok[:, -1:], caches, 1)
            tok = toks
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    steps()
    wall = (time.perf_counter() - t0) * 1e3 / args.steps
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    steps()
    prof.disable()
    profiled = (time.perf_counter() - t0) * 1e3 / args.steps
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    print(f"device: {name}; a decode step at {b} "
          f"rows: {wall:.2f} ms wall, {profiled:.2f} ms under cProfile "
          f"({args.steps} steps each)", flush=True)
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:25]
    print(f"{'own ms':>9} {'cum ms':>9} {'calls':>7}  function (a step)")
    for (fname, line, func), (_, calls, own, cum, _) in rows:
        where = f"{Path(fname).name}:{line}" if line else fname
        print(f"{own * 1e3 / args.steps:9.3f} {cum * 1e3 / args.steps:9.3f} "
              f"{calls // args.steps:7d}  {func} ({where})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("host", "rehearse",
                                     "rehearse-families",
                                     "rehearse-recurrent"))
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    if args.what == "host":
        return host(args)
    if args.what == "rehearse":
        rehearse(args)
    elif args.what == "rehearse-families":
        rehearse_families(args)
    else:
        rehearse_recurrent(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
