#!/usr/bin/env python3
"""Probe the port's LM serving path outside chip_smoke.py.

    python3 lm_probe.py host [--steps 4]
    python3 lm_probe.py rehearse [--arch qwen3-1.7b]
    python3 lm_probe.py rehearse-families
    python3 lm_probe.py rehearse-recurrent
    python3 lm_probe.py rehearse-train
    python3 lm_probe.py rehearse-serving
    python3 lm_probe.py rehearse-analysis
    python3 lm_probe.py rehearse-invariants
    python3 lm_probe.py rehearse-roofline [--full]
    python3 lm_probe.py rehearse-sharded
    python3 lm_probe.py serve-ab --other NAME=DIR [--other ...] [--reps 3]

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
``rehearse-train`` does it for phase 15 (``train_phase``) at the reduced
qwen3-1.7b: 10 steps of 4 x 16 tokens, a save and restore, the card's
gradient against the CPU's (both the CPU here), the dense gradient checks
at 8 / 13 rows and the programmed model's backward, counted.
``rehearse-serving`` runs phase 16 (``simulator_phase`` as the card runs
it, on the CPU; ``image_cache_phase`` at the reduced qwen3-1.7b, cells of
32^2, its trace at 50 requests a second), with the bytes of the live
tensors (found through ``gc``) standing in for the allocator's counts,
and replays the card's own [16b] schedule at full width on shapes alone
(``dry_cache_schedule``), which must evict and reprogram.
``rehearse-analysis`` runs phase 17 (``analysis_phase``) on the CPU on a
512^2 virtual operator of 64^2 capacity blocks (the reference registry's
small cells), with ``analysis.peak_bytes`` reporting 0 (no allocator).

``rehearse-invariants`` runs phase 18 (``invariants_phase``) on the CPU at
``scale="cpu"`` against the ``cpu`` section of ``INVARIANTS_torch.json``,
and prints the launches the counting wrappers saw (the card's ``cuda``
section counts the same kernels on the same small entries).

``rehearse-roofline`` runs phase 19 (``roofline_phase``) on the CPU at
small sizes: the ten kernel functions at small shapes, a 256^2 local MVM
and CG solve, phase 17's operator at 512^2 (64^2 blocks) and the reduced
qwen3-1.7b; every call counted by ``analysis.analyze_run`` (no device
numbers on the CPU).  ``--full`` runs it at the card's shapes, on the
host's CPU: the counts it prints on its ``[19] counts`` line are the ones
``chip_smoke.ROOFLINE_CPU_COUNTS`` holds the card to (about 30 GB of host
memory: run it where the host has room).

``rehearse-sharded`` runs phase 20 (``sharded_phase``) on the CPU at the
reduced mixtral-8x7b (its MoE tree on cells of 32^2, one layer trained,
small collectives) on the card's 1 x 1, 1 x 4 and 2 x 4 meshes.

``serve-ab`` times phase 12's serving on the card for this tree and the
trees named by ``--other NAME=DIR`` (roots of unpacked ``git archive``s,
whose package and kernels are imported and built from there) in turns:
the others in order, this tree twice, the others in reverse, each turn a
process of its own (``serve-times --src``).  A turn serves qwen3-1.7b at
full size, DAC on, programmed by its Server, warms each of phase 12's
requests, then times ``--reps`` times its prefill and its decode steps,
synchronised, on the host clock.  It prints each turn's medians and, per
tree, the median over its turns.  It needs a GPU.
"""
import argparse
import json
import statistics
import subprocess
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


def rehearse_train(args) -> None:
    """chip_smoke.py's phase 15 at the reduced qwen3-1.7b (2 layers,
    d_model 64; lr 2e-3 so that 10 steps learn), cells of 32^2."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RRAMBackendConfig

    chip_smoke = _rehearsal_shims()
    rram = RRAMBackendConfig(enabled=True, dw_dtype="float32", cell_rows=32,
                             cell_cols=32)
    t0 = time.perf_counter()
    counts = chip_smoke.train_phase(
        torch.device("cpu"), cfg=get_arch("qwen3-1.7b").reduced(),
        batch=(4, 16), tcfg_kw=dict(chip_smoke.TRAIN_TCFG, lr=2e-3),
        grad_tokens=13, dense_rows=(8, 13), rram=rram, profile_steps=2)
    print(f"rehearsal of phase 15 (qwen3-1.7b reduced) on the CPU passed "
          f"in {time.perf_counter() - t0:.1f} s; calls "
          f"{ {k: v for k, v in counts.items() if v} }")


def rehearse_analysis(args) -> None:
    """chip_smoke.py's phase 17 on a 512^2 virtual operator (2 x 2 MCAs
    of 32^2: 64 capacity blocks an MVM), on the 1 x 1 and 2 x 4 meshes."""
    from repro_torch import analysis
    from repro_torch.core import MCAGeometry

    chip_smoke = _rehearsal_shims()

    def no_peak(fn, *a, **kw):
        fn(*a, **kw)
        return 0

    analysis.peak_bytes = no_peak
    t0 = time.perf_counter()
    counts = chip_smoke.analysis_phase(torch.device("cpu"), n=512,
                                       geom=MCAGeometry(2, 2, 32, 32))
    print(f"rehearsal of [17] (512^2, 64^2 blocks) on the CPU passed in "
          f"{time.perf_counter() - t0:.1f} s; calls "
          f"{ {k: v for k, v in counts.items() if v} }")


def rehearse_invariants(args) -> None:
    """chip_smoke.py's phase 18 at ``scale="cpu"``, held to the manifest's
    ``cpu`` section."""
    chip_smoke = _rehearsal_shims()
    t0 = time.perf_counter()
    counts = chip_smoke.invariants_phase(torch.device("cpu"))
    print(f"rehearsal of [18] (scale cpu) on the CPU passed in "
          f"{time.perf_counter() - t0:.1f} s; calls "
          f"{ {k: v for k, v in counts.items() if v} }")


def rehearse_roofline(args) -> None:
    """chip_smoke.py's phase 19 on the CPU: at small sizes, or with
    ``--full`` at the card's (the CPU's counts for ROOFLINE_CPU_COUNTS)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.core import MCAGeometry

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    t0 = time.perf_counter()
    if args.full:
        chip_smoke.roofline_phase(torch.device("cpu"))
    else:
        chip_smoke.roofline_phase(
            torch.device("cpu"),
            kernel_shapes={"ec_matmul": (256, 192, 1),
                           "ec_rmatmul": (256, 192, 1),
                           "ec_group_matmul": (2, 96, 64, 1),
                           "ec_group_rmatmul": (2, 96, 64, 1),
                           "stencil_denoise": (512, 1),
                           "thomas_solve": (512, 1), "cg_update": (512, 1),
                           "richardson_update": (512, 1),
                           "encode_matmul": (16, 64, 96),
                           "encode_matmul_rng": (16, 64, 96)},
            n=256, analysis_n=512, geom=MCAGeometry(2, 2, 32, 32),
            lm_cfg=get_arch("qwen3-1.7b").reduced(),
            rram=RRAMBackendConfig(enabled=True, dw_dtype="float32",
                                   cell_rows=32, cell_cols=32),
            lm_requests=((4, 8, 16), (1, 24, 32)),
            lm_rt_kw=REHEARSAL_RT_KW)
    print(f"rehearsal of [19] ({'full' if args.full else 'small'} sizes) "
          f"on the CPU passed in {time.perf_counter() - t0:.1f} s")


def rehearse_sharded(args) -> None:
    """chip_smoke.py's phase 20 at the reduced mixtral-8x7b (d_model 64,
    d_ff 128, 4 experts): the MoE tree on cells of 32^2, x of 1 x 4 and 2
    x 16 tokens, one layer trained on 2 x 4 and 2 x 32 tokens, a 64 x 32
    compressed_psum and a 16 x 64 @ 64 x 32 ring."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RRAMBackendConfig

    chip_smoke = _rehearsal_shims()
    chip_smoke.card_line = lambda: "CPU rehearsal"
    cfg = get_arch("mixtral-8x7b").reduced()
    rram = RRAMBackendConfig(enabled=True, dw_dtype="float32", cell_rows=32,
                             cell_cols=32)
    t0 = time.perf_counter()
    counts = chip_smoke.sharded_phase(
        torch.device("cpu"), cfg=cfg, rram=rram, moe_inputs=((1, 4), (2, 16)),
        train_cfg=dataclasses.replace(cfg, n_layers=1), train_big=(2, 32),
        psum_shape=(64, 32), ring=(16, 64, 32))
    print(f"rehearsal of phase 20 (mixtral-8x7b reduced) on the CPU passed "
          f"in {time.perf_counter() - t0:.1f} s; calls "
          f"{ {k: v for k, v in counts.items() if v} }")


def live_tensor_bytes() -> int:
    """Bytes of every storage a live tensor holds: the CPU's stand-in for
    ``torch.cuda.memory_allocated``."""
    import gc
    gc.collect()
    storages = {}
    for obj in gc.get_objects():
        if isinstance(obj, torch.Tensor) and obj.device.type != "meta":
            st = obj.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
    return sum(storages.values())


def rehearse_serving(args) -> None:
    """chip_smoke.py's phase 16: [16a] at its own sizes (the reduced models
    it serves), [16b] at the reduced qwen3-1.7b, cells of 32^2, and the
    card's [16b] schedule at full width on shapes alone."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RRAMBackendConfig

    chip_smoke = _rehearsal_shims()
    rram = RRAMBackendConfig(enabled=True, dw_dtype="float32", cell_rows=32,
                             cell_cols=32)
    stats = chip_smoke.dry_cache_schedule(*chip_smoke.cache_model(),
                                          chip_smoke.CACHE_TRAFFIC)
    print(f"the card's [16b] schedule on shapes: {stats}")
    chip_smoke.check(stats["evictions"] >= 1 and stats["reprograms"] >= 1,
                     "the card's [16b] trace neither evicts nor reprograms")
    t0 = time.perf_counter()
    counts = chip_smoke.simulator_phase(torch.device("cpu"))
    print(f"rehearsal of [16a] passed in {time.perf_counter() - t0:.1f} s; "
          f"calls { {k: v for k, v in counts.items() if v} }")
    t0 = time.perf_counter()
    counts = chip_smoke.image_cache_phase(
        torch.device("cpu"), cfg=get_arch("qwen3-1.7b").reduced(), rram=rram,
        traffic_kw=dict(chip_smoke.CACHE_TRAFFIC, rate_rps=50.0),
        allocated=live_tensor_bytes, peak=live_tensor_bytes)
    print(f"rehearsal of [16b] (qwen3-1.7b reduced) on the CPU passed in "
          f"{time.perf_counter() - t0:.1f} s; calls "
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


def serve_times(args) -> int:
    """One turn of ``serve-ab``: phase 12's requests served by the package
    under ``args.src``; prints one JSON line of medians."""
    if not torch.cuda.is_available():
        print("lm_probe: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RRAMBackendConfig
    from repro_torch.models import params as PM
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import Runtime
    from repro_torch.train.serve import Server
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_arch(chip_smoke.LM_ARCH).model,
                              param_dtype="float32", compute_dtype="float32")
    params = PM.materialize(tf.init_specs(cfg), chip_smoke.LM_SEED,
                            device=dev)
    rt = Runtime(rram=RRAMBackendConfig(enabled=True, dw_dtype="float32"),
                 key=chip_smoke.LM_DAC_KEY, **chip_smoke.LM_RT_KW)
    prog = Server(tf, cfg, params, rt=rt, max_len=16).params
    del params
    out = {"src": str(Path(args.src).resolve()),
           "package": str(Path(tf.__file__).resolve().parents[3])}
    for i, (b, t, n, ml) in enumerate(chip_smoke.LM_REQUESTS):
        srv = Server(tf, cfg, prog, rt=rt, max_len=ml)
        batch = {"tokens": torch.randint(
            0, cfg.vocab, (b, t), device=dev,
            generator=torch.Generator(device=dev).manual_seed(
                chip_smoke.LM_SEED + 10 + i))}
        srv.generate(batch, 3)                                # warm
        pre, dec = [], []
        for _ in range(args.reps):
            p, d = chip_smoke.serve_times(srv, batch, n)
            pre += p
            dec.append(d)
        out[f"{b}x{t}"] = {"prefill_ms": statistics.median(pre),
                           "decode_ms": statistics.median(dec),
                           "prefill_all": pre, "decode_all": dec}
    print("SERVE_TIMES " + json.dumps(out), flush=True)
    return 0


def serve_ab(args) -> int:
    """Turns of ``serve-times``: each ``--other`` tree in the order given,
    this tree twice, the others in reverse."""
    if not torch.cuda.is_available():
        print("lm_probe: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    trees = dict(o.split("=", 1) for o in args.other)
    trees = {name: Path(d).resolve() for name, d in trees.items()}
    names = list(trees)
    trees["change"] = ROOT
    got = {name: [] for name in trees}
    for name in names + ["change", "change"] + names[::-1]:
        run = subprocess.run(
            [sys.executable, str(ROOT / "lm_probe.py"), "serve-times",
             "--src", str(trees[name]), "--reps", str(args.reps)],
            capture_output=True, text=True, timeout=900)
        line = [ln for ln in run.stdout.splitlines()
                if ln.startswith("SERVE_TIMES ")]
        if run.returncode or not line:
            print(run.stdout[-3000:], run.stderr[-3000:], file=sys.stderr)
            print(f"lm_probe: the {name} turn failed", file=sys.stderr)
            return 1
        res = json.loads(line[0].split(" ", 1)[1])
        got[name].append(res)
        print(f"{name} ({res['package']}): " + "; ".join(
            f"{k} prefill {v['prefill_ms']:.2f} ms, decode "
            f"{v['decode_ms']:.3f} ms a token" for k, v in res.items()
            if isinstance(v, dict)), flush=True)
    for name, runs in got.items():
        med = {k: [statistics.median(r[k][m] for r in runs)
                   for m in ("prefill_ms", "decode_ms")]
               for k in runs[0] if isinstance(runs[0][k], dict)}
        print(f"{name}, median of its turns: " + "; ".join(
            f"{k} prefill {p:.2f} ms, decode {d:.3f} ms a token"
            for k, (p, d) in med.items()), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("host", "rehearse",
                                     "rehearse-families",
                                     "rehearse-recurrent",
                                     "rehearse-train", "rehearse-serving",
                                     "rehearse-analysis",
                                     "rehearse-invariants",
                                     "rehearse-roofline",
                                     "rehearse-sharded", "serve-ab",
                                     "serve-times"))
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=DIR",
                    help="serve-ab: another tree's name and root")
    ap.add_argument("--src", default=str(ROOT),
                    help="serve-times: the tree whose package is served")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--full", action="store_true",
                    help="rehearse-roofline: the card's shapes")
    args = ap.parse_args(argv)
    if args.what == "host":
        return host(args)
    if args.what == "serve-ab":
        return serve_ab(args)
    if args.what == "serve-times":
        return serve_times(args)
    if args.what == "rehearse":
        rehearse(args)
    elif args.what == "rehearse-families":
        rehearse_families(args)
    elif args.what == "rehearse-recurrent":
        rehearse_recurrent(args)
    elif args.what == "rehearse-serving":
        rehearse_serving(args)
    elif args.what == "rehearse-analysis":
        rehearse_analysis(args)
    elif args.what == "rehearse-invariants":
        rehearse_invariants(args)
    elif args.what == "rehearse-roofline":
        rehearse_roofline(args)
    elif args.what == "rehearse-sharded":
        rehearse_sharded(args)
    else:
        rehearse_train(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
