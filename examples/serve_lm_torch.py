"""Batched serving on the PyTorch/CUDA port: prefill + greedy decode,
digital or on the RRAM analog backend (the twin of examples/serve_lm.py).

    PYTHONPATH=src python examples/serve_lm_torch.py --rram            # GPU
    PYTHONPATH=src python examples/serve_lm_torch.py --rram --torch-device cpu
    PYTHONPATH=src python examples/serve_lm_torch.py --rram --full     # GPU

With --rram the weights are programmed onto simulated crossbars once (the
one-time write energy / latency is printed) and every linear layer runs the
two-tier error-corrected analog product: on the card one ``ec_rmatmul``
launch per 8 rows and one ``stencil_denoise`` launch a layer.  The model is
the arch's reduced config (cells of 32 x 32, as the JAX example), or with
--full its published widths and depth in float32 (cells of 512 x 512, dw
in float32).  Weights are random, made from seed 0; whisper's frames and
llama-vision's patches (their frontends are stubs) are random too, made
from seed 2.  The recurrent families (``--arch rwkv6-1.6b`` /
``zamba2-1.2b``) take a prompt of at most 32 tokens or a multiple of 32
(the chunk of their recurrence).

It runs on the GPU (``--torch-device cuda``, the default) and exits with an
error where there is none; the CPU is used only when asked for.
"""
import argparse
import dataclasses
import sys
import time

import torch

from repro_torch.configs import get_arch, model_module
from repro_torch.configs.base import RRAMBackendConfig
from repro_torch.models import params as PM
from repro_torch.models.common import Runtime
from repro_torch.train.serve import Server


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--rram", action="store_true")
    ap.add_argument("--device", default="taox-hfox")
    ap.add_argument("--no-ec", action="store_true")
    ap.add_argument("--full", action="store_true",
                    help="the arch's full widths and depth, float32")
    ap.add_argument("--torch-device", default="cuda",
                    help="where weights and activations live (default cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.torch_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("serve_lm_torch: no CUDA device (torch.cuda.is_available() "
                 "is False); pass --torch-device cpu to run on the CPU")

    arch = get_arch(args.arch)
    if args.full:
        cfg = dataclasses.replace(arch.model, param_dtype="float32",
                                  compute_dtype="float32")
    else:
        cfg = arch.reduced()
    mod = model_module(cfg)
    params = PM.materialize(mod.init_specs(cfg), 0,
                            dtype=PM.torch_dtype(cfg.param_dtype), device=dev)

    rt = Runtime()
    if args.rram:
        cells = {} if args.full else {"cell_rows": 32, "cell_cols": 32}
        rt = Runtime(rram=RRAMBackendConfig(
            enabled=True, device=args.device, ec=not args.no_ec, k_iters=5,
            dw_dtype="float32" if args.full else "bfloat16", **cells),
            key=9)

    srv = Server(mod, cfg, params, rt=rt,
                 max_len=args.prompt_len + args.tokens + 8)
    if srv.write_stats is not None:
        print(f"analog programming: E={srv.write_stats.energy_j:.3e} J, "
              f"L={srv.write_stats.latency_s:.3e} s "
              f"(one-time, device={args.device})")

    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen).to(dev)
    batch = {"tokens": prompts}
    # The stubbed frontends' inputs: whisper's frame embeddings, one a
    # prompt token, and llama-vision's patch embeddings.
    gen = torch.Generator().manual_seed(2)
    if cfg.family == "whisper":
        batch["frames"] = torch.randn(args.batch, args.prompt_len,
                                      cfg.d_model, generator=gen).to(dev)
    if cfg.family == "llama_vision":
        batch["patches"] = torch.randn(args.batch, cfg.n_patches,
                                       cfg.d_model, generator=gen).to(dev)
    t0 = time.perf_counter()
    out = srv.generate(batch, args.tokens)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = args.batch * args.tokens
    print(f"arch={args.arch} backend={'rram' if args.rram else 'digital'} "
          f"batch={args.batch} full={args.full} torch_device={dev}")
    print(f"generated {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s incl. prefill)")
    print("first sequence:", out[0][:16].tolist())


if __name__ == "__main__":
    main()
