"""End-to-end training on the PyTorch/CUDA port: data pipeline -> train step
-> checkpointing / preemption / watchdog, on any --arch from the registry
(the twin of examples/train_lm.py).

    PYTHONPATH=src python examples/train_lm_torch.py                  # GPU
    PYTHONPATH=src python examples/train_lm_torch.py --torch-device cpu
    PYTHONPATH=src python examples/train_lm_torch.py --preset 100m --steps 300
    PYTHONPATH=src python examples/train_lm_torch.py --arch qwen3-8b \\
        --steps 5 --preset reduced   # any arch, reduced config

The ``100m`` preset is a ~112M-parameter qwen3-family model.  Batches are
the synthetic pipeline's (numpy's Philox stream keyed by seed and step),
put on the device by a prefetching thread; the step accumulates
``--batch / 2`` microbatches with block remat.  Checkpoints hold the
parameters and AdamW's state in the JAX package's layout (see --resume).

It runs on the GPU (``--torch-device cuda``, the default) and exits with an
error where there is none; the CPU is used only when asked for.
"""
import argparse
import dataclasses
import os
import sys
import tempfile

import torch

from repro_torch.configs import get_arch, model_module
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.data.pipeline import Prefetcher, batches
from repro_torch.distributed import CheckpointManager
from repro_torch.models import params as PM
from repro_torch.train import Trainer


def preset_config(name: str, arch_name: str) -> ModelConfig:
    if name == "reduced":
        return get_arch(arch_name).reduced()
    if name == "smoke":
        return dataclasses.replace(
            get_arch("qwen3-1.7b").reduced(), n_layers=4, d_model=128, d_ff=512)
    if name == "100m":
        return ModelConfig(
            family="transformer", n_layers=10, d_model=640, n_heads=10,
            n_kv_heads=5, d_head=64, d_ff=2560, vocab=32768, qk_norm=True,
            act="silu_gated", param_dtype="float32", compute_dtype="float32")
    raise ValueError(name)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--preset", default="smoke",
                    choices=["smoke", "100m", "reduced"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--torch-device", default="cuda",
                    help="where weights and activations live (default cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.torch_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("train_lm_torch: no CUDA device (torch.cuda.is_available() "
                 "is False); pass --torch-device cpu to run on the CPU")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    cfg = preset_config(args.preset, args.arch)
    mod = model_module(cfg)
    params = PM.materialize(mod.init_specs(cfg), 0,
                            PM.torch_dtype(cfg.param_dtype), device=dev)
    n_params = sum(p.numel() for _, p in PM.tree_paths(params))
    print(f"arch={args.arch} preset={args.preset} params={n_params/1e6:.1f}M")

    tcfg = TrainConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps,
                       microbatch=max(args.batch // 2, 1))
    ckpt = CheckpointManager(args.ckpt_dir, keep_n=2)
    trainer = Trainer(mod, cfg, tcfg, params, ckpt=ckpt,
                      ckpt_every=args.ckpt_every)
    if args.resume and ckpt.latest_step() is not None:
        trainer.restore()
        print(f"resumed from step {trainer.step}")

    data = Prefetcher(batches(cfg, args.batch, args.seq,
                              start_step=trainer.step), device=dev)
    hist = trainer.run(data, args.steps)
    data.stop()
    losses = hist["loss"]
    for i in range(0, len(losses), max(len(losses) // 10, 1)):
        print(f"step {trainer.step - len(losses) + i + 1:>5}  "
              f"loss {losses[i]:.4f}  ({hist['step_time'][i]*1e3:.0f} ms)")
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f}); "
          f"straggler events: {len(trainer.watchdog.events)}")
    trainer.save(blocking=True)
    print(f"checkpointed at step {trainer.step} -> {args.ckpt_dir}")


if __name__ == "__main__":
    main()
