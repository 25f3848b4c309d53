"""The (train | prefill | decode) step of an (arch x shape x mesh) cell (of
:mod:`repro.launch.steps`): the function, its abstract arguments, and the
in / out shardings.

The arguments are ``device="meta"`` tensors (shapes and dtypes, nothing
allocated; a cache's ``len`` and the optimizer's ``count`` are host
tensors, as the port keeps them) and the shardings are
:class:`~repro_torch.distributed.sharding.NamedSharding` records, which
equal the reference's specs.  The function runs eagerly on real tensors;
every rank of the port's mesh shares one device, so the shardings place
nothing.  Where the reference asks ``jax.eval_shape`` for a prefill's
outputs, the port runs nothing: the caches it shards are the family's
``init_caches(b, max_len)`` (a meta run could not read the host ``len``
a prefill reads).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import SHAPES, ArchConfig, RRAMBackendConfig, TrainConfig
from ..configs.registry import (batch_specs, decode_cache_len,
                                decode_cache_specs, model_module)
from ..distributed.sharding import (NamedSharding, P, batch_pspec,
                                    cache_pspecs, data_axes, mesh_axis_sizes,
                                    param_pspecs)
from ..models import params as PM
from ..models.common import Runtime
from ..models.rram import program_specs
from ..train.optimizer import OptState, adamw_init
from ..train.train_loop import make_train_step
from .mesh import Mesh

__all__ = ["CellSpec", "build_cell", "make_runtime"]


@dataclasses.dataclass
class CellSpec:
    """Everything needed to run one cell."""
    fn: Any                      # the step
    args: Tuple                  # abstract (meta tensor) args
    in_shardings: Tuple
    out_shardings: Any
    donate: Tuple[int, ...] = ()
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


def make_runtime(mesh: Mesh, rram: Optional[RRAMBackendConfig] = None,
                 **kw) -> Runtime:
    kw.setdefault("q_chunk", 512)     # bounds flash-attention block buffers
    kw.setdefault("kv_chunk", 512)
    return Runtime(rram=rram, mesh=mesh, batch_axes=data_axes(mesh),
                   key=None, **kw)


def _ns(mesh: Mesh, tree):
    return PM.tree_map(lambda ps: NamedSharding(mesh, ps), tree)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def build_cell(arch: ArchConfig, shape_name: str, mesh: Mesh,
               *,
               rram: Optional[RRAMBackendConfig] = None,
               tcfg: Optional[TrainConfig] = None,
               reduced: bool = False,
               runtime_kw: Optional[Dict] = None) -> CellSpec:
    shape = SHAPES[shape_name]
    cfg = arch.reduced() if reduced else arch.model
    mod = model_module(cfg)
    runtime_kw = dict(runtime_kw or {})
    if shape.kind == "train":
        # Skip fully masked KV chunks on train sequences (the reference's
        # static causal skip).
        runtime_kw.setdefault("causal_skip", True)
    rt = make_runtime(mesh, rram=rram, **runtime_kw)
    pd = PM.torch_dtype(cfg.param_dtype)

    specs = mod.init_specs(cfg)
    if rram is not None and rram.enabled:
        specs = program_specs(specs, rram)
    params_abs = PM.tree_map(
        lambda s: _meta(s.shape, PM.torch_dtype(s.dtype or pd)), specs)
    vocab_ok = cfg.vocab % mesh_axis_sizes(mesh)["model"] == 0

    if shape.kind == "train":
        pspecs = param_pspecs(specs, mesh, arch.train_sharding)
        opt_abs = adamw_init(params_abs)
        # ZeRO: optimizer state follows the FSDP rules even if params are TP.
        zero = _ns(mesh, param_pspecs(specs, mesh, "fsdp_tp"))
        opt_sh = OptState(m=zero, v=zero, count=NamedSharding(mesh, P()))
        bspecs = batch_specs(arch, shape, reduced)
        bps = PM.tree_map(
            lambda l: batch_pspec(l.shape, mesh, shape.global_batch), bspecs)
        dsz = 1
        for a in data_axes(mesh):
            dsz *= mesh_axis_sizes(mesh)[a]
        # 16 accumulation steps bound the live activations; the microbatch
        # stays divisible by the data-parallel degree.
        micro = max(shape.global_batch // 16, dsz)
        tcfg = tcfg or TrainConfig(microbatch=micro, remat="block")
        fn = make_train_step(mod, cfg, tcfg, rt, grad_shardings=zero)
        metrics_sh = {"loss": P(), "grad_norm": P(), "lr": P()}
        return CellSpec(
            fn=fn,
            args=(params_abs, opt_abs, bspecs),
            in_shardings=(_ns(mesh, pspecs), opt_sh, _ns(mesh, bps)),
            out_shardings=(_ns(mesh, pspecs), opt_sh,
                           _ns(mesh, metrics_sh)),
            donate=(0, 1),
            meta={"kind": "train",
                  "tokens": shape.global_batch * shape.seq_len},
        )

    # Inference sharding: TP keeps the weights resident.
    pspecs = param_pspecs(specs, mesh, arch.infer_sharding)

    if shape.kind == "prefill":
        bspecs = batch_specs(arch, shape, reduced)
        bps = PM.tree_map(
            lambda l: batch_pspec(l.shape, mesh, shape.global_batch), bspecs)
        max_len = decode_cache_len(cfg, shape)

        def prefill_fn(params, batch):
            if cfg.family == "rwkv6":
                return mod.prefill(params, batch, cfg, rt)
            return mod.prefill(params, batch, cfg, rt, max_len)

        # The prefill's caches are init_caches(b, max_len)'s: those a
        # decode step takes.
        caches_abs = decode_cache_specs(arch, shape, reduced)
        logits_sh = P(data_axes(mesh), None, "model" if vocab_ok else None)
        cache_sh = cache_pspecs(caches_abs, mesh, shape.global_batch)
        return CellSpec(
            fn=prefill_fn,
            args=(params_abs, bspecs),
            in_shardings=(_ns(mesh, pspecs), _ns(mesh, bps)),
            out_shardings=(NamedSharding(mesh, logits_sh),
                           _ns(mesh, cache_sh)),
            meta={"kind": "prefill",
                  "tokens": shape.global_batch * shape.seq_len},
        )

    # decode
    caches_abs = decode_cache_specs(arch, shape, reduced)
    tokens_abs = _meta((shape.global_batch, 1), torch.int32)
    cache_sh = cache_pspecs(caches_abs, mesh, shape.global_batch)
    tok_sh = batch_pspec(tokens_abs.shape, mesh, shape.global_batch)

    def decode_fn(params, tokens, caches):
        return mod.decode_step(params, tokens, caches, cfg, rt)

    logits_sh = P(data_axes(mesh) if shape.global_batch > 1 else None,
                  None, "model" if vocab_ok else None)
    return CellSpec(
        fn=decode_fn,
        args=(params_abs, tokens_abs, caches_abs),
        in_shardings=(_ns(mesh, pspecs), NamedSharding(mesh, tok_sh),
                      _ns(mesh, cache_sh)),
        out_shardings=(NamedSharding(mesh, logits_sh), _ns(mesh, cache_sh)),
        donate=(2,),
        meta={"kind": "decode", "tokens": shape.global_batch},
    )
