"""Llama-3.2-Vision-11B text backbone of the port (of
:mod:`repro.models.llama_vision`): a llama-style decoder with gated
cross-attention image layers, one after every ``cross_attn_every - 1``
self-attention layers (8 super layers of 4 + 1 in the 40-layer config).
The vision encoder is a stub: the batch carries precomputed patch
embeddings ``patches`` (B, n_patches, d_model).

A cross layer attends to the patches with no mask through a tanh ``gate``
that is zero at init (the published warm start), so a freshly initialised
model's cross path adds nothing to its logits.  The caches carry the
patches, and every step projects them through ``wk`` / ``wv`` again, as the
reference does.

The self layers' parameters are stacked twice, ``(n_super, per, ...)``:
their kernels are 4-D, which ``program_rram`` leaves digital (as the
reference does); the cross layers' ``(n_super, d_in, d_out)`` kernels and
the head are programmed.

DAC keys: the reference nests two scans, each body traced once, so every
self layer of every super layer takes the inner body's salts, every cross
layer the salts after them, and the head the next one.  The loops here
restart the salt in the same way.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from . import transformer as base
from .common import (Runtime, attention, attention_specs, constrain_batch,
                     cross_entropy_loss, embed_spec, init_kv_cache,
                     layer_body, mlp, mlp_specs, rmsnorm, rmsnorm_spec,
                     rope_tables, unembed_spec)
from .params import stack_specs, torch_dtype, unstack

__all__ = ["init_specs", "loss", "forward", "prefill", "decode_step",
           "init_caches", "cross_layer_specs"]


def _layout(cfg: ModelConfig) -> Tuple[int, int]:
    per = cfg.cross_attn_every - 1          # self layers per super layer
    n_super = cfg.n_layers // cfg.cross_attn_every
    return n_super, per


def cross_layer_specs(cfg: ModelConfig) -> Dict:
    return {
        "ln": rmsnorm_spec(cfg.d_model),
        "attn": attention_specs(cfg, cross=True),
        "ln_mlp": rmsnorm_spec(cfg.d_model),
        "mlp": mlp_specs(cfg),
    }


def init_specs(cfg: ModelConfig) -> Dict:
    n_super, per = _layout(cfg)
    return {
        "embed": embed_spec(cfg.vocab_pad, cfg.d_model),
        "super": stack_specs(n_super, {
            "self": stack_specs(per, base.layer_specs(cfg)),
            "cross": cross_layer_specs(cfg),
        }),
        "ln_f": rmsnorm_spec(cfg.d_model),
        "lm_head": unembed_spec(cfg.d_model, cfg.vocab_pad),
    }


def _cross_apply(cp: Dict, x: torch.Tensor, patches: torch.Tensor,
                 cfg: ModelConfig, rt: Optional[Runtime]) -> torch.Tensor:
    a, _ = attention(cp["attn"], rmsnorm(cp["ln"], x, cfg.norm_eps), cfg, rt,
                     kv_x=patches, causal=False)
    x = x + a                           # the tanh gate is applied in attention
    m = mlp(cp["mlp"], rmsnorm(cp["ln_mlp"], x, cfg.norm_eps), cfg, rt)
    return x + m


def forward(params: Dict, tokens: torch.Tensor, patches: torch.Tensor,
            cfg: ModelConfig, rt: Optional[Runtime], positions=None,
            caches: Optional[Dict] = None):
    """tokens (B, T) -> (hidden (B, T, D), caches written in place)."""
    cd = torch_dtype(cfg.compute_dtype)
    x = constrain_batch(params["embed"][tokens.long()].to(cd), rt)
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)[None, :]
    tabs = rope_tables(positions, cfg.rope_theta, cfg.d_head) \
        if cfg.rope_theta else None
    first = rt._salt if rt is not None else 0
    for s, sp in enumerate(unstack(params["super"])):
        if rt is not None:
            rt._salt = first        # every super layer: the outer body's
        x = constrain_batch(x, rt)
        for i, lp in enumerate(unstack(sp["self"])):
            cache = None if caches is None else \
                {"k": caches["k"][s, i], "v": caches["v"][s, i],
                 "len": caches["len"][s, i]}
            # Every self layer: the inner body's salts (the reference
            # checkpoints the self layers only).
            x, cache = layer_body(rt, first, base.layer_apply, lp, x, cfg,
                                  rt, positions, cache, tabs)
            if caches is not None:
                caches["len"][s, i] = cache["len"]
        x = _cross_apply(sp["cross"], x, patches, cfg, rt)
    return rmsnorm(params["ln_f"], x, cfg.norm_eps), caches


def loss(params: Dict, batch: Dict, cfg: ModelConfig,
         rt: Optional[Runtime]) -> torch.Tensor:
    hidden, _ = forward(params, batch["tokens"], batch["patches"], cfg, rt)
    return cross_entropy_loss(base.logits_fn(params, hidden, cfg, rt),
                              batch["labels"])


def init_caches(batch: int, max_len: int, cfg: ModelConfig,
                device) -> Dict:
    """The self layers' caches stacked ``(n_super, per)``: ``k`` / ``v``
    (n_super, per, batch, max_len, kv, dh) on ``device``, ``len`` (n_super,
    per) int32 on the host."""
    n_super, per = _layout(cfg)
    one = init_kv_cache(batch, max_len, cfg, torch_dtype(cfg.compute_dtype),
                        device)
    return {name: t.expand((n_super, per) + t.shape).clone()
            for name, t in one.items()}


def prefill(params: Dict, batch: Dict, cfg: ModelConfig,
            rt: Optional[Runtime], max_len: int):
    """Prefill the prompt; the caches are ``{"kv": ..., "patches": ...}``."""
    tokens = batch["tokens"]
    caches = init_caches(tokens.shape[0], max_len, cfg, tokens.device)
    hidden, caches = forward(params, tokens, batch["patches"], cfg, rt,
                             caches=caches)
    logits = base.logits_fn(params, hidden[:, -1:], cfg, rt)
    return logits, {"kv": caches, "patches": batch["patches"]}


def decode_step(params: Dict, tokens: torch.Tensor, caches: Dict,
                cfg: ModelConfig, rt: Optional[Runtime]):
    cur = int(caches["kv"]["len"][0, 0])
    positions = torch.full(tokens.shape, cur, dtype=torch.int32,
                           device=tokens.device)
    hidden, kv = forward(params, tokens, caches["patches"], cfg, rt,
                         positions=positions, caches=caches["kv"])
    return base.logits_fn(params, hidden, cfg, rt), \
        {"kv": kv, "patches": caches["patches"]}
