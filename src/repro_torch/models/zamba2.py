"""Zamba2 hybrid of the port (of :mod:`repro.models.zamba2`): a Mamba-2
backbone with one *shared* full-attention block applied after every
``cfg.attn_every`` mamba blocks, fed the concat of the running hidden state
and the original embedding through a per-invocation input adapter.

Layout: ``n_layers // attn_every`` groups of ``attn_every`` mamba blocks,
stacked twice ``(groups, per, ...)``, with a shared-attention invocation
after each group, then a tail of ``n_layers % attn_every`` blocks stacked
once ``(tail, ...)``.

What is analog: ``program_rram`` programs a kernel named "w" only if it is
2-D or 3-D, so the grouped mamba blocks' 4-D kernels stay digital, in both
packages; the tail's blocks, both adapter stacks, the shared attention and
the head are programmed.

DAC keys: the reference's group loop is a Python loop, so each shared-block
invocation draws fresh salts (``ain``, ``wq``, ``wk``, ``wv``, ``wo``,
``aout``); the grouped mamba blocks draw none (digital); the tail is a
``lax.scan``, traced once, so both tail blocks take the same six salts;
the head takes the next.  Each mamba stack's loop here restarts the salt
before every block, as a scan's trace shares it; only the tail's blocks
draw.

The caches are ``groups`` (conv / ssm states stacked ``(groups, per)``),
``kv`` (the shared block's KV caches stacked over the groups, ``len`` on
the host) and ``tail``; :func:`forward` writes them in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from . import transformer as base
from .common import (Runtime, attention, attention_specs, constrain_batch,
                     cross_entropy_loss, dense, dense_spec, embed_spec,
                     init_kv_cache, layer_body, rmsnorm, rmsnorm_spec,
                     rope_tables, unembed_spec)
from .mamba2 import empty_state, mamba_apply, mamba_specs
from .params import stack_specs, torch_dtype, unstack

__all__ = ["init_specs", "loss", "forward", "prefill", "decode_step",
           "init_caches"]


def _layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    groups = cfg.n_layers // cfg.attn_every
    tail = cfg.n_layers % cfg.attn_every
    return groups, cfg.attn_every, tail


def init_specs(cfg: ModelConfig) -> Dict:
    groups, per, tail = _layout(cfg)
    d = cfg.d_model
    s = {
        "embed": embed_spec(cfg.vocab_pad, cfg.d_model),
        "groups": stack_specs(groups, stack_specs(per, mamba_specs(cfg))),
        "shared_attn": {
            "ln": rmsnorm_spec(2 * d),
            "attn": attention_specs(cfg),
        },
        "adapters_in": stack_specs(groups, dense_spec(
            2 * d, d, axes=("embed", "embed"))),
        "adapters_out": stack_specs(groups, dense_spec(
            d, d, axes=("embed", "embed"))),
        "ln_f": rmsnorm_spec(d),
        "lm_head": unembed_spec(d, cfg.vocab_pad),
    }
    if tail:
        s["tail"] = stack_specs(tail, mamba_specs(cfg))
    return s


def init_caches(b: int, max_len: int, cfg: ModelConfig, device) -> Dict:
    """``groups``: conv / ssm states (groups, per, b, ...); ``kv``: the
    shared block's caches, ``k`` / ``v`` (groups, b, max_len, kv, dh) on
    ``device`` and ``len`` (groups,) int32 on the host; ``tail``: (tail, b,
    ...) when the layout has one."""
    cd = torch_dtype(cfg.compute_dtype)
    groups, per, tail = _layout(cfg)
    one = empty_state(b, cfg, cd, device)
    kv = init_kv_cache(b, max_len, cfg, cd, device)
    caches = {
        "groups": {name: t.expand((groups, per) + t.shape).clone()
                   for name, t in one.items()},
        "kv": {name: t.expand((groups,) + t.shape).clone()
               for name, t in kv.items()},
    }
    if tail:
        caches["tail"] = {name: t.expand((tail,) + t.shape).clone()
                          for name, t in one.items()}
    return caches


def _mamba_stack(x: torch.Tensor, stacked: Dict, states: Optional[Dict],
                 cfg: ModelConfig, rt: Optional[Runtime]) -> torch.Tensor:
    """The reference's ``mamba_scan`` over the stacked blocks: every
    block takes the scan body's salts.  ``states`` (one entry per block)
    are written in place."""
    first = rt._salt if rt is not None else 0
    for i, lp in enumerate(unstack(stacked)):
        st = None if states is None else \
            {name: states[name][i] for name in ("conv", "ssm")}
        x, new = layer_body(rt, first, mamba_apply, lp, x, cfg, rt, st)
        if states is not None:
            for name, t in new.items():
                states[name][i] = t
    return x


def _shared_block(shared: Dict, x: torch.Tensor, x0: torch.Tensor,
                  ain: Dict, aout: Dict, cfg: ModelConfig,
                  rt: Optional[Runtime], positions, kv: Optional[Dict],
                  tabs):
    """One shared-attention invocation: its group's adapters around the
    shared block, fed ``concat(x, x0)``."""
    h = rmsnorm(shared["ln"], torch.cat([x, x0], dim=-1), cfg.norm_eps)
    h = dense(ain, h, rt)
    a_out, kv = attention(shared["attn"], h, cfg, rt, positions=positions,
                          cache=kv, rope_tabs=tabs)
    return x + dense(aout, a_out, rt), kv


def forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
            rt: Optional[Runtime], positions=None,
            caches: Optional[Dict] = None):
    """tokens (B, T) -> (hidden (B, T, D), caches written in place)."""
    cd = torch_dtype(cfg.compute_dtype)
    x0 = constrain_batch(params["embed"][tokens.long()].to(cd), rt)
    x = x0
    groups, _, tail = _layout(cfg)
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)[None, :]
    tabs = rope_tables(positions, cfg.rope_theta, cfg.d_head) \
        if cfg.rope_theta else None          # once for every invocation
    shared = params["shared_attn"]
    group_ps = unstack(params["groups"])
    ains = unstack(params["adapters_in"])
    aouts = unstack(params["adapters_out"])

    for g in range(groups):
        gst = None if caches is None else \
            {name: caches["groups"][name][g] for name in ("conv", "ssm")}
        # The grouped blocks are digital (4-D kernels): no salt is drawn.
        x = _mamba_stack(constrain_batch(x, rt), group_ps[g], gst, cfg, rt)
        # The shared attention invocation: fresh salts every group (and
        # its own remat, as the reference checkpoints it).
        kv = None if caches is None else \
            {name: caches["kv"][name][g] for name in ("k", "v", "len")}
        x, kv = layer_body(rt, None, _shared_block, shared,
                           constrain_batch(x, rt), x0, ains[g],
                           aouts[g], cfg, rt, positions, kv, tabs)
        if caches is not None:
            caches["kv"]["len"][g] = kv["len"]

    if tail:
        x = _mamba_stack(x, params["tail"],
                         None if caches is None else caches["tail"], cfg, rt)
    return rmsnorm(params["ln_f"], x, cfg.norm_eps), caches


def loss(params: Dict, batch: Dict, cfg: ModelConfig,
         rt: Optional[Runtime]) -> torch.Tensor:
    hidden, _ = forward(params, batch["tokens"], cfg, rt)
    return cross_entropy_loss(base.logits_fn(params, hidden, cfg, rt),
                              batch["labels"])


def prefill(params: Dict, batch: Dict, cfg: ModelConfig,
            rt: Optional[Runtime], max_len: int):
    tokens = batch["tokens"]
    caches = init_caches(tokens.shape[0], max_len, cfg, tokens.device)
    hidden, caches = forward(params, tokens, cfg, rt, caches=caches)
    return base.logits_fn(params, hidden[:, -1:], cfg, rt), caches


def decode_step(params: Dict, tokens: torch.Tensor, caches: Dict,
                cfg: ModelConfig, rt: Optional[Runtime]):
    cur = int(caches["kv"]["len"][0])
    positions = torch.full(tokens.shape, cur, dtype=torch.int32,
                           device=tokens.device)
    hidden, caches = forward(params, tokens, cfg, rt, positions=positions,
                             caches=caches)
    return base.logits_fn(params, hidden, cfg, rt), caches
