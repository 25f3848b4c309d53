"""Decoder-only transformer LM of the port (of
:mod:`repro.models.transformer`): yi-9b, qwen3-1.7b / 8b, nemotron-4-15b.

The parameters keep the reference's stacked layout (every layer leaf has a
leading ``(n_layers,)`` axis); :func:`forward` is a Python loop over the
layers that hands each one its views ``leaf[l]`` (:func:`.params.unstack`),
each layer through :func:`.common.layer_body` (remat under ``rt.remat``).  Interface:

  init_specs(cfg)                              -> spec tree
  loss(params, batch, cfg, rt)                 -> scalar CE
  prefill(params, batch, cfg, rt, max_len)     -> (last_logits, caches)
  decode_step(params, tokens, caches, cfg, rt) -> (logits, caches)

DAC keys: the reference scans the stacked layers, so its layer body is
traced once and every layer's i-th dense call takes the same salt.  The
loop here mirrors that on purpose: each layer starts from the same salt,
and after the loop the salt has moved on by one layer's count.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from .common import (
    NEG_INF, Runtime, attention, attention_specs, constrain_batch,
    cross_entropy_loss, dense, embed_spec, init_kv_cache, layer_body, mlp,
    mlp_specs, rmsnorm, rmsnorm_spec, rope_tables, unembed_spec,
)
from .params import stack_specs, torch_dtype, unstack

__all__ = ["init_specs", "loss", "forward", "logits_fn", "prefill",
           "decode_step", "init_caches", "layer_specs", "layer_apply"]


def layer_specs(cfg: ModelConfig) -> Dict:
    return {
        "ln_attn": rmsnorm_spec(cfg.d_model),
        "attn": attention_specs(cfg),
        "ln_mlp": rmsnorm_spec(cfg.d_model),
        "mlp": mlp_specs(cfg),
    }


def init_specs(cfg: ModelConfig) -> Dict:
    s = {
        "embed": embed_spec(cfg.vocab_pad, cfg.d_model),
        "layers": stack_specs(cfg.n_layers, layer_specs(cfg)),
        "ln_f": rmsnorm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = unembed_spec(cfg.d_model, cfg.vocab_pad)
    return s


def layer_apply(lp: Dict, x: torch.Tensor, cfg: ModelConfig,
                rt: Optional[Runtime], positions, cache: Optional[Dict],
                rope_tabs=None) -> Tuple[torch.Tensor, Optional[Dict]]:
    x = constrain_batch(x, rt)
    a, cache = attention(lp["attn"], rmsnorm(lp["ln_attn"], x, cfg.norm_eps),
                         cfg, rt, positions=positions, cache=cache,
                         rope_tabs=rope_tabs)
    x = x + a
    x = x + mlp(lp["mlp"], rmsnorm(lp["ln_mlp"], x, cfg.norm_eps), cfg, rt)
    return x, cache


def forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
            rt: Optional[Runtime], positions=None,
            caches: Optional[Dict] = None
            ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """tokens (B, T) -> hidden (B, T, D).  ``caches`` (from
    :func:`init_caches`) are written in place and returned."""
    cd = torch_dtype(cfg.compute_dtype)
    x = constrain_batch(params["embed"][tokens.long()].to(cd), rt)
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)[None, :]
    tabs = rope_tables(positions, cfg.rope_theta, cfg.d_head) \
        if cfg.rope_theta else None           # once for every layer
    first = rt._salt if rt is not None else 0
    for l, lp in enumerate(unstack(params["layers"])):
        cache = None if caches is None else \
            {"k": caches["k"][l], "v": caches["v"][l],
             "len": caches["len"][l]}
        # Every layer: the body's salts (remat recomputes it under them).
        x, cache = layer_body(rt, first, layer_apply, lp, x, cfg, rt,
                              positions, cache, tabs)
        if caches is not None:
            caches["len"][l] = cache["len"]
    return rmsnorm(params["ln_f"], x, cfg.norm_eps), caches


def logits_fn(params: Dict, hidden: torch.Tensor, cfg: ModelConfig,
              rt: Optional[Runtime]) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = hidden @ params["embed"].to(hidden.dtype).T
    else:
        logits = dense(params["lm_head"], hidden, rt)
    if cfg.vocab_pad != cfg.vocab:
        # Padded vocab columns (sharding alignment) are masked out.
        logits = logits.masked_fill(
            torch.arange(cfg.vocab_pad, device=logits.device) >= cfg.vocab,
            NEG_INF)
    return logits


def loss(params: Dict, batch: Dict, cfg: ModelConfig,
         rt: Optional[Runtime]) -> torch.Tensor:
    hidden, _ = forward(params, batch["tokens"], cfg, rt)
    logits = logits_fn(params, hidden, cfg, rt)
    return cross_entropy_loss(logits, batch["labels"])


def init_caches(batch: int, max_len: int, cfg: ModelConfig,
                device) -> Dict:
    """Stacked per-layer KV caches: ``k`` / ``v`` (L, batch, max_len, kv,
    dh) on ``device``, ``len`` (L,) int32 on the host."""
    one = init_kv_cache(batch, max_len, cfg, torch_dtype(cfg.compute_dtype),
                        device)
    return {name: t.expand((cfg.n_layers,) + t.shape).clone()
            for name, t in one.items()}


def prefill(params: Dict, batch: Dict, cfg: ModelConfig,
            rt: Optional[Runtime], max_len: int
            ) -> Tuple[torch.Tensor, Dict]:
    tokens = batch["tokens"]
    b, _ = tokens.shape
    caches = init_caches(b, max_len, cfg, tokens.device)
    hidden, caches = forward(params, tokens, cfg, rt, caches=caches)
    logits = logits_fn(params, hidden[:, -1:], cfg, rt)
    return logits, caches


def decode_step(params: Dict, tokens: torch.Tensor, caches: Dict,
                cfg: ModelConfig, rt: Optional[Runtime]
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens (B, 1) -> next-token logits (B, 1, V), appended caches."""
    cur = int(caches["len"][0])                 # uniform over layers
    positions = torch.full(tokens.shape, cur, dtype=torch.int32,
                           device=tokens.device)
    hidden, caches = forward(params, tokens, cfg, rt, positions=positions,
                             caches=caches)
    return logits_fn(params, hidden, cfg, rt), caches
