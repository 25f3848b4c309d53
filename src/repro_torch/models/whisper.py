"""Whisper-tiny backbone of the port (of :mod:`repro.models.whisper`): an
audio encoder-decoder whose conv / log-mel frontend is a stub -- the batch
carries precomputed frame embeddings ``frames`` (B, S, d_model).
Sinusoidal positions are added on both sides.

Encoder: bidirectional attention; decoder: causal self-attention,
cross-attention to the encoder states and a GELU MLP, pre-layernorm
throughout.  The decoder's cross-attention projects the encoder states
through ``wk`` / ``wv`` again at every step, as the reference does.

DAC keys: the reference scans the encoder's and the decoder's stacked
layers, each body traced once, so every encoder layer takes the encoder
body's salts, every decoder layer the decoder body's (after them), and the
head the next one.  The loops here restart the salt in the same way.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import ModelConfig
from . import transformer as base
from .common import (Runtime, attention, attention_specs, constrain_batch,
                     cross_entropy_loss, embed_spec, layer_body, layernorm,
                     layernorm_spec, mlp, mlp_specs, sinusoidal_positions,
                     unembed_spec)
from .params import stack_specs, torch_dtype, unstack

__all__ = ["init_specs", "loss", "encode", "decode", "prefill",
           "decode_step", "init_caches", "enc_layer_specs",
           "dec_layer_specs"]


def enc_layer_specs(cfg: ModelConfig) -> Dict:
    return {
        "ln_attn": layernorm_spec(cfg.d_model),
        "attn": attention_specs(cfg),
        "ln_mlp": layernorm_spec(cfg.d_model),
        "mlp": mlp_specs(cfg),
    }


def dec_layer_specs(cfg: ModelConfig) -> Dict:
    return {
        "ln_self": layernorm_spec(cfg.d_model),
        "self_attn": attention_specs(cfg),
        "ln_cross": layernorm_spec(cfg.d_model),
        "cross_attn": attention_specs(cfg),
        "ln_mlp": layernorm_spec(cfg.d_model),
        "mlp": mlp_specs(cfg),
    }


def init_specs(cfg: ModelConfig) -> Dict:
    return {
        "enc_layers": stack_specs(cfg.n_enc_layers, enc_layer_specs(cfg)),
        "enc_ln_f": layernorm_spec(cfg.d_model),
        "embed": embed_spec(cfg.vocab_pad, cfg.d_model),
        "dec_layers": stack_specs(cfg.n_layers, dec_layer_specs(cfg)),
        "dec_ln_f": layernorm_spec(cfg.d_model),
        "lm_head": unembed_spec(cfg.d_model, cfg.vocab_pad),
    }


def encode(params: Dict, frames: torch.Tensor, cfg: ModelConfig,
           rt: Optional[Runtime]) -> torch.Tensor:
    """frames (B, S, D) -> encoder states (B, S, D)."""
    pos = sinusoidal_positions(frames.shape[1], cfg.d_model,
                               device=frames.device).to(frames.dtype)
    x = constrain_batch(frames + pos[None], rt)
    first = rt._salt if rt is not None else 0
    for lp in unstack(params["enc_layers"]):
        # Every layer: the body's salts.
        x = layer_body(rt, first, _enc_layer, lp, x, cfg, rt)
    return layernorm(params["enc_ln_f"], x, cfg.norm_eps)


def _enc_layer(lp: Dict, x: torch.Tensor, cfg: ModelConfig,
               rt: Optional[Runtime]) -> torch.Tensor:
    a, _ = attention(lp["attn"], layernorm(lp["ln_attn"], x, cfg.norm_eps),
                     cfg, rt, causal=False)
    x = x + a
    return x + mlp(lp["mlp"], layernorm(lp["ln_mlp"], x, cfg.norm_eps),
                   cfg, rt)


def _dec_layer(lp: Dict, x: torch.Tensor, enc: torch.Tensor,
               cfg: ModelConfig, rt: Optional[Runtime], positions,
               cache: Optional[Dict]):
    a, cache = attention(lp["self_attn"],
                         layernorm(lp["ln_self"], x, cfg.norm_eps),
                         cfg, rt, positions=positions, cache=cache)
    x = x + a
    c, _ = attention(lp["cross_attn"],
                     layernorm(lp["ln_cross"], x, cfg.norm_eps),
                     cfg, rt, kv_x=enc)
    x = x + c
    x = x + mlp(lp["mlp"], layernorm(lp["ln_mlp"], x, cfg.norm_eps), cfg, rt)
    return x, cache


def decode(params: Dict, tokens: torch.Tensor, enc: torch.Tensor,
           cfg: ModelConfig, rt: Optional[Runtime], positions=None,
           caches: Optional[Dict] = None):
    """tokens (B, T) -> (hidden (B, T, D), caches written in place)."""
    cd = torch_dtype(cfg.compute_dtype)
    x = constrain_batch(params["embed"][tokens.long()].to(cd), rt)
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)[None, :]
    # The sinusoid at the (possibly dynamic) positions, the reference's own
    # spelling (it differs from sinusoidal_positions in its broadcast).
    d = cfg.d_model
    dim = torch.arange(d // 2, dtype=torch.float32,
                       device=x.device)[None, None, :]
    ang = positions[..., None].to(torch.float32) / (10_000.0 ** (2 * dim / d))
    x = x + torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(cd)

    first = rt._salt if rt is not None else 0
    for l, lp in enumerate(unstack(params["dec_layers"])):
        cache = None if caches is None else \
            {"k": caches["k"][l], "v": caches["v"][l],
             "len": caches["len"][l]}
        x, cache = layer_body(rt, first, _dec_layer, lp, x, enc, cfg, rt,
                              positions, cache)
        if caches is not None:
            caches["len"][l] = cache["len"]
    return layernorm(params["dec_ln_f"], x, cfg.norm_eps), caches


def loss(params: Dict, batch: Dict, cfg: ModelConfig,
         rt: Optional[Runtime]) -> torch.Tensor:
    enc = encode(params, batch["frames"], cfg, rt)
    hidden, _ = decode(params, batch["tokens"], enc, cfg, rt)
    logits = base.logits_fn(params, hidden, cfg, rt)
    return cross_entropy_loss(logits, batch["labels"])


# The decoder's stacked self-attention caches (the reference's own copy is
# the transformer's).
init_caches = base.init_caches


def prefill(params: Dict, batch: Dict, cfg: ModelConfig,
            rt: Optional[Runtime], max_len: int):
    """Encode the frames and prefill the decoder prompt.  The caches carry
    the encoder states (for cross-attention) beside the self-attention KV:
    ``{"kv": ..., "enc": ...}``."""
    enc = encode(params, batch["frames"], cfg, rt)
    tokens = batch["tokens"]
    kv = init_caches(tokens.shape[0], max_len, cfg, tokens.device)
    hidden, kv = decode(params, tokens, enc, cfg, rt, caches=kv)
    logits = base.logits_fn(params, hidden[:, -1:], cfg, rt)
    return logits, {"kv": kv, "enc": enc}


def decode_step(params: Dict, tokens: torch.Tensor, caches: Dict,
                cfg: ModelConfig, rt: Optional[Runtime]):
    cur = int(caches["kv"]["len"][0])
    positions = torch.full(tokens.shape, cur, dtype=torch.int32,
                           device=tokens.device)
    hidden, kv = decode(params, tokens, caches["enc"], cfg, rt,
                        positions=positions, caches=caches["kv"])
    logits = base.logits_fn(params, hidden, cfg, rt)
    return logits, {"kv": kv, "enc": caches["enc"]}
