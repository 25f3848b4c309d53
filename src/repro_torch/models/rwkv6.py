"""RWKV-6 "Finch" of the port (of :mod:`repro.models.rwkv6`): attention-free,
data-dependent decay.  rwkv6-1.6b.

Token-shift interpolation, the LoRA-produced per-channel decay
``log_w = -exp(w0 + tanh(x_w A_w) B_w)``, the WKV recurrence with the
current-token bonus ``u``, a per-head group norm, a gated output and the
squared-ReLU channel mix, as the reference has them (its simplifications
kept: static token-shift coefficients, rmsnorm, the decay clamp of
:mod:`.linear_attention`).  Training and prefill run the chunked WKV; a
decode step is the O(1)-state single-token step.

``w_lora_b`` is multiplied digitally (``@ w``), as in the reference: its
``(L, 64, d)`` stack is 3-D, so ``program_rram`` programs it, but its
image is never read.

DAC keys: the reference scans the stacked layers, so the layer body is
traced once and every layer's nine analog dense calls take salts 1-9 (time
mix ``wr``, ``wk``, ``wv``, ``wg``, ``w_lora_a``, ``wo``; channel mix
``wk``, ``wr``, ``wv``); the head takes the next.  The layer loop here
restarts the salt before each layer in the same way.

The caches are ``S`` (L, B, H, dh, dh) float32 and ``tm_x`` / ``cm_x``
(L, B, d) in the compute dtype; :func:`forward` writes them in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from . import transformer as base
from .common import (Runtime, constrain_batch, cross_entropy_loss, dense,
                     dense_spec, embed_spec, layer_body, rmsnorm,
                     rmsnorm_spec, unembed_spec)
from .linear_attention import chunked_wkv, wkv_decode_step
from .params import spec, stack_specs, torch_dtype, unstack

__all__ = ["init_specs", "loss", "forward", "prefill", "decode_step",
           "init_caches", "layer_specs", "layer_apply", "LORA_R"]

LORA_R = 64
_F32 = torch.float32


def _heads(cfg: ModelConfig) -> Tuple[int, int]:
    dh = cfg.ssm_head_dim
    return cfg.d_model // dh, dh


def layer_specs(cfg: ModelConfig) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    h, dh = _heads(cfg)
    return {
        "ln1": rmsnorm_spec(d),
        "ln2": rmsnorm_spec(d),
        "tm": {
            "mu_r": spec((d,), ("embed",), init="small"),
            "mu_k": spec((d,), ("embed",), init="small"),
            "mu_v": spec((d,), ("embed",), init="small"),
            "mu_g": spec((d,), ("embed",), init="small"),
            "mu_w": spec((d,), ("embed",), init="small"),
            "wr": dense_spec(d, d, axes=("embed", "heads")),
            "wk": dense_spec(d, d, axes=("embed", "heads")),
            "wv": dense_spec(d, d, axes=("embed", "heads")),
            "wg": dense_spec(d, d, axes=("embed", "heads")),
            "wo": dense_spec(d, d, axes=("heads", "embed")),
            "w0": spec((d,), ("heads",), init="small", scale=0.5),
            "w_lora_a": {"w": spec((d, LORA_R), ("embed", None),
                                   scale=0.01)},
            "w_lora_b": {"w": spec((LORA_R, d), (None, "heads"),
                                   scale=0.01)},
            "u": spec((h, dh), ("heads", None), init="small"),
            "gn_scale": spec((d,), ("heads",), init="ones"),
            "gn_bias": spec((d,), ("heads",), init="zeros"),
        },
        "cm": {
            "mu_k": spec((d,), ("embed",), init="small"),
            "mu_r": spec((d,), ("embed",), init="small"),
            "wk": dense_spec(d, f, axes=("embed", "mlp")),
            "wv": dense_spec(f, d, axes=("mlp", "embed")),
            "wr": dense_spec(d, d, axes=("embed", "embed")),
        },
    }


def init_specs(cfg: ModelConfig) -> Dict:
    return {
        "embed": embed_spec(cfg.vocab_pad, cfg.d_model),
        "layers": stack_specs(cfg.n_layers, layer_specs(cfg)),
        "ln_f": rmsnorm_spec(cfg.d_model),
        "lm_head": unembed_spec(cfg.d_model, cfg.vocab_pad),
    }


def _shift(x: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: the previous token's features (zeros, or the carried
    state, at t = 0)."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([first, x[:, :-1]], dim=1)


def _group_norm(p: Dict, x: torch.Tensor, eps: float = 1e-5
                ) -> torch.Tensor:
    """Per-head layernorm of the WKV output; x (B, T, H, Dh) -> (B, T, D)."""
    x32 = x.to(_F32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    b, t = x.shape[:2]
    y = y.reshape(b, t, -1)
    return (y * p["gn_scale"].to(_F32) + p["gn_bias"].to(_F32)).to(x.dtype)


def time_mix(p: Dict, x: torch.Tensor, cfg: ModelConfig,
             rt: Optional[Runtime], state: torch.Tensor,
             last_x: Optional[torch.Tensor], chunk: int = 32):
    """Returns (out, new_state, new_last_x). state (B, H, Dk, Dv)."""
    b, t, d = x.shape
    h, dh = _heads(cfg)
    xx = _shift(x, last_x) - x
    xr = x + xx * p["mu_r"].to(x.dtype)
    xk = x + xx * p["mu_k"].to(x.dtype)
    xv = x + xx * p["mu_v"].to(x.dtype)
    xg = x + xx * p["mu_g"].to(x.dtype)
    xw = x + xx * p["mu_w"].to(x.dtype)

    r = dense(p["wr"], xr, rt).reshape(b, t, h, dh)
    k = dense(p["wk"], xk, rt).reshape(b, t, h, dh)
    v = dense(p["wv"], xv, rt).reshape(b, t, h, dh)
    g = dense(p["wg"], xg, rt)

    # Data-dependent decay; w_lora_b is read digitally (its image is not).
    lora = torch.tanh(dense(p["w_lora_a"], xw, rt)) \
        @ p["w_lora_b"]["w"].to(x.dtype)
    log_w = -torch.exp(p["w0"].to(_F32) + lora.to(_F32))
    log_w = log_w.reshape(b, t, h, dh)

    if t == 1:
        out1, state = wkv_decode_step(r[:, 0], k[:, 0], v[:, 0],
                                      log_w[:, 0], p["u"], state)
        out = out1[:, None]
    else:
        out, state = chunked_wkv(r, k, v, log_w, p["u"], state0=state,
                                 chunk=min(chunk, t))
    out = _group_norm(p, out)
    out = dense(p["wo"], out * F.silu(g), rt)
    return out, state, x[:, -1]


def channel_mix(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                rt: Optional[Runtime], last_x: Optional[torch.Tensor]):
    xx = _shift(x, last_x) - x
    xk = x + xx * p["mu_k"].to(x.dtype)
    xr = x + xx * p["mu_r"].to(x.dtype)
    k = torch.relu(dense(p["wk"], xk, rt)).square()
    # The reference's order: sigmoid(dense(wr)) before dense(wv).
    gate = torch.sigmoid(dense(p["wr"], xr, rt))
    return gate * dense(p["wv"], k, rt), x[:, -1]


def _empty_state(b: int, cfg: ModelConfig, dtype, device) -> Dict:
    h, dh = _heads(cfg)
    return {
        "S": torch.zeros((b, h, dh, dh), dtype=_F32, device=device),
        "tm_x": torch.zeros((b, cfg.d_model), dtype=dtype, device=device),
        "cm_x": torch.zeros((b, cfg.d_model), dtype=dtype, device=device),
    }


def init_caches(b: int, cfg: ModelConfig, device) -> Dict:
    """Per-layer recurrent state stacked over the layers (no ``max_len``:
    the state does not grow with the context)."""
    one = _empty_state(b, cfg, torch_dtype(cfg.compute_dtype), device)
    return {name: t.expand((cfg.n_layers,) + t.shape).clone()
            for name, t in one.items()}


def layer_apply(lp: Dict, x: torch.Tensor, cfg: ModelConfig,
                rt: Optional[Runtime], state: Optional[Dict]):
    """``state`` None (training: fresh zeros) or one layer's dict."""
    x = constrain_batch(x, rt)
    st = state if state is not None else \
        _empty_state(x.shape[0], cfg, x.dtype, x.device)
    a, s_new, tm_x = time_mix(lp["tm"], rmsnorm(lp["ln1"], x, cfg.norm_eps),
                              cfg, rt, st["S"],
                              None if state is None else st["tm_x"])
    x = x + a
    c, cm_x = channel_mix(lp["cm"], rmsnorm(lp["ln2"], x, cfg.norm_eps),
                          cfg, rt, None if state is None else st["cm_x"])
    x = x + c
    return x, {"S": s_new, "tm_x": tm_x, "cm_x": cm_x}


def forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
            rt: Optional[Runtime], caches: Optional[Dict] = None):
    """tokens (B, T) -> (hidden (B, T, D), caches written in place)."""
    cd = torch_dtype(cfg.compute_dtype)
    x = constrain_batch(params["embed"][tokens.long()].to(cd), rt)
    first = rt._salt if rt is not None else 0
    for l, lp in enumerate(unstack(params["layers"])):
        st = None if caches is None else \
            {name: caches[name][l] for name in ("S", "tm_x", "cm_x")}
        # Every layer: the scan body's salts.
        x, new = layer_body(rt, first, layer_apply, lp, x, cfg, rt, st)
        if caches is not None:
            for name, t in new.items():
                caches[name][l] = t
    return rmsnorm(params["ln_f"], x, cfg.norm_eps), caches


def loss(params: Dict, batch: Dict, cfg: ModelConfig,
         rt: Optional[Runtime]) -> torch.Tensor:
    hidden, _ = forward(params, batch["tokens"], cfg, rt)
    logits = base.logits_fn(params, hidden, cfg, rt)
    return cross_entropy_loss(logits, batch["labels"])


def prefill(params: Dict, batch: Dict, cfg: ModelConfig,
            rt: Optional[Runtime], max_len=None):
    """``max_len`` is accepted and not read (the state is fixed-size).  A
    prompt longer than 32 tokens must be a multiple of 32 (the chunk)."""
    tokens = batch["tokens"]
    caches = init_caches(tokens.shape[0], cfg, tokens.device)
    hidden, caches = forward(params, tokens, cfg, rt, caches=caches)
    return base.logits_fn(params, hidden[:, -1:], cfg, rt), caches


def decode_step(params: Dict, tokens: torch.Tensor, caches: Dict,
                cfg: ModelConfig, rt: Optional[Runtime]):
    hidden, caches = forward(params, tokens, cfg, rt, caches=caches)
    return base.logits_fn(params, hidden, cfg, rt), caches
