"""Analytic MODEL_FLOPS per (arch x shape) (port of
:mod:`repro.analysis.model_flops`): the useful-compute yardstick a step's
measured rate is read against.

train:   6 * N * tokens            (N = params; N_active for MoE)
prefill: 2 * N * tokens  + attention term
decode:  2 * N * batch   + attention term (KV length = context)

Attention term: 4 * B * L * H * Dh * S_kv per query token (QK^T and PV), with
the causal 1/2 factor for full-sequence passes; window-clipped for SWA.
Embedding-gather FLOPs are ignored (standard convention).  Parameters are
counted over the shapes of :func:`repro_torch.models.params.abstract`:
nothing is allocated.
"""
from __future__ import annotations

import math
from typing import Dict

from ..configs.base import SHAPES, ArchConfig
from ..configs.registry import model_module
from ..models import params as PM

__all__ = ["param_count", "active_param_count", "model_flops"]


def param_count(arch: ArchConfig) -> int:
    cfg = arch.model
    specs = model_module(cfg).init_specs(cfg)
    leaves = PM.tree_paths(PM.abstract(specs))
    return int(sum(math.prod(leaf.shape) for _, leaf in leaves))


def active_param_count(arch: ArchConfig) -> int:
    """MoE: experts count only k/E of their parameters."""
    cfg = arch.model
    n = param_count(arch)
    if cfg.n_experts:
        expert_params = (cfg.n_layers * cfg.n_experts
                         * 3 * cfg.d_model * cfg.d_ff)
        frac = cfg.experts_per_token / cfg.n_experts
        n = n - int(expert_params * (1 - frac))
    return n


def _attn_flops(arch: ArchConfig, n_queries: int, s_kv: float) -> float:
    cfg = arch.model
    if cfg.family == "rwkv6":
        # WKV state update + readout: ~4 * H * Dk * Dv per token per layer.
        h = cfg.d_model // cfg.ssm_head_dim
        return 4.0 * n_queries * cfg.n_layers * h * cfg.ssm_head_dim ** 2
    if cfg.family == "zamba2":
        h = cfg.n_ssm_heads
        ssd = 4.0 * n_queries * cfg.n_layers * h * cfg.ssm_state \
            * cfg.ssm_head_dim
        n_attn = max(cfg.n_layers // cfg.attn_every, 1)
        attn = 4.0 * n_queries * n_attn * cfg.n_heads * cfg.d_head * s_kv
        return ssd + attn
    l_attn = cfg.n_layers + cfg.n_enc_layers
    return 4.0 * n_queries * l_attn * cfg.n_heads * cfg.d_head * s_kv


def model_flops(arch: ArchConfig, shape_name: str) -> Dict[str, float]:
    shape = SHAPES[shape_name]
    cfg = arch.model
    n = param_count(arch)
    n_act = active_param_count(arch)
    b, s = shape.global_batch, shape.seq_len
    window = cfg.swa_window or s

    if shape.kind == "train":
        tokens = b * s
        dense_f = 6.0 * n_act * tokens
        attn_f = 3.0 * _attn_flops(arch, tokens, min(s, window) / 2)
        return {"model_flops": dense_f + attn_f, "params": n,
                "active_params": n_act, "tokens": tokens}
    if shape.kind == "prefill":
        tokens = b * s
        dense_f = 2.0 * n_act * tokens
        attn_f = _attn_flops(arch, tokens, min(s, window) / 2)
        return {"model_flops": dense_f + attn_f, "params": n,
                "active_params": n_act, "tokens": tokens}
    # decode: one token per sequence against an s-long context
    tokens = b
    dense_f = 2.0 * n_act * tokens
    attn_f = _attn_flops(arch, tokens, min(s, window))
    return {"model_flops": dense_f + attn_f, "params": n,
            "active_params": n_act, "tokens": tokens}
