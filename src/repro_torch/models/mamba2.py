"""Mamba-2 block (SSD) of the port (of :mod:`repro.models.mamba2`), the
backbone of zamba2.

Block: in projections -> (z, x, B, C, dt); causal depthwise conv over
(x, B, C); silu; the SSD recurrence y = SSD(C, B, x * dt; a = exp(-exp(A_log)
dt)) + D * x; a gated rmsnorm with silu(z); the out projection.  n_groups = 1
(B / C shared across heads).  The projections are separate 2-D kernels
(wz / wx / wB / wC / wdt), each a :func:`dense` call in that order, then
``out``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import (Runtime, constrain_batch, dense, dense_spec, rmsnorm,
                     rmsnorm_spec)
from .linear_attention import chunked_ssd, ssd_decode_step
from .params import spec

__all__ = ["mamba_specs", "mamba_apply", "empty_state"]

_F32 = torch.float32


def mamba_specs(cfg: ModelConfig) -> Dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    conv_ch = di + 2 * n
    return {
        "ln": rmsnorm_spec(d),
        "wz": dense_spec(d, di, axes=("embed", "heads")),
        "wx": dense_spec(d, di, axes=("embed", "heads")),
        "wB": dense_spec(d, n, axes=("embed", "state")),
        "wC": dense_spec(d, n, axes=("embed", "state")),
        "wdt": dense_spec(d, h, axes=("embed", "heads")),
        "conv_w": spec((cfg.d_conv, conv_ch), (None, "heads"), init="small",
                       scale=0.1),
        "conv_b": spec((conv_ch,), ("heads",), init="zeros"),
        "dt_bias": spec((h,), ("heads",), init="small", scale=0.1),
        "A_log": spec((h,), ("heads",), init="small", scale=0.5),
        "D": spec((h,), ("heads",), init="ones"),
        "norm": {"scale": spec((di,), ("heads",), init="ones")},
        "out": dense_spec(di, d, axes=("heads", "embed")),
    }


def empty_state(b: int, cfg: ModelConfig, dtype, device) -> Dict:
    """Conv state (B, d_conv - 1, d_inner + 2N) in ``dtype``, SSM state
    (B, H, N, P) float32."""
    di, n, h, p_ = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, \
        cfg.ssm_head_dim
    conv_ch = di + 2 * n
    return {
        "conv": torch.zeros((b, cfg.d_conv - 1, conv_ch), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((b, h, n, p_), dtype=_F32, device=device),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 conv_state: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along time, the reference's sum of shifted
    products.  xbc (B, T, C); w (K, C).  The new state is the last K - 1
    steps of the padded sequence."""
    kw = w.shape[0]
    t = xbc.shape[1]
    pad = conv_state if conv_state is not None else \
        torch.zeros((xbc.shape[0], kw - 1, xbc.shape[2]), dtype=xbc.dtype,
                    device=xbc.device)
    xp = torch.cat([pad, xbc], dim=1)                   # (B, T+K-1, C)
    out = xp[:, 0:t] * w[0][None, None]
    for i in range(1, kw):
        out = out + xp[:, i:i + t] * w[i][None, None]
    new_state = xp[:, -(kw - 1):] if kw > 1 else pad[:, :0]
    return out + bias[None, None], new_state


def mamba_apply(p: Dict, x_in: torch.Tensor, cfg: ModelConfig,
                rt: Optional[Runtime], state: Optional[Dict]
                ) -> Tuple[torch.Tensor, Dict]:
    """x_in (B, T, D) -> (residual out, new state).  state None => zeros."""
    x_in = constrain_batch(x_in, rt)
    b, t, d = x_in.shape
    di, n, h, ph = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, \
        cfg.ssm_head_dim
    st = state if state is not None else \
        empty_state(b, cfg, x_in.dtype, x_in.device)

    u = rmsnorm(p["ln"], x_in, cfg.norm_eps)
    z = dense(p["wz"], u, rt)
    xr = dense(p["wx"], u, rt)
    br = dense(p["wB"], u, rt)
    cr = dense(p["wC"], u, rt)
    dt_raw = dense(p["wdt"], u, rt)

    xbc = torch.cat([xr, br, cr], dim=-1)
    xbc, conv_new = _causal_conv(xbc, p["conv_w"].to(xbc.dtype),
                                 p["conv_b"].to(xbc.dtype), st["conv"])
    xbc = F.silu(xbc)
    xr, br, cr = torch.split(xbc, [di, n, n], dim=-1)

    # softplus as jax.nn.softplus spells it: logaddexp(x, 0).
    pre = dt_raw.to(_F32) + p["dt_bias"].to(_F32)
    dt = torch.logaddexp(pre, torch.zeros_like(pre))    # (B, T, H)
    log_a = -torch.exp(p["A_log"].to(_F32)) * dt

    xh = xr.reshape(b, t, h, ph)
    v = xh * dt[..., None].to(xh.dtype)
    q = cr[:, :, None, :].expand(b, t, h, n)
    k = br[:, :, None, :].expand(b, t, h, n)

    if t == 1:
        y1, ssm_new = ssd_decode_step(q[:, 0], k[:, 0], v[:, 0],
                                      log_a[:, 0], st["ssm"])
        y = y1[:, None]
    else:
        y, ssm_new = chunked_ssd(q, k, v, log_a, state0=st["ssm"],
                                 chunk=min(32, t))
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(b, t, di)
    y = rmsnorm({"scale": p["norm"]["scale"]}, y, cfg.norm_eps) * F.silu(z)
    out = dense(p["out"], y, rt)
    return x_in + out, {"conv": conv_new, "ssm": ssm_new}
