"""Chunked linear-attention recurrences of the port (of
:mod:`repro.models.linear_attention`): RWKV-6's WKV (per-channel
data-dependent decay) and Mamba-2's SSD (per-head scalar decay).

Both are the same algebra:  S_t = D_t . S_{t-1} + k_t v_t^T,  o_t = q_t^T S_*,
with D diagonal.  The chunked form computes each chunk of ``c`` tokens with
(c x c) / (c x D) matrix products and carries the state from chunk to chunk
in a Python loop over the ``T / c`` chunks (the reference's ``lax.scan``).

Numerics are the reference's separable form, kept on purpose: the
intra-chunk decay is ``exp(cum_prev) * exp(-cum)`` and the decay to the
chunk end ``exp(total - cum)``, with the per-token log-decay clamped to
``[LOG_CLAMP, -1e-6]`` (WKV) or ``[LOG_CLAMP, -1e-9]`` (SSD), so that for a
chunk of at most 64 tokens every exponent stays within float32's range.
The single-token steps clamp as the reference does: ``[LOG_CLAMP, -1e-6]``
(WKV), ``[LOG_CLAMP, 0]`` (SSD).  The state is float32; the outputs are
cast back to the input dtype.

Shapes: q/k (B, T, H, Dk), v (B, T, H, Dv), state (B, H, Dk, Dv).
RWKV: o_t reads S_{t-1} plus a (u . k_t) v_t bonus;  SSD: o_t reads S_t.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["chunked_wkv", "chunked_ssd", "wkv_decode_step",
           "ssd_decode_step", "LOG_CLAMP"]

LOG_CLAMP = -1.5
_F32 = torch.float32


def _chunk(x: torch.Tensor, c: int) -> torch.Tensor:
    b, t = x.shape[:2]
    return x.reshape((b, t // c, c) + tuple(x.shape[2:]))


def _check_chunk(t: int, chunk: int) -> None:
    # The reference asserts this (an AssertionError there too).
    if t % chunk != 0:
        raise AssertionError((t, chunk))


def chunked_wkv(
    r: torch.Tensor,            # (B, T, H, Dk) receptance (query)
    k: torch.Tensor,            # (B, T, H, Dk)
    v: torch.Tensor,            # (B, T, H, Dv)
    log_w: torch.Tensor,        # (B, T, H, Dk) per-channel log decay (<= 0)
    u: torch.Tensor,            # (H, Dk) current-token bonus
    state0: Optional[torch.Tensor] = None,   # (B, H, Dk, Dv)
    chunk: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 WKV. Returns (out (B, T, H, Dv), final_state)."""
    b, t, h, dk = r.shape
    dv = v.shape[-1]
    _check_chunk(t, chunk)
    c = chunk

    lw = log_w.to(_F32).clamp(LOG_CLAMP, -1e-6)
    rc = _chunk(r.to(_F32), c)     # (B, NC, c, H, Dk)
    kc = _chunk(k.to(_F32), c)
    vc = _chunk(v.to(_F32), c)
    lwc = _chunk(lw, c)

    cum = torch.cumsum(lwc, dim=2)                 # B_tau inclusive
    cum_prev = cum - lwc                           # B_{tau-1}
    total = cum[:, :, -1]                          # (B, NC, H, Dk)

    r_in = rc * torch.exp(cum_prev)                # decay from chunk start
    k_out = kc * torch.exp(-cum)                   # inverse decay
    k_end = kc * torch.exp(total[:, :, None] - cum)  # decay to chunk end

    # Intra-chunk scores: A[tau, s] = sum_d r'_tau k'_s, strictly lower-tri.
    scores = torch.einsum("bnchd,bnshd->bnhcs", r_in, k_out)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    scores = torch.where(tri, scores, 0.0)
    # Bonus diagonal (current token): r_tau . (u * k_tau).
    bonus = torch.einsum("bnchd,hd,bnchd->bnhc", rc, u.to(_F32), kc)
    out_intra = torch.einsum("bnhcs,bnshp->bnchp", scores, vc)
    out_intra = out_intra + bonus[..., None].permute(0, 1, 3, 2, 4) * vc

    # Inter-chunk: o_tau += (r_tau * exp(cum_prev))^T S_start, chunk by chunk.
    kv_end = torch.einsum("bnchd,bnchp->bnhdp", k_end, vc)   # state delta
    S = torch.zeros((b, h, dk, dv), dtype=_F32, device=r.device) \
        if state0 is None else state0.to(_F32)
    o_inter = []
    for n in range(t // c):
        o_inter.append(torch.einsum("bchd,bhdp->bchp", r_in[:, n], S))
        S = S * torch.exp(total[:, n])[..., None] + kv_end[:, n]
    o_inter = torch.stack(o_inter, dim=1)          # (B, NC, c, H, Dv)

    out = (out_intra + o_inter).reshape(b, t, h, dv)
    return out.to(r.dtype), S


def wkv_decode_step(r, k, v, log_w, u, state):
    """Single-token RWKV-6 step. r/k/v/log_w: (B, H, D*); state (B, H, Dk,
    Dv).  The output reads the old state plus the bonus."""
    rf, kf, vf = r.to(_F32), k.to(_F32), v.to(_F32)
    lw = log_w.to(_F32).clamp(LOG_CLAMP, -1e-6)
    att = state + (u.to(_F32)[None] * kf)[..., None] * vf[..., None, :]
    out = torch.einsum("bhd,bhdp->bhp", rf, att)
    state = state * torch.exp(lw)[..., None] + kf[..., None] * vf[..., None, :]
    return out.to(r.dtype), state


def chunked_ssd(
    q: torch.Tensor,            # (B, T, H, N)  (mamba2 C)
    k: torch.Tensor,            # (B, T, H, N)  (mamba2 B)
    v: torch.Tensor,            # (B, T, H, P)  (mamba2 x * dt)
    log_a: torch.Tensor,        # (B, T, H) per-head scalar log decay (<= 0)
    state0: Optional[torch.Tensor] = None,   # (B, H, N, P)
    chunk: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD. o_t includes the current token. Returns (out,
    final_state)."""
    b, t, h, n = q.shape
    p = v.shape[-1]
    _check_chunk(t, chunk)
    c = chunk

    la = log_a.to(_F32).clamp(LOG_CLAMP, -1e-9)
    qc = _chunk(q.to(_F32), c)
    kc = _chunk(k.to(_F32), c)
    vc = _chunk(v.to(_F32), c)
    lac = _chunk(la, c)

    cum = torch.cumsum(lac, dim=2)                 # (B, NC, c, H) inclusive
    total = cum[:, :, -1]

    # Separable inclusive intra decay: exp(L_tau - L_s) = exp(L_tau) exp(-L_s).
    q_dec = qc * torch.exp(cum)[..., None]
    k_inv = kc * torch.exp(-cum)[..., None]
    scores = torch.einsum("bnchd,bnshd->bnhcs", q_dec, k_inv)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    scores = torch.where(tri, scores, 0.0)         # inclusive of the diagonal
    out_intra = torch.einsum("bnhcs,bnshp->bnchp", scores, vc)

    k_end = kc * torch.exp(total[:, :, None] - cum)[..., None]
    kv_end = torch.einsum("bnchd,bnchp->bnhdp", k_end, vc)

    S = torch.zeros((b, h, n, p), dtype=_F32, device=q.device) \
        if state0 is None else state0.to(_F32)
    o_inter = []
    for i in range(t // c):
        o_inter.append(torch.einsum("bchd,bhdp->bchp", q_dec[:, i], S))
        S = S * torch.exp(total[:, i])[:, :, None, None] + kv_end[:, i]
    o_inter = torch.stack(o_inter, dim=1)

    out = (out_intra + o_inter).reshape(b, t, h, p)
    return out.to(q.dtype), S


def ssd_decode_step(q, k, v, log_a, state):
    """Single-token SSD step. q/k (B, H, N), v (B, H, P), log_a (B, H).
    The state is updated first, then read."""
    a = torch.exp(log_a.to(_F32).clamp(LOG_CLAMP, 0.0))
    state = state * a[..., None, None] + (k.to(_F32)[..., None]
                                          * v.to(_F32)[..., None, :])
    out = torch.einsum("bhd,bhdp->bhp", q.to(_F32), state)
    return out.to(q.dtype), state
