"""Memory-bounded chunked attention (online softmax), plain PyTorch (port of
:mod:`repro.models.flash`; autograd differentiates it).

The reference has no attention kernel: its ``flash_attention`` streams KV
in chunks with running max / denominator accumulators under ``lax.scan``.
This is the same recurrence with the same chunking, masks and
``causal_skip`` schedule as Python loops over chunks, so the port matches
it to fp32 rounding (``scaled_dot_product_attention`` would sum otherwise).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["flash_attention"]

NEG_INF = -1e30


def _block_attn(q_blk, k_blk, v_blk, mask, m, l, acc):
    """One (q_chunk x kv_chunk) tile of the online-softmax recurrence.

    q_blk: (B, qc, KV, G, Dh) pre-scaled; k/v_blk: (B, kc, KV, Dh); mask:
    (B, 1, 1, qc, kc) bool or None (mask-free tile); m, l: (B, KV, G, qc)
    fp32; acc: (B, qc, KV, G, Dh) fp32.  Products are summed in fp32."""
    f32 = torch.float32
    s = torch.einsum("bqkgd,bskd->bkgqs", q_blk.to(f32), k_blk.to(f32))
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # Guard fully-masked rows: exp(NEG_INF - NEG_INF) would be exp(0) = 1.
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bkgqs,bskd->bqkgd", p.to(v_blk.dtype).to(f32),
                      v_blk.to(f32))
    acc_new = acc * alpha.permute(0, 3, 1, 2)[..., None] + pv
    return m_new, l_new, acc_new


def flash_attention(
    qg: torch.Tensor,            # (B, T, KV, G, Dh) -- grouped query heads
    k: torch.Tensor,             # (B, S, KV, Dh)
    v: torch.Tensor,             # (B, S, KV, Dh)
    q_pos: torch.Tensor,         # (B, T) integers
    kv_pos: torch.Tensor,        # (B, S) integers
    kv_valid,                    # (B, S) bool, or None == everything valid
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    causal_skip: bool = False,
) -> torch.Tensor:
    """Returns (B, T, KV, G, Dh), accumulated in fp32, cast to qg.dtype."""
    b, t, kv, g, dh = qg.shape
    s_len = k.shape[1]
    qc = min(q_chunk, t)
    kc = min(kv_chunk, s_len)
    if t % qc or s_len % kc:
        raise ValueError(f"chunks must divide the lengths: T {t} by "
                         f"{qc}, S {s_len} by {kc}")
    nq, nk = t // qc, s_len // kc
    cd = qg.dtype
    dev = qg.device

    qf = qg * torch.tensor(dh ** -0.5, dtype=qg.dtype)
    no_mask = (kv_valid is None) and not causal
    if kv_valid is None:
        kv_valid = torch.ones((b, s_len), dtype=torch.bool, device=dev)

    def q_block(i):
        return qf[:, i * qc:(i + 1) * qc], q_pos[:, i * qc:(i + 1) * qc]

    def kv_block(j):
        sl = slice(j * kc, (j + 1) * kc)
        return k[:, sl], v[:, sl], kv_pos[:, sl], kv_valid[:, sl]

    def mask_for(qp, kvp, valid):
        msk = valid[:, None, None, None, :]
        if causal:
            qq = qp[:, None, None, :, None]
            kk = kvp[:, None, None, None, :]
            msk = msk & (qq >= kk)
            if window:
                msk = msk & ((qq - kk) < window)
        return msk

    def init():
        f32 = torch.float32
        return (torch.full((b, kv, g, qc), NEG_INF, dtype=f32, device=dev),
                torch.zeros((b, kv, g, qc), dtype=f32, device=dev),
                torch.zeros((b, qc, kv, g, dh), dtype=f32, device=dev))

    def finish(l_, a_):
        return a_ / l_.clamp(min=1e-30).permute(0, 3, 1, 2)[..., None]

    outs = []
    if causal_skip and causal and nq == nk:
        # Static schedule: q chunk i attends kv chunks j_lo..i only.
        for i in range(nq):
            q_blk, qp = q_block(i)
            m_, l_, a_ = init()
            j_lo = max(0, (i * qc - window - kc + 1) // kc) if window else 0
            for j in range(j_lo, i + 1):
                k_blk, v_blk, kvp, valid = kv_block(j)
                m_, l_, a_ = _block_attn(q_blk, k_blk, v_blk,
                                         mask_for(qp, kvp, valid), m_, l_, a_)
            outs.append(finish(l_, a_))
    else:
        for i in range(nq):
            q_blk, qp = q_block(i)
            m_, l_, a_ = init()
            for j in range(nk):
                k_blk, v_blk, kvp, valid = kv_block(j)
                mask = None if no_mask else mask_for(qp, kvp, valid)
                m_, l_, a_ = _block_attn(q_blk, k_blk, v_blk, mask,
                                         m_, l_, a_)
            outs.append(finish(l_, a_))
    return torch.cat(outs, dim=1).to(cd)
