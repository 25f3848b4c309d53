"""Mixture-of-Experts transformer of the port (of :mod:`repro.models.moe`):
mixtral-8x7b, phi3.5-moe.

Token-choice top-k routing with sort-based dispatch: assignments are sorted
by expert id, positioned with a cumsum of counts, capacity-dropped and
scattered into an ``(E, C, D)`` buffer, so no ``(N, E, C)`` one-hot tensor
is built.  Two paths, as in the reference: the local one, and with
``rt.mesh`` set the tensor-parallel one (the reference's ``shard_map``:
the batch over the data axes, expert d_ff over the model axis, the
partial down-projections summed), run rank by rank on views of each
rank's blocks, every rank of the mesh on one device.

The expert stacks ``(E, D, F)`` are named ``"w"``.  In a model's stacked
layers they are 4-D ``(L, E, D, F)``, which ``program_rram`` leaves digital,
as the reference does; a single layer's MoE tree programmed on its own has
3-D stacks, and :func:`expert_mm` then runs the two-tier EC product on them:
one ``ec_group_rmatmul`` launch (per 8 capacity slots) over the E images and
one ``stencil_denoise`` on the ``(F, E * C)`` output panel.

DAC keys: ``expert_mm`` takes a key only on a programmed stack, in the
order wg, wu, wd.  The reference maps its token chunks with ``lax.map``,
whose body is traced once, so every chunk takes the same salts; the chunk
loop here restarts the salt for each chunk in the same way.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import kernels
from ..configs.base import ModelConfig
from ..distributed.sharding import NamedSharding, P, shard, unshard
from ..launch.mesh import mesh_axis_sizes, pmean, psum
from . import transformer as base
from .common import (Runtime, _encode_act, attention, attention_specs,
                     constrain_batch, cross_entropy_loss, ec_product,
                     embed_spec, layer_body, rmsnorm, rmsnorm_spec,
                     rope_tables, unembed_spec)
from .params import spec, stack_specs, torch_dtype, unstack

__all__ = ["init_specs", "loss", "forward", "prefill", "decode_step",
           "init_caches", "layer_specs", "layer_apply", "moe_specs",
           "moe_apply", "expert_mm", "expert_mm_plain", "MOE_TOKEN_CHUNK"]


def moe_specs(cfg: ModelConfig) -> Dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": {"w": spec((d, e), ("embed", None), scale=0.02)},
        "wg": {"w": spec((e, d, f), ("expert", "embed", "mlp"))},
        "wu": {"w": spec((e, d, f), ("expert", "embed", "mlp"))},
        "wd": {"w": spec((e, f, d), ("expert", "mlp", "embed"))},
    }


def layer_specs(cfg: ModelConfig) -> Dict:
    return {
        "ln_attn": rmsnorm_spec(cfg.d_model),
        "attn": attention_specs(cfg),
        "ln_mlp": rmsnorm_spec(cfg.d_model),
        "moe": moe_specs(cfg),
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


# --------------------------------------------------------------------------- #
# Dispatch / combine
# --------------------------------------------------------------------------- #

def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(cfg.experts_per_token * n_tokens
                  * cfg.expert_capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def expert_mm(pd: Dict, x: torch.Tensor,
              rt: Optional[Runtime]) -> torch.Tensor:
    """x (E, C, D) @ w (E, D, F) -> (E, C, F).  On a programmed stack
    (``w_tilde`` / ``dw`` present) the two-tier EC product, with expert e's
    C slots at columns ``e * C`` of the ``(D, E * C)`` panels:

        tier-1:  p = w_tilde[e]^T x_e^T + dw[e]^T x_tilde_e^T  (ec_group_rmatmul)
        tier-2:  y = p - lam (L^T L) p along F                (stencil_denoise)

    under one DAC draw over the whole buffer, through
    :class:`~.common.AnalogProduct` (its backward: one more
    ``stencil_denoise`` and batched matmuls).  Digital stacks take a plain
    batched product (the reference computes it outside any kernel)."""
    def product(w_tilde, dw, u, u_t, lam):
        return ec_product(u, u_t, w_tilde, dw, lam,
                          kernels.ec_group_rmatmul, kernels.stencil_denoise)
    return _expert_mm(pd, x, rt, product)


def expert_mm_plain(pd: Dict, x: torch.Tensor,
                    rt: Optional[Runtime]) -> torch.Tensor:
    """:func:`expert_mm` with the kernels' plain PyTorch versions on any
    device: the same DAC draw, layout and casts (the twin that the card's
    checks hold :func:`expert_mm` to)."""
    def product(w_tilde, dw, u, u_t, lam):
        return kernels.stencil_denoise_plain(
            kernels.ec_group_rmatmul_plain(w_tilde, dw, u, u_t), lam)
    return _expert_mm(pd, x, rt, product)


def _expert_mm(pd: Dict, x: torch.Tensor, rt: Optional[Runtime],
               product) -> torch.Tensor:
    w = pd["w"]
    if rt is None or rt.rram is None or not rt.rram.enabled \
            or "w_tilde" not in pd:
        return torch.bmm(x, w.to(x.dtype))
    cfg = rt.rram
    cd = x.dtype
    xt = _encode_act(x, rt.next_key(), cfg, rt.draw) \
        if cfg.encode_inputs else x
    if not cfg.ec:
        return torch.bmm(xt, pd["w_tilde"].to(cd))
    e, c, d = x.shape
    f32 = torch.float32
    u = x.to(f32).permute(2, 0, 1).reshape(d, e * c).contiguous()
    u_t = xt.to(f32).permute(2, 0, 1).reshape(d, e * c).contiguous()
    out = product(pd["w_tilde"].to(f32), pd["dw"].to(f32), u, u_t,
                  cfg.lam)                                  # (F, E * C)
    return out.reshape(-1, e, c).permute(1, 2, 0).to(cd)


MOE_TOKEN_CHUNK = 8192


def _moe_ffn_local(p: Dict, x2: torch.Tensor, cfg: ModelConfig,
                   rt: Optional[Runtime]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2 (N, D) -> (out (N, D), aux).  A token stream longer than
    ``MOE_TOKEN_CHUNK`` (and a multiple of it) runs chunk by chunk, so the
    dispatch buffers stay bounded; every chunk takes the same DAC salts."""
    n, _ = x2.shape
    ch = MOE_TOKEN_CHUNK
    if n > ch and n % ch == 0:
        first = rt._salt if rt is not None else 0
        outs, auxs = [], []
        for xc in x2.split(ch):
            if rt is not None:
                rt._salt = first
            out, aux = _moe_ffn_chunk(p, xc, cfg, rt)
            outs.append(out)
            auxs.append(aux)
        return torch.cat(outs), torch.stack(auxs).mean()
    return _moe_ffn_chunk(p, x2, cfg, rt)


def _moe_ffn_chunk(p: Dict, x2: torch.Tensor, cfg: ModelConfig,
                   rt: Optional[Runtime]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    n, d = x2.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = _capacity(n, cfg)
    dev = x2.device
    f32 = torch.float32

    gates = torch.softmax((x2 @ p["router"]["w"].to(x2.dtype)).to(f32),
                          dim=-1)
    topv, topi = torch.topk(gates, k, dim=-1)                # (N, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    ef = topi.reshape(-1)                                    # (N * k,)
    order = torch.argsort(ef, stable=True)
    es = ef[order]
    counts = torch.bincount(ef, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(es.shape[0], device=dev) - starts[es]
    keep = pos < cap
    slot = torch.where(keep, es * cap + pos, e * cap)

    xs = x2[order // k]
    buf = torch.zeros((e * cap + 1, d), dtype=x2.dtype, device=dev)
    buf[slot] = torch.where(keep[:, None], xs, 0)   # dropped: the spare row
    xin = buf[:-1].reshape(e, cap, d)

    h = F.silu(expert_mm(p["wg"], xin, rt)) * expert_mm(p["wu"], xin, rt)
    yout = expert_mm(p["wd"], h, rt)                         # (E, C, D)

    ys = yout.reshape(e * cap, d)
    got = torch.where(keep[:, None], ys[torch.clamp(slot, max=e * cap - 1)],
                      0)
    inv = torch.argsort(order, stable=True)
    out_assign = got[inv].reshape(n, k, d)
    out = (out_assign * topv[..., None].to(x2.dtype)).sum(dim=1)

    # Switch-style load-balance aux: E * sum_e f_e * P_e.
    f_e = counts.to(f32) / (n * k)
    p_e = gates.mean(dim=0)
    aux = e * (f_e * p_e).sum()
    return out, aux


def moe_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig,
              rt: Optional[Runtime]) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, D) -> (out, aux): the local path, or with ``rt.mesh`` set
    the reference's ``shard_map`` tensor-parallel path, rank by rank:
    :func:`_moe_tp`."""
    b, t, d = x.shape
    if rt is None or rt.mesh is None:
        out, aux = _moe_ffn_local(p, x.reshape(b * t, d), cfg, rt)
        return out.reshape(b, t, d), aux
    return _moe_tp(p, x, cfg, rt)


def _moe_tp(p: Dict, x: torch.Tensor, cfg: ModelConfig,
            rt: Runtime) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-parallel MoE on ``rt.mesh``: the batch split over
    ``rt.batch_axes`` (whole on every rank when they do not divide it), the
    router whole, and every leaf of the expert stacks (``w``, ``w_tilde``,
    ``dw``) split on d_ff over ``rt.model_axis``: ``wg`` / ``wu`` on their
    last dim, ``wd`` on its rows.  Each rank runs :func:`_moe_ffn_local` on
    views of its blocks (no copy), with its own capacity (that of its
    tokens) and the DAC salts of the reference's one trace of the body
    (reset before each rank); the partial down-projections are summed over
    the model axis (``mesh.psum``), aux averaged over it and then over each
    batch axis that splits the batch (``mesh.pmean``).  The tier-2 stencil
    of an analog stack runs along each rank's d_ff block."""
    b, t, d = x.shape
    mesh, mp = rt.mesh, rt.model_axis
    sizes = mesh_axis_sizes(mesh)
    dsz = 1
    for ax in rt.batch_axes:
        dsz *= sizes.get(ax, 1)
    # Batch must divide the data axes to shard it; a small batch (a B = 1
    # decode) runs whole on every data rank instead.
    batch_spec = rt.batch_axes if b % dsz == 0 else None
    x_sh = NamedSharding(mesh, P(batch_spec, None, None))
    xs = shard(x, x_sh)

    def split(tree, spec):
        return {k: shard(v, NamedSharding(mesh, spec))
                for k, v in tree.items()}

    stacks = {"wg": split(p["wg"], P(None, None, mp)),
              "wu": split(p["wu"], P(None, None, mp)),
              "wd": split(p["wd"], P(None, mp, None))}
    first = rt._salt
    outs, auxs = [], []
    for r in range(mesh.size):
        rt._salt = first          # shard_map traces the body once
        pl = {"router": p["router"],
              **{name: {k: v[r] for k, v in leaves.items()}
                 for name, leaves in stacks.items()}}
        bl, tl, _ = xs[r].shape
        out_l, aux_l = _moe_ffn_local(pl, xs[r].reshape(bl * tl, d), cfg, rt)
        outs.append(out_l.reshape(bl, tl, d))
        auxs.append(aux_l)
    outs = psum(mesh, outs, mp)
    auxs = pmean(mesh, auxs, mp)
    if batch_spec is not None:
        for ax in rt.batch_axes:
            auxs = pmean(mesh, auxs, ax)
    return unshard(outs, x_sh), auxs[0]


# --------------------------------------------------------------------------- #
# Model interface
# --------------------------------------------------------------------------- #

init_caches = base.init_caches


def layer_apply(lp: Dict, x: torch.Tensor, cfg: ModelConfig,
                rt: Optional[Runtime], positions, cache: Optional[Dict],
                rope_tabs=None):
    x = constrain_batch(x, rt)
    a, cache = attention(lp["attn"], rmsnorm(lp["ln_attn"], x, cfg.norm_eps),
                         cfg, rt, positions=positions, cache=cache,
                         rope_tabs=rope_tabs)
    x = x + a
    m, aux = moe_apply(lp["moe"], rmsnorm(lp["ln_mlp"], x, cfg.norm_eps),
                       cfg, rt)
    return x + m, cache, aux


def forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
            rt: Optional[Runtime], positions=None,
            caches: Optional[Dict] = None):
    """tokens (B, T) -> (hidden (B, T, D), caches, the layers' aux sum).
    Every layer takes the body's salts, as in :mod:`.transformer`."""
    cd = torch_dtype(cfg.compute_dtype)
    x = constrain_batch(params["embed"][tokens.long()].to(cd), rt)
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)[None, :]
    tabs = rope_tables(positions, cfg.rope_theta, cfg.d_head) \
        if cfg.rope_theta else None
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    first = rt._salt if rt is not None else 0
    for l, lp in enumerate(unstack(params["layers"])):
        cache = None if caches is None else \
            {"k": caches["k"][l], "v": caches["v"][l],
             "len": caches["len"][l]}
        x, cache, aux = layer_body(rt, first, layer_apply, lp, x, cfg, rt,
                                   positions, cache, tabs)
        aux_sum = aux_sum + aux
        if caches is not None:
            caches["len"][l] = cache["len"]
    return rmsnorm(params["ln_f"], x, cfg.norm_eps), caches, aux_sum


def loss(params: Dict, batch: Dict, cfg: ModelConfig, rt: Optional[Runtime],
         aux_weight: float = 0.01) -> torch.Tensor:
    hidden, _, aux = forward(params, batch["tokens"], cfg, rt)
    logits = base.logits_fn(params, hidden, cfg, rt)
    return cross_entropy_loss(logits, batch["labels"]) \
        + aux_weight * aux / max(cfg.n_layers, 1)


def prefill(params: Dict, batch: Dict, cfg: ModelConfig,
            rt: Optional[Runtime], max_len: int):
    tokens = batch["tokens"]
    caches = init_caches(tokens.shape[0], max_len, cfg, tokens.device)
    hidden, caches, _ = forward(params, tokens, cfg, rt, caches=caches)
    return base.logits_fn(params, hidden[:, -1:], cfg, rt), caches


def decode_step(params: Dict, tokens: torch.Tensor, caches: Dict,
                cfg: ModelConfig, rt: Optional[Runtime]):
    cur = int(caches["len"][0])
    positions = torch.full(tokens.shape, cur, dtype=torch.int32,
                           device=tokens.device)
    hidden, caches, _ = forward(params, tokens, cfg, rt, positions=positions,
                                caches=caches)
    return base.logits_fn(params, hidden, cfg, rt), caches
