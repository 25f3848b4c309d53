"""Shared model components of the port (of :mod:`repro.models.common`):
linear ops (digital + RRAM analog backend), norms, RoPE, GQA attention
(qk-norm / sliding-window / cross-attn / KV cache), MLPs, embeddings and the
cross-entropy loss, and the layer loops' rematerialisation
(:func:`layer_body`).

All linear kernels are 2-D ``(d_in, d_out)`` and named ``"w"``: the contract
that lets :func:`repro_torch.models.rram.program_rram` put any layer on the
analog backend without model-specific code.  On a layer so programmed,
:func:`dense` runs the two-tier error-corrected product through the
hand-written kernels: the tier-1 product is ``kernels.ec_rmatmul`` (the
``(d_in, d_out)`` image read backwards, so no weight is transposed) and the
tier-2 step ``kernels.stencil_denoise``; on CPU tensors both run their plain
versions.  The product is an autograd function whose backward is the
reference's VJP (another ``stencil_denoise``, then plain matmuls), so a
loss through an analog layer has the same gradient on every device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import kernels
from ..configs.base import ModelConfig, RRAMBackendConfig
from ..core.devices import effective_sigma_py, get_device
from ..core.prng import fold_in, generator
from .params import ParamSpec, spec

__all__ = [
    "Runtime", "constrain_batch", "AnalogProduct", "ec_product", "dense",
    "dense_plain", "dense_spec", "layer_body", "rmsnorm",
    "rmsnorm_spec", "layernorm", "layernorm_spec", "rope", "rope_tables",
    "attention_specs", "attention", "init_kv_cache", "mlp_specs", "mlp",
    "embed_spec", "unembed_spec", "cross_entropy_loss",
    "sinusoidal_positions",
]

NEG_INF = -1e30


# --------------------------------------------------------------------------- #
# Runtime context (threads the RRAM backend + keys through apply functions)
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class Runtime:
    """Per-call context.  ``_salt`` counts the analog dense calls: each
    takes the key ``fold_in(key, salt)`` (``key`` 0 when unset).  ``draw``,
    when set, replaces the DAC noise draw: ``draw(key, shape)`` returns the
    standard normals for the call keyed ``key`` (tests inject the
    reference's draws through it).  ``mesh`` (a
    :class:`~repro_torch.launch.mesh.Mesh`), when set, runs the MoE layers
    tensor-parallel over ``model_axis`` with the batch over
    ``batch_axes``."""

    rram: Optional[RRAMBackendConfig] = None
    key: Optional[int] = None
    mesh: Any = None                    # for the MoE's tensor-parallel path
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    flash_threshold: int = 512 * 512    # t*s above which attention chunks
    q_chunk: int = 1024
    kv_chunk: int = 1024
    causal_skip: bool = False           # skip of masked KV chunks
    remat: str = "none"                 # none | block | full
    attn_in_dtype: str = "native"       # "native" | "f32": K/V cast first
    draw: Optional[Callable[[int, Tuple[int, ...]], torch.Tensor]] = None
    _salt: int = 0

    def next_key(self) -> int:
        self._salt += 1
        return fold_in(self.key if self.key is not None else 0, self._salt)


def constrain_batch(x: torch.Tensor, rt: Optional[Runtime]) -> torch.Tensor:
    """``x`` as it is.  The reference pins activations to batch-over-data
    sharding here (when the data axes divide the batch), a layout hint to
    GSPMD that changes no value; every rank of the port's mesh shares one
    device, so there is no layout to pin.  The layers call it at the
    reference's sites, where a layout across cards (ROADMAP A16) would
    go."""
    return x


def layer_body(rt: Optional[Runtime], salt: Optional[int], fn: Callable,
               *args):
    """``fn(*args)``: one pass of a layer loop's body (the reference's scan
    body, or a function it checkpoints), its dense calls starting from salt
    ``salt`` (from where the salt stands when None).  Under ``rt.remat``
    "block" or "full", with gradients on, the body runs through
    ``torch.utils.checkpoint``, the reference's ``jax.checkpoint``: its
    activations are recomputed in the backward pass.  The salt is reset
    inside the checkpointed body, so a recompute draws the forward's DAC
    noise, and put back after it, so the salt after the loop is what it is
    without remat."""
    if rt is None:
        return fn(*args)
    start = rt._salt if salt is None else salt
    if rt.remat not in ("block", "full") or not torch.is_grad_enabled():
        rt._salt = start
        return fn(*args)
    passes = []

    def body(*a):
        resume = rt._salt
        rt._salt = start
        recompute = bool(passes)
        passes.append(None)
        try:
            return fn(*a)
        finally:
            if recompute:       # may stop early, once it has what it needs
                rt._salt = resume

    # The body draws only from keyed generators: no RNG state to replay.
    return checkpoint(body, *args, use_reentrant=False,
                      preserve_rng_state=False)


@functools.lru_cache(maxsize=None)
def _dac_sigma(device: str, k_iters: int) -> float:
    """The DAC noise's sigma_eff, rounded to float32 as the reference's."""
    return float(np.float32(effective_sigma_py(get_device(device), k_iters)))


def _encode_act(x: torch.Tensor, key: int, cfg: RRAMBackendConfig,
                draw=None) -> torch.Tensor:
    """DAC-side encoding noise on activations (x -> x_tilde)."""
    sigma = _dac_sigma(cfg.device, cfg.k_iters)
    if draw is not None:
        eta = draw(key, tuple(x.shape)).to(device=x.device, dtype=x.dtype)
    else:
        eta = torch.randn(x.shape, generator=generator(key, x.device),
                          device=x.device, dtype=x.dtype)
    return x * (1.0 + sigma * eta)


def dense_spec(d_in: int, d_out: int, axes=("embed", "mlp"),
               scale=None) -> Dict:
    return {"w": spec((d_in, d_out), axes, scale=scale)}


class AnalogProduct(torch.autograd.Function):
    """The two-tier EC product ``S (w_tilde^T u + dw^T u_t)`` of a
    programmed kernel, ``S = I - lam L^T L`` along the output axis, on the
    ``(d_in, cols)`` panels ``u`` / ``u_t`` (the input and its DAC-encoded
    copy) of a ``(d_in, d_out)`` image or a ``(g, d_in, d_out)`` stack of
    them (member ``e`` owning its share of the columns).  The forward is
    the given tier-1 and tier-2 calls (the kernels on CUDA tensors); the
    backward is the reference's VJP: ``S`` is symmetric, so ``G' = S G``
    is one more ``stencil_denoise`` launch, and then ``du = w_tilde G'``,
    ``du_t = dw G'``, ``d w_tilde = u G'^T``, ``d dw = u_t G'^T`` as plain
    matmuls (the reference computes them outside any kernel).

    ``apply(u, u_t, w_tilde, dw, lam, tier1, stencil_denoise)``."""

    @staticmethod
    def forward(ctx, u, u_t, w_tilde, dw, lam, tier1, stencil_denoise):
        ctx.save_for_backward(u, u_t, w_tilde, dw)
        ctx.lam, ctx.stencil_denoise = lam, stencil_denoise
        return stencil_denoise(tier1(w_tilde, dw, u, u_t), lam)

    @staticmethod
    def backward(ctx, g):
        u, u_t, w_tilde, dw = ctx.saved_tensors
        gp = ctx.stencil_denoise(g.contiguous(), ctx.lam)
        need = ctx.needs_input_grad
        if w_tilde.ndim == 2:
            du = w_tilde @ gp if need[0] else None
            du_t = dw @ gp if need[1] else None
            dwt = u @ gp.T if need[2] else None
            ddw = u_t @ gp.T if need[3] else None
            return du, du_t, dwt, ddw, None, None, None
        # A stack: member e's columns are its share of the panels.
        n = w_tilde.shape[0]

        def members(a):                        # (r, n * c) -> (n, r, c)
            return a.reshape(a.shape[0], n, -1).transpose(0, 1)

        def panel(a):                          # (n, r, c) -> (r, n * c)
            return a.transpose(0, 1).reshape(a.shape[1], -1)

        gm = members(gp)
        du = panel(w_tilde @ gm) if need[0] else None
        du_t = panel(dw @ gm) if need[1] else None
        dwt = members(u) @ gm.transpose(1, 2) if need[2] else None
        ddw = members(u_t) @ gm.transpose(1, 2) if need[3] else None
        return du, du_t, dwt, ddw, None, None, None


def dense(p: Dict, x: torch.Tensor, rt: Optional[Runtime] = None
          ) -> torch.Tensor:
    """y = x @ w.  If the layer has been programmed onto the RRAM backend
    (``w_tilde`` / ``dw`` present), runs the two-tier error-corrected
    analog path on the ``(rows, d_in)`` flattening of ``x``:

        tier-1:  p = w_tilde^T x^T + dw^T x_tilde^T   (ec_rmatmul)
        tier-2:  y = p - lam (L^T L) p along d_out    (stencil_denoise)

    with ``p`` the (d_out, rows) panel: one ``ec_rmatmul`` launch per 8
    rows and one ``stencil_denoise`` launch on CUDA tensors, through
    :class:`AnalogProduct` (its backward: one more ``stencil_denoise``).
    Like the reference, always the Neumann stencil: ``denoise_method`` and
    ``ec_mode`` are not read.  A ``dw`` kept in bfloat16 is upcast for
    each call."""
    return _dense(p, x, rt, _kernel_product)


def dense_plain(p: Dict, x: torch.Tensor, rt: Optional[Runtime] = None
                ) -> torch.Tensor:
    """:func:`dense` with the kernels' plain PyTorch versions on any
    device, differentiated by plain autograd: the same DAC draw (from
    ``rt``'s next key), layout and casts.  The twin that the card's checks
    hold :func:`dense` to, forward and backward."""
    return _dense(p, x, rt, _plain_product)


def ec_product(u, u_t, w_tilde, dw, lam, tier1, stencil_denoise):
    """``stencil_denoise(tier1(w_tilde, dw, u, u_t), lam)``, through
    :class:`AnalogProduct` only where autograd records a gradient: a
    serving pass pays no autograd node a dense."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (u, u_t, w_tilde, dw)):
        return AnalogProduct.apply(u, u_t, w_tilde, dw, lam, tier1,
                                   stencil_denoise)
    return stencil_denoise(tier1(w_tilde, dw, u, u_t), lam)


def _kernel_product(w_tilde, dw, u, u_t, lam):
    # The wrappers are looked up at each call (tests count through them).
    return ec_product(u, u_t, w_tilde, dw, lam, kernels.ec_rmatmul,
                      kernels.stencil_denoise)


def _plain_product(w_tilde, dw, u, u_t, lam):
    return kernels.stencil_denoise_plain(
        kernels.ec_rmatmul_plain(w_tilde, dw, u, u_t), lam)


def _dense(p: Dict, x: torch.Tensor, rt: Optional[Runtime],
           product) -> torch.Tensor:
    w = p["w"]
    if rt is None or rt.rram is None or not rt.rram.enabled \
            or "w_tilde" not in p:
        return x @ w
    cfg = rt.rram
    cd = x.dtype
    xt = _encode_act(x, rt.next_key(), cfg, rt.draw) \
        if cfg.encode_inputs else x
    if not cfg.ec:
        return xt @ p["w_tilde"].to(cd)
    lead, d_in = x.shape[:-1], x.shape[-1]
    f32 = torch.float32
    u = x.reshape(-1, d_in).to(f32).T.contiguous()
    u_t = xt.reshape(-1, d_in).to(f32).T.contiguous()
    out = product(p["w_tilde"].to(f32), p["dw"].to(f32), u, u_t, cfg.lam)
    return out.T.reshape(*lead, out.shape[0]).to(cd)


# --------------------------------------------------------------------------- #
# Norms, RoPE, positions
# --------------------------------------------------------------------------- #

def rmsnorm_spec(d: int) -> Dict:
    return {"scale": spec((d,), ("embed",), init="ones")}


def rmsnorm(p: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * p["scale"].to(torch.float32)).to(x.dtype)


def layernorm_spec(d: int) -> Dict:
    return {"scale": spec((d,), ("embed",), init="ones"),
            "bias": spec((d,), ("embed",), init="zeros")}


def layernorm(p: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return out.to(x.dtype)


def rope_tables(positions: torch.Tensor, theta: float, dh: int):
    """Full-width (Dh) cos / signed-sin tables (the reference's form), to
    build once per forward pass and hand to every layer's :func:`rope`."""
    half = dh // 2
    idx = torch.arange(dh, dtype=torch.int32, device=positions.device)
    expo = (idx % half).to(torch.float32) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), expo)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., T, Dh)
    sign = torch.where(idx < half, -1.0, 1.0).to(torch.float32)
    return torch.cos(ang)[..., None, :], (sign * torch.sin(ang))[..., None, :]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         tables=None) -> torch.Tensor:
    """x: (..., T, H, Dh); positions: (..., T) integers.  Rotate-half form
    on full-width arrays, as the reference spells it.  Its autograd,
    ``g cos2 + rot(g sin2)``, is the reference's custom VJP ``g cos2 +
    rot(g) (-sin2)`` bit for bit: the signed sine table is odd under the
    half swap.  ``tables``, when given, are :func:`rope_tables` of these
    positions."""
    cos2, sin2 = tables if tables is not None else \
        rope_tables(positions, theta, x.shape[-1])
    half = x.shape[-1] // 2
    rot = torch.cat([x[..., half:], x[..., :half]], dim=-1)
    return (x * cos2 + rot * sin2).to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10_000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------- #
# Attention (GQA, qk-norm, sliding window, self/cross, KV cache)
# --------------------------------------------------------------------------- #

def attention_specs(cfg: ModelConfig, cross: bool = False) -> Dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s: Dict[str, Any] = {
        "wq": dense_spec(d, h * dh, axes=("embed", "heads")),
        "wk": dense_spec(d, kv * dh, axes=("embed", "kv_heads")),
        "wv": dense_spec(d, kv * dh, axes=("embed", "kv_heads")),
        "wo": dense_spec(h * dh, d, axes=("heads", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = {"scale": spec((dh,), (None,), init="ones")}
        s["k_norm"] = {"scale": spec((dh,), (None,), init="ones")}
    if cross:
        s["gate"] = spec((), (), init="zeros")    # llama-vision tanh gate
    return s


def init_kv_cache(batch: int, max_len: int, cfg: ModelConfig, dtype,
                  device) -> Dict:
    """One layer's cache: ``k`` / ``v`` (batch, max_len, kv, dh) on
    ``device`` and ``len``, an int32 scalar kept on the host (the eager
    decode loop reads it every step)."""
    kv, dh = cfg.n_kv_heads, cfg.d_head
    return {
        "k": torch.zeros((batch, max_len, kv, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, kv, dh), dtype=dtype, device=device),
        "len": torch.zeros((), dtype=torch.int32),
    }


def _write_slot(dst: torch.Tensor, src: torch.Tensor, start: int) -> None:
    """``dst[:, start:start + t] = src``, the start clamped so the slice
    fits (``lax.dynamic_update_slice``'s rule)."""
    t = src.shape[1]
    start = max(0, min(start, dst.shape[1] - t))
    dst[:, start:start + t] = src.to(dst.dtype)


def attention(
    p: Dict,
    x: torch.Tensor,                       # (B, T, D)
    cfg: ModelConfig,
    rt: Optional[Runtime] = None,
    *,
    positions: Optional[torch.Tensor] = None,
    kv_x: Optional[torch.Tensor] = None,   # cross-attention source (B, S, D)
    cache: Optional[Dict] = None,          # decode KV cache
    causal: bool = True,
    rope_tabs=None,                        # rope_tables(positions, ...)
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (out, updated cache).  Handles training (full sequence),
    prefill (full sequence + cache fill), decode (T == 1 + cache append)
    and cross-attention.  The cache's ``k`` / ``v`` tensors are written in
    place; the returned dict holds them and the new ``len``."""
    b, t, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    cd = x.dtype
    dev = x.device

    q = dense(p["wq"], x, rt).reshape(b, t, h, dh)
    src = kv_x if kv_x is not None else x
    k = dense(p["wk"], src, rt).reshape(b, src.shape[1], kv, dh)
    v = dense(p["wv"], src, rt).reshape(b, src.shape[1], kv, dh)

    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)

    if positions is None:
        positions = torch.arange(t, dtype=torch.int32, device=dev)[None, :]
    if kv_x is None and cfg.rope_theta:
        if rope_tabs is None:
            rope_tabs = rope_tables(positions, cfg.rope_theta, dh)
        q = rope(q, positions, cfg.rope_theta, rope_tabs)
        k = rope(k, positions, cfg.rope_theta, rope_tabs)

    q_pos = positions                                        # (B, T)
    if cache is not None and kv_x is None:
        start = int(cache["len"])
        w_cache = cache["k"].shape[1]
        circular = (cfg.swa_window is not None and w_cache <= cfg.swa_window)
        new_len = torch.tensor(start + t, dtype=torch.int32)
        if circular and t >= w_cache:
            # Sliding-window prefill into a circular cache: keep the last
            # W tokens; token j lives at slot j % W (roll aligns them).
            shift = (t - w_cache) % w_cache
            cache["k"].copy_(torch.roll(k[:, -w_cache:], shift, dims=1))
            cache["v"].copy_(torch.roll(v[:, -w_cache:], shift, dims=1))
            cache = {"k": cache["k"], "v": cache["v"], "len": new_len}
            # In-pass attention uses the full-sequence k/v (window-masked).
            kv_pos = q_pos
            kv_valid = torch.ones(k.shape[:2], dtype=torch.bool, device=dev)
        elif circular:
            # Decode (t small): write at slot len % W.
            _write_slot(cache["k"], k, start % w_cache)
            _write_slot(cache["v"], v, start % w_cache)
            cache = {"k": cache["k"], "v": cache["v"], "len": new_len}
            k, v = cache["k"], cache["v"]
            # Slot s holds the latest token position == s (mod W), < len.
            s_idx = torch.arange(w_cache, dtype=torch.int32, device=dev)
            tok_pos = (start + t) - 1 - (((start + t) - 1 - s_idx) % w_cache)
            kv_pos = tok_pos[None, :]
            kv_valid = (tok_pos >= 0)[None, :]
        else:
            # Append current k/v at cache["len"].
            _write_slot(cache["k"], k, start)
            _write_slot(cache["v"], v, start)
            cache = {"k": cache["k"], "v": cache["v"], "len": new_len}
            k, v = cache["k"], cache["v"]
            kv_pos = torch.arange(k.shape[1], dtype=torch.int32,
                                  device=dev)[None, :]
            kv_valid = kv_pos < start + t
    else:
        kv_pos = (torch.arange(k.shape[1], dtype=torch.int32,
                               device=dev)[None, :]
                  if kv_x is not None else q_pos)
        kv_valid = None        # fully valid; flash skips masks if non-causal

    # Grouped-query attention: (B, T, KV, G, Dh) vs (B, S, KV, Dh).
    g = h // kv
    qg = q.reshape(b, t, kv, g, dh)
    s_len = k.shape[1]
    is_causal = causal and kv_x is None
    if q_pos.ndim == 1:
        q_pos = q_pos[None, :]
    if kv_pos.ndim == 1:
        kv_pos = kv_pos[None, :]
    q_pos = q_pos.expand(b, t)
    kv_pos = kv_pos.expand(b, s_len)
    if kv_valid is not None:
        kv_valid = kv_valid.expand(b, s_len)

    threshold = rt.flash_threshold if rt is not None else 512 * 512
    if t > 1 and t * s_len > threshold:
        from .flash import flash_attention
        out = flash_attention(
            qg, k, v, q_pos, kv_pos, kv_valid,
            causal=is_causal, window=cfg.swa_window,
            q_chunk=rt.q_chunk if rt else 1024,
            kv_chunk=rt.kv_chunk if rt else 1024,
            causal_skip=rt.causal_skip if rt else False)
    else:
        f32 = torch.float32
        cast = rt is not None and rt.attn_in_dtype == "f32"
        # Operands in their storage dtype (or fp32 with "f32"), products
        # summed in fp32: the reference's preferred_element_type.
        qin = (qg.to(f32) if cast else qg) * torch.tensor(
            dh ** -0.5, dtype=f32 if cast else qg.dtype)
        kin = k.to(f32) if cast else k
        logits = torch.einsum("btkgd,bskd->bkgts", qin.to(f32), kin.to(f32))
        mask = (kv_valid[:, None, None, None, :] if kv_valid is not None
                else torch.ones((b, 1, 1, 1, s_len), dtype=torch.bool,
                                device=dev))
        if is_causal:
            qp = q_pos[:, None, None, :, None]
            kp = kv_pos[:, None, None, None, :]
            mask = mask & (qp >= kp)
            if cfg.swa_window:
                mask = mask & ((qp - kp) < cfg.swa_window)
        logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        vin = v.to(f32) if cast else v
        out = torch.einsum("bkgts,bskd->btkgd",
                           probs.to(vin.dtype).to(f32), vin.to(f32)).to(cd)
    out = out.reshape(b, t, h * dh)
    out = dense(p["wo"], out, rt)
    if "gate" in p:                                          # gated cross-attn
        out = torch.tanh(p["gate"].to(torch.float32)).to(cd) * out
    return out, cache


# --------------------------------------------------------------------------- #
# MLPs
# --------------------------------------------------------------------------- #

def mlp_specs(cfg: ModelConfig) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "silu_gated":
        return {
            "wg": dense_spec(d, f, axes=("embed", "mlp")),
            "wu": dense_spec(d, f, axes=("embed", "mlp")),
            "wd": dense_spec(f, d, axes=("mlp", "embed")),
        }
    return {
        "wu": dense_spec(d, f, axes=("embed", "mlp")),
        "wd": dense_spec(f, d, axes=("mlp", "embed")),
    }


def mlp(p: Dict, x: torch.Tensor, cfg: ModelConfig,
        rt: Optional[Runtime] = None) -> torch.Tensor:
    # The dense calls run in the reference's order (wg, wu, wd): each takes
    # the next DAC key.
    if cfg.act == "silu_gated":
        gate = F.silu(dense(p["wg"], x, rt))
        return dense(p["wd"], gate * dense(p["wu"], x, rt), rt)
    u = dense(p["wu"], x, rt)
    if cfg.act == "sq_relu":
        u = torch.relu(u).square()
    else:
        u = F.gelu(u, approximate="tanh")       # jax.nn.gelu's default
    return dense(p["wd"], u, rt)


# --------------------------------------------------------------------------- #
# Embeddings + loss
# --------------------------------------------------------------------------- #

def embed_spec(vocab: int, d: int) -> ParamSpec:
    return spec((vocab, d), ("vocab", "embed"), init="embed", scale=0.02)


def unembed_spec(d: int, vocab: int) -> Dict:
    return dense_spec(d, vocab, axes=("embed", "vocab"))


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over positions with label >= 0 (negative labels are padding)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).long()[..., None])[..., 0]
    nll = logz - gold
    wmask = (labels >= 0).to(torch.float32)
    return (nll * wmask).sum() / torch.clamp(wmask.sum(), min=1.0)
