"""Programming a model's linear layers onto the RRAM analog backend (port of
:mod:`repro.models.rram`).

``program_rram`` walks a parameter tree and programs every 2-D (or stacked
3-D) linear kernel named ``"w"`` once, through
:meth:`repro_torch.engine.AnalogEngine.encode_dense`; each gains two
siblings:

  * ``w_tilde``: the encoded (quantized + programming-noise) image, per
    (cell_rows x cell_cols) tile after ``k_iters`` write-verify passes;
  * ``dw = w - w_tilde``: the tier-1 correction operand, kept in
    ``dw_dtype`` (bfloat16 by default).

Kernel number ``c`` of the walk (dict insertion order, from 1) is keyed
``fold_in(key, c)``; a stacked ``(L, d_in, d_out)`` kernel keys layer ``l``
with ``split_key(fold_in(key, c), L)[l]``.  It also returns the aggregate
:class:`WriteStats` of programming the model, billed as the reference bills
it.  ``program_specs`` is the shape-level twin (no allocation).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..configs.base import RRAMBackendConfig
from ..core.crossbar import CrossbarConfig, input_write_cost, \
    matrix_write_cost
from ..core.devices import get_device
from ..core.prng import fold_in
from ..core.virtualization import MCAGeometry
from ..core.write_verify import WriteStats
from ..engine import AnalogEngine
from .params import is_spec, spec, split_key, torch_dtype

__all__ = ["program_rram", "program_specs", "programming_dispatch_plan",
           "programming_write_stats",
           "crossbar_cfg", "is_programmed", "strip_rram", "reprogram_rram",
           "analog_image_bytes", "programmed_kernel_shapes",
           "forward_input_stats"]


def crossbar_cfg(cfg: RRAMBackendConfig) -> CrossbarConfig:
    return CrossbarConfig(
        device=get_device(cfg.device),
        geom=MCAGeometry(tile_rows=1, tile_cols=1,
                         cell_rows=cfg.cell_rows, cell_cols=cfg.cell_cols),
        k_iters=cfg.k_iters, ec=cfg.ec, ec_mode=cfg.ec_mode,
        denoise_method=cfg.denoise_method, lam=cfg.lam,
        encode_inputs=cfg.encode_inputs,
    )


def _is_kernel(name: str, sub) -> bool:
    return name == "w" and isinstance(sub, torch.Tensor) \
        and sub.ndim in (2, 3)


def _scaled(per: WriteStats, count: int) -> WriteStats:
    """``count`` writes of one kernel's image: energy and latency add up,
    the verify iterations and the final delta are one write's."""
    return WriteStats(energy_j=per.energy_j * count,
                      latency_s=per.latency_s * count,
                      iterations=per.iterations, final_delta=per.final_delta)


def program_rram(
    params: Any,
    cfg: RRAMBackendConfig,
    key: int,
    *,
    engine: Optional[AnalogEngine] = None,
    group: bool = True,
    eta: Optional[Sequence] = None,
) -> Tuple[Any, WriteStats]:
    """Return (programmed params, total write stats).

    Each kernel is encoded once on ``engine`` (by default a ``reference``
    engine of :func:`crossbar_cfg` on the kernels' device); a stacked
    kernel is encoded layer by layer into one preallocated stack, so the
    peak is the model + its images + one layer's padded image.  ``eta``
    replaces the programming draws: one entry per kernel in walk order,
    ``(mb, nb, cap_m, cap_n)`` for a 2-D kernel and ``(L, mb, nb, cap_m,
    cap_n)`` for a stacked one.

    ``group`` selects how the write is billed, as in the reference:
    ``False`` bills kernel by kernel, ``True`` (the default) bills each
    bucket of same-shape kernels as one grouped write, whose verify
    ``iterations`` count once a bucket.  The images, energy, latency and
    final delta are the same either way.
    """
    counter = [0]
    jobs = []       # (slot dict, kernel, per-kernel key) in walk order

    def visit(tree):
        if not isinstance(tree, dict):
            return tree
        out = {}
        for name, sub in tree.items():
            if _is_kernel(name, sub):
                counter[0] += 1
                out[name] = sub
                out["w_tilde"] = None
                out["dw"] = None
                jobs.append((out, sub, fold_in(key, counter[0])))
            elif isinstance(sub, dict):
                out[name] = visit(sub)
            else:
                out[name] = sub
        return out

    tree = visit(params)
    if engine is None:
        engine = AnalogEngine(crossbar_cfg(cfg), device=(
            jobs[0][1].device if jobs else "cpu"))
    ccfg = engine.cfg
    etas = [None] * len(jobs) if eta is None else list(eta)
    if len(etas) != len(jobs):
        raise ValueError(f"{len(etas)} programming draws for {len(jobs)} "
                         f"kernels")
    dw_dtype = torch_dtype(cfg.dw_dtype)

    def as_eta(e, dev):
        return None if e is None else torch.as_tensor(
            np.asarray(e, np.float32), device=dev)

    for (slot, sub, k), e in zip(jobs, etas):
        e = as_eta(e, engine.device)
        if sub.ndim == 2:
            wt = engine.encode_dense(sub, k, eta=e)
            slot["w_tilde"] = wt.to(sub.dtype).contiguous()
            slot["dw"] = (sub.to(torch.float32) - wt).to(dw_dtype)
            continue
        layers = sub.shape[0]
        slot["w_tilde"] = torch.empty(sub.shape, dtype=sub.dtype,
                                      device=engine.device)
        slot["dw"] = torch.empty(sub.shape, dtype=dw_dtype,
                                 device=engine.device)
        for l, kl in enumerate(split_key(k, layers)):
            wt = engine.encode_dense(sub[l], kl,
                                     eta=None if e is None else e[l])
            slot["w_tilde"][l] = wt
            slot["dw"][l] = sub[l].to(device=wt.device,
                                      dtype=torch.float32) - wt
            del wt

    return tree, programming_write_stats(params, ccfg, group=group)


def _kernel_shapes(params: Any) -> list:
    """(ndim,) + shape of every kernel, in :func:`program_rram`'s walk
    order."""
    shapes = []

    def visit(tree):
        if isinstance(tree, dict):
            for name, sub in tree.items():
                if _is_kernel(name, sub):
                    shapes.append((sub.ndim,) + tuple(sub.shape))
                elif isinstance(sub, dict):
                    visit(sub)

    visit(params)
    return shapes


def programming_write_stats(params: Any, ccfg: CrossbarConfig, *,
                            group: bool = True) -> WriteStats:
    """The one-time write of every kernel, billed as :func:`program_rram`
    bills it.  Pure shape math -- works on programmed, digital or meta
    trees."""
    total = WriteStats.zero()
    shapes = _kernel_shapes(params)
    if not group:
        for bkey in shapes:
            layers = bkey[1] if bkey[0] == 3 else 1
            total = total + _scaled(matrix_write_cost(*bkey[-2:], ccfg),
                                    layers)
        return total
    buckets: Dict[Tuple, int] = {}
    for bkey in shapes:
        buckets[bkey] = buckets.get(bkey, 0) + 1
    for bkey, count in buckets.items():   # insertion order == walk order
        layers = bkey[1] if bkey[0] == 3 else 1
        total = total + _scaled(matrix_write_cost(*bkey[-2:], ccfg),
                                count * layers)
    return total


def programming_dispatch_plan(params: Any) -> Dict[str, int]:
    """Dispatch accounting of one :func:`program_rram` walk: ``kernels``
    programmed kernels, collapsing into ``groups`` distinct (ndim, shape)
    buckets.  Pure shape math -- works on programmed or digital trees."""
    shapes = _kernel_shapes(params)
    return {"kernels": len(shapes), "groups": len(set(shapes))}


def is_programmed(params: Any) -> bool:
    """True iff the tree already carries analog images (``w_tilde``)."""
    if not isinstance(params, dict):
        return False
    return "w_tilde" in params or any(is_programmed(sub)
                                      for sub in params.values())


def strip_rram(params: Any) -> Any:
    """Drop every ``w_tilde`` / ``dw`` sibling, returning digital params."""
    if not isinstance(params, dict):
        return params
    return {name: strip_rram(sub) for name, sub in params.items()
            if name not in ("w_tilde", "dw")}


def reprogram_rram(params: Any, cfg: RRAMBackendConfig, key: int, *,
                   engine: Optional[AnalogEngine] = None
                   ) -> Tuple[Any, WriteStats]:
    """Program a (possibly already programmed) tree under a fresh key: new
    device draws, and the full one-time write billed again."""
    return program_rram(strip_rram(params), cfg, key, engine=engine)


def analog_image_bytes(params: Any) -> int:
    """Resident bytes of the programmed analog operands (w_tilde + dw)."""
    if not isinstance(params, dict):
        return 0
    return sum(int(sub.nbytes) if name in ("w_tilde", "dw")
               and isinstance(sub, torch.Tensor) else analog_image_bytes(sub)
               for name, sub in params.items())


def programmed_kernel_shapes(params: Any) -> Tuple[Tuple[int, int, int], ...]:
    """(layers, d_in, d_out) of every programmed kernel (layers=1 if 2-D)."""
    out = []

    def visit(tree):
        if isinstance(tree, dict):
            for name, sub in tree.items():
                if name == "w_tilde" and isinstance(sub, torch.Tensor):
                    out.append((1,) + tuple(sub.shape) if sub.ndim == 2
                               else tuple(int(d) for d in sub.shape))
                else:
                    visit(sub)

    visit(params)
    return tuple(out)


def forward_input_stats(params: Any, cfg: RRAMBackendConfig,
                        batch: int = 1) -> WriteStats:
    """Per-forward-pass input-DAC cost through every programmed kernel:
    ``input_write_cost(d_out, d_in, batch=batch)`` a layer (one token
    position through ``dense`` is one corrected MVM against w^T)."""
    ccfg = crossbar_cfg(cfg)
    total = WriteStats.zero()
    for layers, d_in, d_out in programmed_kernel_shapes(params):
        total = total + _scaled(input_write_cost(d_out, d_in, ccfg,
                                                 batch=batch), layers)
    return total


def program_specs(specs: Any, cfg: RRAMBackendConfig) -> Any:
    """Spec-tree twin of :func:`program_rram`: adds w_tilde / dw ParamSpecs
    with the same shapes and logical axes as each kernel."""
    if not isinstance(specs, dict):
        return specs
    out = {}
    for name, sub in specs.items():
        if name == "w" and is_spec(sub) and len(sub.shape) in (2, 3):
            out[name] = sub
            out["w_tilde"] = spec(sub.shape, sub.axes, init="zeros",
                                  dtype=sub.dtype)
            out["dw"] = spec(sub.shape, sub.axes, init="zeros",
                             dtype=cfg.dw_dtype)
        else:
            out[name] = program_specs(sub, cfg)
    return out
