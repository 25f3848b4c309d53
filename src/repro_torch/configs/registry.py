"""--arch registry of the port: id -> ArchConfig + family module + input
specs (of :mod:`repro.configs.registry`).

``model_module`` maps a family to the port's module and, like the
reference's dict lookup, raises ``KeyError`` for a family without one
(``meliso``, or an unknown name).  ``input_specs(arch, shape,
reduced=False)`` builds the stand-ins of a step's arguments as
``device="meta"`` tensors -- shapes and dtypes with no allocation, the
port's ``ShapeDtypeStruct`` -- and the decode caches from each family's
``init_caches(..., device="meta")`` (a cache's ``len`` is a host tensor,
as the port keeps it).
"""
from __future__ import annotations

import importlib
from typing import Dict

import torch

from ..models.params import torch_dtype
from .base import SHAPES, ArchConfig, ModelConfig, ShapeConfig

__all__ = ["ARCHS", "get_arch", "model_module", "input_specs", "batch_specs",
           "decode_cache_specs", "decode_cache_len"]

_MODULES = {
    "rwkv6-1.6b": "rwkv6_1p6b",
    "zamba2-1.2b": "zamba2_1p2b",
    "whisper-tiny": "whisper_tiny",
    "yi-9b": "yi_9b",
    "qwen3-1.7b": "qwen3_1p7b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen3-8b": "qwen3_8b",
    "mixtral-8x7b": "mixtral_8x7b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "meliso-mvm": "meliso_mvm",
}

ARCHS = tuple(k for k in _MODULES if k != "meliso-mvm")

_FAMILY_MODULES = {
    "transformer": "repro_torch.models.transformer",
    "moe": "repro_torch.models.moe",
    "rwkv6": "repro_torch.models.rwkv6",
    "zamba2": "repro_torch.models.zamba2",
    "whisper": "repro_torch.models.whisper",
    "llama_vision": "repro_torch.models.llama_vision",
}


def get_arch(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.ARCH


def model_module(cfg: ModelConfig):
    return importlib.import_module(_FAMILY_MODULES[cfg.family])



def decode_cache_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """KV budget for decode shapes: SWA archs keep a rolling window."""
    if cfg.swa_window:
        return min(shape.seq_len, cfg.swa_window)
    return shape.seq_len


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(arch: ArchConfig, shape: ShapeConfig,
                reduced: bool = False) -> Dict[str, torch.Tensor]:
    """Train / prefill batch stand-ins for one step."""
    m = arch.reduced() if reduced else arch.model
    b, s = shape.global_batch, shape.seq_len
    cd = torch_dtype(m.compute_dtype)
    i32 = torch.int32
    specs: Dict[str, torch.Tensor] = {}
    if m.family == "whisper":
        specs["frames"] = _meta((b, s, m.d_model), cd)
        specs["tokens"] = _meta((b, s), i32)
    elif m.family == "llama_vision":
        specs["tokens"] = _meta((b, s), i32)
        specs["patches"] = _meta((b, m.n_patches, m.d_model), cd)
    else:
        specs["tokens"] = _meta((b, s), i32)
    if shape.kind == "train":
        specs["labels"] = _meta((b, s), i32)
    return specs


def decode_cache_specs(arch: ArchConfig, shape: ShapeConfig,
                       reduced: bool = False):
    """Abstract decode caches (filled KV / SSM state of length seq_len)."""
    m = arch.reduced() if reduced else arch.model
    mod = model_module(m)
    b = shape.global_batch
    max_len = decode_cache_len(m, shape)
    if m.family in ("transformer", "moe", "zamba2"):
        return mod.init_caches(b, max_len, m, "meta")
    if m.family == "rwkv6":
        return mod.init_caches(b, m, "meta")
    cd = torch_dtype(m.compute_dtype)
    if m.family == "whisper":
        return {"kv": mod.init_caches(b, max_len, m, "meta"),
                "enc": _meta((b, shape.seq_len, m.d_model), cd)}
    if m.family == "llama_vision":
        return {"kv": mod.init_caches(b, max_len, m, "meta"),
                "patches": _meta((b, m.n_patches, m.d_model), cd)}
    raise ValueError(m.family)


def input_specs(arch: ArchConfig, shape_name: str, reduced: bool = False):
    """Everything the (train|prefill|decode) step takes, as meta tensors."""
    shape = SHAPES[shape_name]
    if shape.kind in ("train", "prefill"):
        return {"batch": batch_specs(arch, shape, reduced)}
    # decode: one new token + filled caches
    return {"tokens": _meta((shape.global_batch, 1), torch.int32),
            "caches": decode_cache_specs(arch, shape, reduced)}
