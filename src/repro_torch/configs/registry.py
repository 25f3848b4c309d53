"""--arch registry of the port: id -> ArchConfig + family module.

A copy of :mod:`repro.configs.registry`'s tables, without its abstract
input specs (those serve the reference's dry run and come with the training
half of the port).  ``model_module`` maps a family to the port's module
and, like the reference's dict lookup, raises ``KeyError`` for a family
without one (``meliso``, or an unknown name).
"""
from __future__ import annotations

import importlib

from .base import ArchConfig, ModelConfig

__all__ = ["ARCHS", "get_arch", "model_module"]

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

