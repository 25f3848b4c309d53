"""Configurations of the port: copies of :mod:`repro.configs`' dataclasses
and arch data files (that package imports ``jax``, so the port keeps its
own)."""
from .base import (SHAPES, ArchConfig, MeshConfig, ModelConfig,
                   RRAMBackendConfig, ShapeConfig, TrainConfig)
from .registry import ARCHS, get_arch, model_module

__all__ = ["SHAPES", "ArchConfig", "MeshConfig", "ModelConfig",
           "RRAMBackendConfig", "ShapeConfig", "TrainConfig", "ARCHS",
           "get_arch", "model_module"]
