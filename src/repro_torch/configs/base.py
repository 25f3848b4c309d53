"""Config dataclasses of the port (a copy of :mod:`repro.configs.base`):
model architecture, parallelism, RRAM backend, train/serve.

One ``ArchConfig`` per assigned architecture lives in
``repro_torch/configs/<id>.py``; the registry maps ``--arch`` ids to them.
Shapes (the assigned input-shape set) are global and arch-independent.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "MeshConfig", "RRAMBackendConfig", "TrainConfig",
           "ArchConfig", "ShapeConfig", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Superset of knobs across the model zoo; families ignore what they don't use."""

    family: str                    # transformer | moe | rwkv6 | zamba2 | whisper | llama_vision | meliso
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 128
    d_ff: int = 0
    vocab: int = 0
    act: str = "silu_gated"        # silu_gated | sq_relu | gelu
    qk_norm: bool = False
    rope_theta: float = 1e4
    swa_window: Optional[int] = None      # sliding-window attention (mixtral)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # MoE
    n_experts: int = 0
    experts_per_token: int = 2
    expert_capacity_factor: float = 1.25
    # SSM / RWKV
    ssm_state: int = 64            # mamba2 N (state channels per head)
    ssm_head_dim: int = 64
    d_conv: int = 4
    expand: int = 2                # mamba2 d_inner = expand * d_model
    attn_every: int = 6            # zamba2: shared attn block period
    # enc-dec (whisper)
    n_enc_layers: int = 0
    # vision (llama 3.2)
    cross_attn_every: int = 5      # 1 cross-attn layer per 5 decoder layers
    n_patches: int = 4096
    # dtype policy
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    @property
    def vocab_pad(self) -> int:
        """Embedding tables padded to a multiple of 256 so the vocab dim
        shards on any mesh (padded logit columns are masked to -inf)."""
        return -(-self.vocab // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Production mesh topology (the reference builds its device mesh from
    it; kept here so that configurations carry across unchanged)."""

    data: int = 16
    model: int = 16
    pods: int = 1

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.pods > 1 else ("data", "model")

    @property
    def shape(self) -> Tuple[int, ...]:
        return ((self.pods, self.data, self.model) if self.pods > 1
                else (self.data, self.model))

    @property
    def n_devices(self) -> int:
        return self.pods * self.data * self.model


@dataclasses.dataclass(frozen=True)
class RRAMBackendConfig:
    """Analog-execution backend for linear layers (the paper's technique)."""

    enabled: bool = False
    device: str = "taox-hfox"
    k_iters: int = 5
    ec: bool = True
    ec_mode: str = "fused"          # faithful | fused
    denoise_method: str = "neumann"  # dense | thomas | neumann
    lam: float = 1e-12
    cell_rows: int = 512
    cell_cols: int = 512
    encode_inputs: bool = True
    dw_dtype: str = "bfloat16"      # beyond-paper: compress the EC correction term


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    microbatch: Optional[int] = None        # per-device microbatch (grad accum)
    remat: str = "block"                    # none | block | full
    zero_sharded_opt: bool = True           # ZeRO-1 optimizer-state sharding
    grad_compression: Optional[str] = None  # None | "int8" (cross-pod)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    model: ModelConfig
    # Which assigned shapes are runnable (long_500k skipped for full attention).
    shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")
    skip_reasons: Tuple[Tuple[str, str], ...] = ()
    # Sharding mode per shape kind:
    train_sharding: str = "fsdp_tp"   # fsdp_tp | tp
    infer_sharding: str = "tp"
    source: str = ""

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        m = self.model
        return dataclasses.replace(
            m,
            n_layers=min(m.n_layers, 2),
            d_model=64,
            n_heads=max(2, min(m.n_heads, 4)),
            n_kv_heads=max(1, min(m.n_kv_heads, 2)),
            d_head=16,
            d_ff=128,
            vocab=256,
            n_experts=min(m.n_experts, 4) if m.n_experts else 0,
            n_enc_layers=min(m.n_enc_layers, 2),
            n_patches=16,
            ssm_state=16,
            ssm_head_dim=16,
            attn_every=2,
            cross_attn_every=2,
            swa_window=min(m.swa_window, 32) if m.swa_window else None,
            param_dtype="float32",
            compute_dtype="float32",
        )
