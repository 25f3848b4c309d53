"""mixtral-8x7b -- 8-expert top-2 MoE with sliding-window attention [arXiv:2401.04088]."""
from .base import ArchConfig, ModelConfig

ARCH = ArchConfig(
    name="mixtral-8x7b",
    model=ModelConfig(
        family="moe", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_head=128, d_ff=14336, vocab=32000, act="silu_gated",
        n_experts=8, experts_per_token=2, swa_window=4096, rope_theta=1e6,
    ),
    # SWA makes decode memory O(window): long_500k runs with a rolling cache.
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    source="arXiv:2401.04088; hf",
)
