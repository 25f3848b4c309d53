"""phi3.5-moe-42b-a6.6b -- 16-expert top-2 MoE [hf:microsoft/Phi-3.5-MoE-instruct]."""
from .base import ArchConfig, ModelConfig

ARCH = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    model=ModelConfig(
        family="moe", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_head=128, d_ff=6400, vocab=32064, act="silu_gated",
        n_experts=16, experts_per_token=2, rope_theta=1e4,
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_reasons=(("long_500k", "pure full attention; no sub-quadratic path"),),
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf",
)
