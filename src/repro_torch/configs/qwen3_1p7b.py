"""qwen3-1.7b -- dense GQA with qk_norm [hf:Qwen/Qwen3-8B family]."""
from .base import ArchConfig, ModelConfig

ARCH = ArchConfig(
    name="qwen3-1.7b",
    model=ModelConfig(
        family="transformer", n_layers=28, d_model=2048, n_heads=16,
        n_kv_heads=8, d_head=128, d_ff=6144, vocab=151936, act="silu_gated",
        qk_norm=True, rope_theta=1e6,
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_reasons=(("long_500k", "pure full attention; no sub-quadratic path"),),
    source="hf:Qwen/Qwen3-8B; hf",
)
