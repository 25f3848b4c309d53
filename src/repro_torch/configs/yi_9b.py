"""yi-9b -- llama-arch dense GQA [arXiv:2403.04652]."""
from .base import ArchConfig, ModelConfig

ARCH = ArchConfig(
    name="yi-9b",
    model=ModelConfig(
        family="transformer", n_layers=48, d_model=4096, n_heads=32,
        n_kv_heads=4, d_head=128, d_ff=11008, vocab=64000, act="silu_gated",
        rope_theta=5e6,
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_reasons=(("long_500k", "pure full attention; no sub-quadratic path"),),
    source="arXiv:2403.04652; hf",
)
