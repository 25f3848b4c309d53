"""llama-3.2-vision-11b -- decoder with gated cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision]."""
from .base import ArchConfig, ModelConfig

ARCH = ArchConfig(
    name="llama-3.2-vision-11b",
    model=ModelConfig(
        family="llama_vision", n_layers=40, d_model=4096, n_heads=32,
        n_kv_heads=8, d_head=128, d_ff=14336, vocab=128256, act="silu_gated",
        cross_attn_every=5, n_patches=4096, rope_theta=5e5,
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_reasons=(("long_500k", "pure full attention; no sub-quadratic path"),),
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
