"""nemotron-4-15b -- dense GQA, squared-ReLU MLP [arXiv:2402.16819]."""
from .base import ArchConfig, ModelConfig

ARCH = ArchConfig(
    name="nemotron-4-15b",
    model=ModelConfig(
        family="transformer", n_layers=32, d_model=6144, n_heads=48,
        n_kv_heads=8, d_head=128, d_ff=24576, vocab=256000, act="sq_relu",
        rope_theta=1e4,
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_reasons=(("long_500k", "pure full attention; no sub-quadratic path"),),
    source="arXiv:2402.16819; unverified",
)
