"""rwkv6-1.6b -- Finch, attention-free, data-dependent decay [arXiv:2404.05892]."""
from .base import ArchConfig, ModelConfig

ARCH = ArchConfig(
    name="rwkv6-1.6b",
    model=ModelConfig(
        family="rwkv6", n_layers=24, d_model=2048, d_ff=7168, vocab=65536,
        ssm_head_dim=64,
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    source="arXiv:2404.05892; unverified",
)
