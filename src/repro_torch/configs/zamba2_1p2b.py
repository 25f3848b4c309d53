"""zamba2-1.2b -- Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
from .base import ArchConfig, ModelConfig

ARCH = ArchConfig(
    name="zamba2-1.2b",
    model=ModelConfig(
        family="zamba2", n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_head=64, d_ff=8192, vocab=32000, ssm_state=64, ssm_head_dim=64,
        expand=2, d_conv=4, attn_every=6,
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    source="arXiv:2411.15242; hf",
)
