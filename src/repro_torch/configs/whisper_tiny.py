"""whisper-tiny -- enc-dec audio backbone, conv frontend stubbed [arXiv:2212.04356]."""
from .base import ArchConfig, ModelConfig

ARCH = ArchConfig(
    name="whisper-tiny",
    model=ModelConfig(
        family="whisper", n_layers=4, n_enc_layers=4, d_model=384, n_heads=6,
        n_kv_heads=6, d_head=64, d_ff=1536, vocab=51865, act="gelu",
        rope_theta=0.0,          # whisper uses absolute (sinusoidal) positions
    ),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
    skip_reasons=(("long_500k", "full attention enc-dec; O(S^2) encoder"),),
    source="arXiv:2212.04356; unverified",
)
