"""Model zoo of the port: the families share the interface
``init_specs`` / ``loss`` / ``prefill`` / ``decode_step`` (see
:mod:`repro_torch.models.transformer`): the transformer, MoE, whisper,
llama-vision, RWKV-6 and Zamba2 (Mamba-2) families."""
