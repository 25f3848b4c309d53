"""Model zoo of the port: the families share the interface
``init_specs`` / ``loss`` / ``prefill`` / ``decode_step`` (see
:mod:`repro_torch.models.transformer`).  The transformer, MoE, whisper and
llama-vision families are ported; the recurrent ones are ROADMAP A12b-2."""
