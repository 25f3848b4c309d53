"""Model zoo of the port: the families share the interface
``init_specs`` / ``loss`` / ``prefill`` / ``decode_step`` (see
:mod:`repro_torch.models.transformer`).  The transformer family is ported;
the others are ROADMAP A12b."""
