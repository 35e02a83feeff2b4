"""The attention-only LM of the port (``repro.models`` counterparts)."""
