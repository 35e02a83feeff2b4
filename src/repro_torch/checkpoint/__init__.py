"""Checkpoints (``repro.checkpoint`` counterpart)."""
