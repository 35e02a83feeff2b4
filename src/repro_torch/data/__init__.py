"""Synthetic data streams (``repro.data`` counterparts)."""
