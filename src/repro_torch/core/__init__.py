"""Quantization, discretization and the cost models the DIANA emission
needs (``repro.core`` counterparts)."""
