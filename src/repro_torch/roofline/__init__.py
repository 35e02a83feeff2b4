"""Roofline analysis of the port (``repro.roofline`` counterpart)."""
