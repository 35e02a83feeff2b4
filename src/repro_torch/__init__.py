"""repro_torch: the PyTorch / CUDA port of ``repro`` for an NVIDIA H100.

Same subpackage layout and module names as ``repro``; imports neither JAX
nor ``repro``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
__version__ = "0.1.0"
