"""Hand-written CUDA kernels (``csrc/``) with their PyTorch wrappers, plain
versions and the ops contract of ``repro.kernels``."""
