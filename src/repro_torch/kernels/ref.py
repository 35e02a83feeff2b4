"""Plain PyTorch oracles of the kernels (``repro.kernels.ref``
counterparts); integer contractions are exact."""
from repro_torch.kernels.quant_matmul import quant_matmul_plain
from repro_torch.kernels.split_ternary import split_ternary_matmul_ref

quant_matmul_ref = quant_matmul_plain

__all__ = ["quant_matmul_ref", "split_ternary_matmul_ref"]
