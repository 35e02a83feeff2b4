"""Plain PyTorch oracles of the kernels (``repro.kernels.ref``
counterparts); integer contractions are exact, the bf16 contraction of
`split_precision_matmul_ref` is float64 rounded once to float32."""
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.quant_matmul import quant_matmul_plain
from repro_torch.kernels.split_precision import split_precision_plain
from repro_torch.kernels.split_ternary import split_ternary_matmul_ref

quant_matmul_ref = quant_matmul_plain
#: ternary codes contract like int8 codes
ternary_matmul_ref = quant_matmul_plain
#: (x, x_q, sx, w_bf16, w_q, sw, boundary), the JAX oracle's arguments
split_precision_matmul_ref = split_precision_plain

__all__ = ["flash_attention_ref", "quant_matmul_ref",
           "split_precision_matmul_ref", "split_ternary_matmul_ref",
           "ternary_matmul_ref"]
