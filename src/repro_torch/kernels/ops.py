"""Public kernel entry points with the JAX ops' boundary and padding
contract (``repro.kernels.ops``): the N-block clamp ``min(bn, max(128,
n))`` and the boundary rounded up to that block.  The kernel wrappers pad
K (and the packed stream's K) to a multiple of 4 themselves."""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.quant_matmul import _pad_to, quant_matmul
from repro_torch.kernels.split_precision import split_precision
from repro_torch.kernels.split_ternary import split_ternary
from repro_torch.kernels.ternary_matmul import ternary_matmul
from repro_torch.kernels.ternary_packed import ternary_packed_matmul


def align_boundary(boundary: int, bn: int) -> int:
    """Round a domain boundary UP to the N-block size (the extra columns
    execute on the quantized domain).  `runtime.lower` records boundaries
    aligned with exactly this function."""
    return int(-(-int(boundary) // int(bn)) * int(bn))


def block_n(bn: int, n: int) -> int:
    """The effective N-block of a layer with ``n`` output columns."""
    return min(int(bn), max(128, int(n)))


#: w8a8 matmul, any shape (the kernel wrapper pads K and N itself)
quant_matmul_op = quant_matmul
#: ternary-code matmul, any shape (the kernel wrapper pads K and N itself)
ternary_matmul_op = ternary_matmul
#: 2-bit-packed ternary matmul, any shape: ``w_packed`` has ``ceil(K/4)``
#: rows, and the kernel wrapper pads K to them and N to a multiple of 4
ternary_packed_matmul_op = ternary_packed_matmul


def split_precision_op(x, x_q, sx, w_bf16, w_q, sw, boundary: int, bn=128):
    """Fused int8 + bf16 layer (paper Fig. 3); ``boundary`` (the first
    bf16-domain column) is rounded UP to the effective N-block, so the
    columns in ``[boundary, aligned)`` execute on the int8 path.  Unlike
    `split_ternary_op` this changes the numbers, so the kernel splits at
    exactly that column, whatever its own tile width."""
    n = w_q.shape[1]
    b_al = min(align_boundary(boundary, block_n(bn, n)), n)
    return split_precision(x, x_q, sx, w_bf16, w_q, sw, b_al)


def split_ternary_op(x_q, w_q, w_packed, sx, sw, boundary: int, bn=128):
    """Fused ternary + int8 layer; ``boundary`` (the first ternary-domain
    column) is rounded UP to the effective N-block, so straddling columns
    execute on the int8 path (``w_q`` carries every column's codes).
    ``w_packed`` has ``ceil(K/4)`` rows; the kernel wrapper pads K."""
    n = w_q.shape[1]
    b_al = min(align_boundary(boundary, block_n(bn, n)), n)
    return split_ternary(x_q, w_q, w_packed, sx, sw, b_al)


def flash_attention_op(q, k, v, causal=True, bq=256, bk=512):
    """(B, H, Sq, D) x (B, KVH, Sk, D) -> (B, H, Sq, D); pads Sq and Sk to
    the JAX op's blocks ``min(bq, max(8, Sq))`` and ``min(bk, max(128,
    Sk))``.  The padded keys are masked (``kv_len=Sk``), so they receive
    no probability mass, causal or not."""
    Sq, Sk = q.shape[2], k.shape[2]
    bq_, bk_ = min(bq, max(8, Sq)), min(bk, max(128, Sk))
    out = flash_attention(_pad_to(q, bq_, 2), _pad_to(k, bk_, 2),
                          _pad_to(v, bk_, 2), causal=causal, kv_len=Sk)
    return out[:, :, :Sq, :]
