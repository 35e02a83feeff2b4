"""Public kernel entry points with the JAX ops' boundary and padding
contract (``repro.kernels.ops``): the N-block clamp ``min(bn, max(128,
n))`` and the boundary rounded up to that block.  The kernel wrappers pad
K (and the packed stream's K) to a multiple of 4 themselves.  Also the
ODiMO deployment helper, `odimo_deployed_dense`, which runs a discretized
layer through the fused split_precision kernel."""
from __future__ import annotations

import numpy as np
import torch

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


def deploy_plan(assign, device):
    """The paper's Fig. 3 reorg of a layer with per-column domains
    ``assign`` (0 = int8, 1 = bf16), made on the host: ``(perm, inv,
    boundary)``, the stable sort of the columns by domain (ties keep their
    order) and its inverse as index tensors on ``device``, and the count
    of int8 columns."""
    if torch.is_tensor(assign):
        assign = assign.cpu()
    assign = np.asarray(assign)
    perm = np.argsort(assign, kind="stable")
    return (torch.as_tensor(perm, device=device),
            torch.as_tensor(np.argsort(perm), device=device),
            int((assign == 0).sum()))


def deploy_dense(x, w, plan, w_log_scale, x_log_scale):
    """The device half of `odimo_deployed_dense` for a `deploy_plan`:
    quantizes x and the permuted w at the int8 domain's per-tensor
    log-scales, runs the fused two-domain matmul (`split_precision_op`:
    the columns in ``[boundary, aligned)`` run int8) and undoes the
    permutation.  The int8 codes go to the kernel K-major, the bf16 weight
    row-major: no per-call weight copy.  It makes no host transfer, so a
    CUDA graph can capture it."""
    from repro_torch.core import quant
    perm, inv, boundary = plan
    dev = x.device
    levels = quant.qlevels(8)
    xls = torch.as_tensor(x_log_scale, dtype=torch.float32, device=dev)
    wls = torch.as_tensor(w_log_scale, dtype=torch.float32, device=dev)
    wp = w.index_select(1, perm)
    sx = (torch.exp(xls) / levels).reshape(1)
    sw = (torch.exp(wls) / levels).reshape(1).expand(w.shape[1]).contiguous()
    x_q = quant.quantize_int(x, xls, 8)
    w_q = quant.quantize_int(wp.t().contiguous(), wls, 8).t()
    out = split_precision_op(x.to(torch.bfloat16), x_q, sx,
                             wp.to(torch.bfloat16), w_q, sw, boundary)
    return out.index_select(1, inv)


def odimo_deployed_dense(x, w, assign, w_log_scale, x_log_scale):
    """Run an ODiMO-discretized Dense layer through the fused kernel, on
    the device of ``x``.

    x (M, K) float; w (K, N) float; assign (N,) domain per column (0 =
    int8, 1 = bf16); w_log_scale / x_log_scale: the int8 domain's
    per-tensor quantization log-scales.  Performs the paper's Fig. 3 reorg
    (`deploy_plan`), the fused two-domain matmul and the inverse
    permutation (`deploy_dense`), so the output is in the ORIGINAL column
    order."""
    return deploy_dense(x, w, deploy_plan(assign, x.device), w_log_scale,
                        x_log_scale)
