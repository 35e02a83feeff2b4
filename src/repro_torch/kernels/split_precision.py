"""Fused int8 + bf16 two-domain matmul (the paper's Fig. 3 layer on a GPU
tensor-core pair): output columns below ``boundary`` are ``f32(x_q @ w_q)
* sx * sw[n]`` (exact int32 accumulation), columns at or above it ``x_bf16
@ w_bf16`` with float32 accumulation; one float32 output.

The CUDA kernel (``csrc/split_precision.cu``, sm_90a) replaces the Pallas
TPU kernel ``split_precision_matmul`` of ``repro/kernels/
split_precision.py``.  What bounds it on an H100: the weight stream at
decode (int8 codes below the boundary, bf16 above), operations at prefill.
The int8 columns run the ``__dp4a`` mainloop of ``csrc/int8_gemm.cuh``,
the bf16 columns an FMA mainloop over bf16 tiles in shared memory; the
choice is made per column, and ``w_q`` is read only below the boundary,
``w_bf16`` only at or above it.

The int8 columns are bit-identical to `split_precision_plain`.  The bf16
columns sum K products in another order than the plain version (which
contracts in float64 and rounds once), so they agree within the float32
summation bound ``K * 2**-24 * sum_k |x * w| + 2**-24 * |y|``
(`bf16_error_bound`).

`split_precision` launches the kernel for CUDA tensors and runs
`split_precision_plain` only for CPU tensors.  ``split_precision.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant_matmul import (_pad_to, check_operands,
                                              quant_matmul_plain)


def split_precision_plain(x, x_q, sx, w_bf16, w_q, sw, boundary: int):
    """Plain PyTorch version: columns [0, boundary) from the int8 codes
    (float64, exact), [boundary, N) from the bf16 operands contracted in
    float64 and rounded once to float32."""
    lo = quant_matmul_plain(x_q, w_q, sx, sw)
    hi = (x.to(torch.float64) @ w_bf16.to(torch.float64)).to(torch.float32)
    cols = torch.arange(w_q.shape[1], device=w_q.device)[None, :]
    return torch.where(cols < boundary, lo, hi)


def bf16_error_bound(x, w_bf16, y):
    """Worst-case |error| of a float32 sum of the K bf16 products of each
    output, against the once-rounded ``y``: ``K * 2**-24 * sum_k |x w| +
    2**-24 * |y|`` (float64)."""
    mag = x.to(torch.float64).abs() @ w_bf16.to(torch.float64).abs()
    return x.shape[1] * 2.0**-24 * mag + 2.0**-24 * y.to(torch.float64).abs()


def split_precision(x, x_q, sx, w_bf16, w_q, sw, boundary: int):
    """x (M, K) bf16, x_q (M, K) int8, sx one-element f32, w_bf16 (K, N)
    bf16, w_q (K, N) int8, sw (N,) f32; boundary: first bf16-domain column
    -> (M, N) f32.  K and N are zero-padded to multiples of 4."""
    m, k, n = check_operands(x_q, w_q, sx, sw)
    if x.dtype != torch.bfloat16 or w_bf16.dtype != torch.bfloat16:
        raise TypeError(f"bf16 operands expected, got {x.dtype} and "
                        f"{w_bf16.dtype}")
    if tuple(x.shape) != (m, k) or tuple(w_bf16.shape) != (k, n):
        raise ValueError(f"x {tuple(x.shape)} and w_bf16 "
                         f"{tuple(w_bf16.shape)} do not match x_q "
                         f"{tuple(x_q.shape)} and w_q {tuple(w_q.shape)}")
    if x.device != x_q.device or w_bf16.device != x_q.device:
        raise ValueError(f"operands on {x_q.device}, {x.device} and "
                         f"{w_bf16.device}")
    if not 0 <= boundary <= n:
        raise ValueError(f"boundary {boundary} outside [0, {n}]")
    if x_q.device.type == "cpu":
        return split_precision_plain(x, x_q, sx, w_bf16, w_q, sw, boundary)
    if x_q.device.type != "cuda":
        raise ValueError(f"no split_precision kernel for {x_q.device}")
    xb = _pad_to(x, 4, 1).contiguous()
    xq = _pad_to(x_q, 4, 1).contiguous()
    wb = _pad_to(_pad_to(w_bf16, 4, 0), 4, 1).contiguous()
    wq = _pad_to(_pad_to(w_q, 4, 0), 4, 1).contiguous()
    swp = _pad_to(sw, 4, 0).contiguous()
    sxc = sx.reshape(1).contiguous()
    n4, k4 = wq.shape[1], wq.shape[0]
    out = torch.empty((m, n4), dtype=torch.float32, device=x_q.device)
    if m:
        _build.launch("split_precision", xb.data_ptr(), xq.data_ptr(),
                      wb.data_ptr(), wq.data_ptr(), sxc.data_ptr(),
                      swp.data_ptr(), out.data_ptr(), m, n4, k4,
                      int(boundary), torch.cuda.current_stream(
                          x_q.device).cuda_stream)
        split_precision.launches += 1
    return out[:, :n] if n4 != n else out


split_precision.launches = 0
