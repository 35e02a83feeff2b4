"""Ternary-weight matmul (the DIANA AIMC-domain layer): int8 ``x_q (M, K)``
@ weight codes ``w_t (K, N)`` in {-1, 0, +1} stored as int8 -> exact
int32, then ``f32(acc) * sx * sw[n]``.

The CUDA kernel (``csrc/ternary_matmul.cu``, sm_90a) replaces the Pallas
TPU kernel ``ternary_matmul`` of ``repro/kernels/ternary_matmul.py``.  What
bounds it on an H100: the int8 code stream at decode (M = batch), int8
operations at prefill.  It is the shared-memory-tiled ``__dp4a`` GEMM of
``csrc/int8_gemm.cuh`` with its own entry point, so the output is
bit-identical to `ternary_matmul_plain`.

`ternary_matmul` launches the kernel for CUDA tensors and runs
`ternary_matmul_plain` only for CPU tensors.  ``ternary_matmul.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant_matmul import (_pad_to, check_operands,
                                              quant_matmul_plain)

#: plain PyTorch version: the codes contract like int8 codes (float64,
#: exact), then the w8a8 epilogue
ternary_matmul_plain = quant_matmul_plain


def ternary_matmul(x_q, w_t, sx, sw):
    """x_q (M, K) int8, w_t (K, N) int8 codes in {-1, 0, 1}, sx
    one-element f32, sw (N,) f32 -> (M, N) f32.  K and N are zero-padded
    to multiples of 4 for the kernel's 4-byte loads."""
    m, k, n = check_operands(x_q, w_t, sx, sw)
    if x_q.device.type == "cpu":
        return ternary_matmul_plain(x_q, w_t, sx, sw)
    if x_q.device.type != "cuda":
        raise ValueError(f"no ternary_matmul kernel for {x_q.device}")
    xq = _pad_to(x_q, 4, 1).contiguous()
    wt = _pad_to(_pad_to(w_t, 4, 0), 4, 1).contiguous()
    swp = _pad_to(sw, 4, 0).contiguous()
    sxc = sx.reshape(1).contiguous()
    n4, k4 = wt.shape[1], wt.shape[0]
    out = torch.empty((m, n4), dtype=torch.float32, device=x_q.device)
    if m:
        _build.launch("ternary_matmul", xq.data_ptr(), wt.data_ptr(),
                      sxc.data_ptr(), swp.data_ptr(), out.data_ptr(),
                      m, n4, k4, torch.cuda.current_stream(
                          x_q.device).cuda_stream)
        ternary_matmul.launches += 1
    return out[:, :n] if n4 != n else out


ternary_matmul.launches = 0
