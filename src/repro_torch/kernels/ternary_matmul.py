"""Ternary-weight matmul (the DIANA AIMC-domain layer): int8 ``x_q (M, K)``
@ weight codes ``w_t (K, N)`` in {-1, 0, +1} stored as int8 -> exact
int32, then ``f32(acc) * sx * sw[n]``.

The CUDA kernel (``csrc/ternary_matmul.cu``, sm_90a) replaces the Pallas
TPU kernel ``ternary_matmul`` of ``repro/kernels/ternary_matmul.py``.  What
bounds it on an H100: the int8 code stream at decode (M = batch), int8
operations at prefill.  It reads the codes K-major, as the (N, K) tensor
behind a transposed ``w_t`` view (the layout `runtime.execute.
prepare_layer` gives the ternary_matmul layers), through quant_matmul's two
GEMMs: at M <= 16 the decode GEMM of ``csrc/int8_gemv.cuh``, above that
the int8 ``wgmma`` GEMM of ``csrc/int8_wgmma.cuh`` on TMA tiles of the
codes, with K split over the blocks of a cluster where the output tiles
leave SMs idle (`launch_args`: the served M 512 x N 512 has 16 tiles for
132 SMs).  The output is bit-identical to `ternary_matmul_plain`.

`ternary_matmul` launches the kernel for CUDA tensors and runs
`ternary_matmul_plain` only for CPU tensors.  ``ternary_matmul.launches``
counts kernel launches, ``ternary_matmul.transposed_copies`` the calls that
copied ``w_t`` into the kernel's layout (`weight_route`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import quant_matmul as _qm
from repro_torch.kernels.quant_matmul import (DECODE_M, K_ALIGN, _aligned,
                                              _pad_to, check_operands,
                                              decode_args, k_major_weight,
                                              quant_matmul_plain, sm_count)
from repro_torch.kernels.split_precision import wgmma_split

#: plain PyTorch version: the codes contract like int8 codes (float64,
#: exact), then the w8a8 epilogue
ternary_matmul_plain = quant_matmul_plain


#: the K bytes of a stage of the wgmma GEMM on the codes (`Int8Codes`)
WGMMA_STAGE_K = 128


def launch_args(m: int, k: int, n: int, device: torch.device):
    """The plan arguments of a launch: the decode GEMM's ``(bn, split)`` at
    M <= 16, ``(0, wgmma_split)`` above (stages of `WGMMA_STAGE_K`)."""
    if m <= DECODE_M:
        return decode_args(m, k, n, device)
    return 0, wgmma_split(m, k, n, sm_count(device), WGMMA_STAGE_K)


def weight_route(shape, strides, aligned=True) -> str:
    """How `ternary_matmul` hands a ``(K, N)`` ``w_t`` of these strides to
    the kernel (``"k_major"``, ``"pad"`` or ``"transpose"``, as
    `quant_matmul.weight_route`)."""
    return _qm.weight_route(shape, strides, aligned)


def kernel_operands(x_q, w_t):
    """The operands the kernel takes, on any device: x_q with K padded to
    `K_ALIGN` and ``w_t`` as the K-major ``(N, K_pad)`` codes (a copy is
    counted in ``ternary_matmul.transposed_copies``)."""
    return (_aligned(_pad_to(x_q, K_ALIGN, 1), 16),
            k_major_weight(w_t, ternary_matmul))


def ternary_matmul(x_q, w_t, sx, sw):
    """x_q (M, K) int8, w_t (K, N) int8 codes in {-1, 0, 1} (any strides;
    the transposed view of a contiguous (N, K) tensor goes to the kernel
    without a copy), sx one-element f32, sw (N,) f32 -> (M, N) f32.  K is
    zero-padded to a multiple of `K_ALIGN` for the kernel."""
    m, k, n = check_operands(x_q, w_t, sx, sw)
    if x_q.device.type == "cpu":
        return ternary_matmul_plain(x_q, w_t, sx, sw)
    if x_q.device.type != "cuda":
        raise ValueError(f"no ternary_matmul kernel for {x_q.device}")
    xq, wk = kernel_operands(x_q, w_t)
    swc = _aligned(sw, 8)
    sxc = sx.reshape(1).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    if m and n:
        _build.launch("ternary_matmul", xq.data_ptr(), wk.data_ptr(),
                      sxc.data_ptr(), swc.data_ptr(), out.data_ptr(),
                      m, n, wk.shape[1],
                      *launch_args(m, wk.shape[1], n, x_q.device),
                      torch.cuda.current_stream(x_q.device).cuda_stream)
        ternary_matmul.launches += 1
    return out


ternary_matmul.launches = 0
ternary_matmul.transposed_copies = 0
