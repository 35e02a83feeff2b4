"""Ternary matmul on 2-bit-packed weight codes: int8 ``x_q (M, K)`` @
``unpack(w_packed)`` -> exact int32, then ``f32(acc) * sx * sw[n]``; and
the packing itself, the layout ``split_ternary`` also streams for its
ternary columns.

``w_packed[k, n]`` holds the codes of K rows ``4k .. 4k+3`` of column n,
code c in bits ``2c .. 2c+1``, biased by +1 (00 -> -1, 01 -> 0, 10 -> +1):
bit-identical to ``repro.kernels.ternary_packed``.

The CUDA kernel (``csrc/ternary_packed.cu``, sm_90a) replaces the Pallas
TPU kernel ``ternary_packed_matmul`` of ``repro/kernels/ternary_packed.py``.
What bounds it on an H100: the packed weight stream at decode (K/4 * N
bytes, 4x fewer than ``ternary_matmul``'s int8 codes), int8 operations at
prefill.  At M <= 16 it is the decode GEMM of ``csrc/int8_gemv.cuh``, each
packed byte unpacked in registers into one operand word of ``mma.sync``
int8 products, K slices spread over the blocks of a cluster; above that
the int8 ``wgmma`` GEMM of
``csrc/int8_wgmma.cuh``, TMA loading the stream as it is stored and the
consumer warpgroups unpacking it in shared memory.  Nothing is unpacked to
global memory, and the output is bit-identical to `ternary_packed_plain`.

`ternary_packed_matmul` launches the kernel for CUDA tensors and runs
`ternary_packed_plain` only for CPU tensors.
``ternary_packed_matmul.launches`` counts kernel launches,
``ternary_packed_matmul.padded_copies`` the calls that copied the stream
to pad its N or align its address (`packed_stream`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant_matmul import (K_ALIGN, _aligned, _pad_to,
                                              check_epilogue, decode_args,
                                              quant_matmul_plain)


def n_align(m: int) -> int:
    """The multiple of N the packed and split kernels take at M = ``m``: 16
    for the wgmma GEMM (M > 16; a TMA row stride is a multiple of 16
    bytes), 4 for the decode GEMM (2-byte loads of packed column pairs,
    8-byte loads of 4 bf16 columns)."""
    return 16 if m > 16 else 4


def packed_stream(w_packed: torch.Tensor, align: int):
    """(``w_packed`` as the kernels read it: contiguous, 16-byte aligned, N
    zero-padded to ``align``; whether that took a copy)."""
    if w_packed.is_contiguous() and w_packed.shape[1] % align == 0 and \
            w_packed.data_ptr() % 16 == 0:
        return w_packed, False
    return _aligned(_pad_to(w_packed, align, 1), 16), True


def pack_ternary(w_t: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 codes in {-1, 0, 1} -> (K//4, N) uint8 packed."""
    K, N = w_t.shape
    if K % 4:
        raise ValueError(f"pack_ternary needs K % 4 == 0, got K={K}")
    b = (w_t.to(torch.int16) + 1).to(torch.uint8).reshape(K // 4, 4, N)
    return b[:, 0] | (b[:, 1] << 2) | (b[:, 2] << 4) | (b[:, 3] << 6)


def unpack_ternary(w_p: torch.Tensor) -> torch.Tensor:
    """(K//4, N) uint8 -> (K, N) int8 codes."""
    Kp, N = w_p.shape
    parts = [((w_p >> (2 * j)) & 3).to(torch.int8) - 1 for j in range(4)]
    return torch.stack(parts, dim=1).reshape(Kp * 4, N)


def ternary_packed_plain(x_q, w_packed, sx, sw):
    """Plain PyTorch version: the w8a8 oracle on the unpacked codes (their
    rows past K dropped)."""
    return quant_matmul_plain(x_q, unpack_ternary(w_packed)[:x_q.shape[1]],
                              sx, sw)


def kernel_operands(x_q, w_packed, sw):
    """The operands the kernel takes, on any device: x_q with K padded to
    `K_ALIGN`, the packed stream and ``sw`` with N padded to `n_align` (M)
    (zeros; a copy of the stream is counted)."""
    na = n_align(x_q.shape[0])
    wp, copied = packed_stream(w_packed, na)
    ternary_packed_matmul.padded_copies += copied
    return (_aligned(_pad_to(x_q, K_ALIGN, 1), 16), wp,
            _aligned(_pad_to(sw, na, 0), 16))


def ternary_packed_matmul(x_q, w_packed, sx, sw):
    """x_q (M, K) int8; w_packed (ceil(K/4), N) uint8 (rows past K hold
    code 0); sx one-element f32; sw (N,) f32 -> (M, N) f32.  K is
    zero-padded to `K_ALIGN` and N to `n_align` (M) for the kernel."""
    m, k = x_q.shape
    if w_packed.dtype != torch.uint8 or w_packed.dim() != 2:
        raise TypeError(f"w_packed must be 2-d uint8, got "
                        f"{w_packed.dtype} {tuple(w_packed.shape)}")
    kp = w_packed.shape[0]
    if not k <= 4 * kp <= k + 3:
        raise ValueError(f"w_packed {tuple(w_packed.shape)} does not pack "
                         f"the K={k} of x_q {tuple(x_q.shape)}")
    check_epilogue(x_q, w_packed, sx, sw)
    n = w_packed.shape[1]
    if x_q.device.type == "cpu":
        return ternary_packed_plain(x_q, w_packed, sx, sw)
    if x_q.device.type != "cuda":
        raise ValueError(f"no ternary_packed kernel for {x_q.device}")
    _build.refuse_grad("ternary_packed", x_q, w_packed, sx, sw)
    xq, wp, swp = kernel_operands(x_q, w_packed, sw)
    sxc = sx.reshape(1).contiguous()
    n_pad = wp.shape[1]
    out = torch.empty((m, n_pad), dtype=torch.float32, device=x_q.device)
    if m:
        _build.launch("ternary_packed", xq.data_ptr(), wp.data_ptr(),
                      sxc.data_ptr(), swp.data_ptr(), out.data_ptr(),
                      m, n_pad, xq.shape[1], kp,
                      *decode_args(m, xq.shape[1], n_pad, x_q.device),
                      torch.cuda.current_stream(x_q.device).cuda_stream)
        ternary_packed_matmul.launches += 1
    return out[:, :n] if n_pad != n else out


ternary_packed_matmul.launches = 0
ternary_packed_matmul.padded_copies = 0
