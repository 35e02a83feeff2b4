"""Fused int8 + ternary two-domain matmul (the DIANA digital + AIMC
pairing): columns below ``boundary`` contract the int8 codes ``w_q``,
columns at or above it the 2-bit-packed ternary stream ``w_packed``; one
exact int32 accumulator, then ``f32(acc) * sx * sw[n]``.

The CUDA kernel (``csrc/split_ternary.cu``, sm_90a) replaces the Pallas TPU
kernel ``split_ternary_matmul`` of ``repro/kernels/split_ternary.py``.
What bounds it on an H100: the weight stream at decode (the ternary side is
4x smaller than int8, which is the kernel's point), int8 operations at
prefill.  Each packed byte (4 consecutive K rows of one column) unpacks in
registers into one ``__dp4a`` operand; ``w_q`` is never read for ternary
columns and nothing is unpacked to global memory.  The choice between the
two streams is made per column, so any boundary is exact.

`split_ternary` launches the kernel for CUDA tensors and runs
`split_ternary_plain` only for CPU tensors.  ``split_ternary.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant_matmul import (_pad_to, check_operands,
                                              dequant, int_matmul_exact)
from repro_torch.kernels.ternary_packed import unpack_ternary


def split_ternary_matmul_ref(x_q, w_q, w_t, sx, sw, boundary: int):
    """Oracle: output columns [0, boundary) from the int8 codes ``w_q``,
    [boundary, N) from the ternary codes ``w_t`` (both (K, N) int8)."""
    lo = int_matmul_exact(x_q, w_q)
    hi = int_matmul_exact(x_q, w_t)
    cols = torch.arange(w_q.shape[1], device=w_q.device)[None, :]
    return dequant(torch.where(cols < boundary, lo, hi), sx, sw)


def split_ternary_plain(x_q, w_q, w_packed, sx, sw, boundary: int):
    """Plain PyTorch version of the kernel: the oracle on the unpacked
    ``w_packed`` (its rows past K dropped)."""
    w_t = unpack_ternary(w_packed)[:x_q.shape[1]]
    return split_ternary_matmul_ref(x_q, w_q, w_t, sx, sw, boundary)


def split_ternary(x_q, w_q, w_packed, sx, sw, boundary: int):
    """x_q (M, K) int8; w_q (K, N) int8 codes; w_packed (ceil(K/4), N)
    uint8 (rows past K hold code 0); sx one-element f32; sw (N,) f32;
    boundary: first column read from the packed stream."""
    m, k, n = check_operands(x_q, w_q, sx, sw)
    k4 = 4 * w_packed.shape[0]
    if w_packed.dtype != torch.uint8 or w_packed.dim() != 2 or \
            w_packed.shape[1] != n or not k <= k4 <= k + 3:
        raise ValueError(f"w_packed {tuple(w_packed.shape)} "
                         f"{w_packed.dtype} does not pack w_q "
                         f"{tuple(w_q.shape)}")
    if not 0 <= boundary <= n:
        raise ValueError(f"boundary {boundary} outside [0, {n}]")
    if x_q.device.type == "cpu":
        return split_ternary_plain(x_q, w_q, w_packed, sx, sw, boundary)
    if x_q.device.type != "cuda":
        raise ValueError(f"no split_ternary kernel for {x_q.device}")
    if w_packed.device != x_q.device:
        raise ValueError(f"operands on {x_q.device} and {w_packed.device}")
    xq = _pad_to(x_q, 4, 1).contiguous()
    wq = _pad_to(_pad_to(w_q, 4, 0), 4, 1).contiguous()
    wp = _pad_to(w_packed, 4, 1).contiguous()
    swp = _pad_to(sw, 4, 0).contiguous()
    sxc = sx.reshape(1).contiguous()
    n4 = wq.shape[1]
    out = torch.empty((m, n4), dtype=torch.float32, device=x_q.device)
    if m:
        _build.launch("split_ternary", xq.data_ptr(), wq.data_ptr(),
                      wp.data_ptr(), sxc.data_ptr(), swp.data_ptr(),
                      out.data_ptr(), m, n4, k4, int(boundary),
                      torch.cuda.current_stream(x_q.device).cuda_stream)
        split_ternary.launches += 1
    return out[:, :n] if n4 != n else out


split_ternary.launches = 0
