"""Fused int8 + ternary two-domain matmul (the DIANA digital + AIMC
pairing): columns below ``boundary`` contract the int8 codes ``w_q``,
columns at or above it the 2-bit-packed ternary stream ``w_packed``; one
exact int32 accumulator, then ``f32(acc) * sx * sw[n]``.

The CUDA kernel (``csrc/split_ternary.cu``, sm_90a) replaces the Pallas TPU
kernel ``split_ternary_matmul`` of ``repro/kernels/split_ternary.py``.
What bounds it on an H100: the weight stream at decode (the ternary side is
4x smaller than int8, which is the kernel's point), int8 operations at
prefill.  It reads ``w_q`` K-major, as the (N, K) tensor behind a
transposed view (the layout `runtime.execute.prepare_layer` gives the
split_ternary layers), and the packed stream as it is stored.  At M <= 16
the decode GEMM of ``csrc/int8_gemv.cuh`` unpacks each packed byte in
registers into one operand word of ``mma.sync`` int8 products, its K
slices spread over the blocks of a cluster; above that int8 ``wgmma``
tiles are fed by a TMA ring, with the packed tiles unpacked in shared
memory.  ``w_q`` is never read for ternary
columns, nothing is unpacked to global memory, and the choice between the
two streams is made per column, so any boundary is exact.

`split_ternary` launches the kernel for CUDA tensors and runs
`split_ternary_plain` only for CPU tensors.  ``split_ternary.launches``
counts kernel launches, ``split_ternary.transposed_copies`` the weight
copies calls had to make (`weight_route`; a packed stream whose N or
address is off the alignment, padded, counts one too).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import quant_matmul as _qm
from repro_torch.kernels.quant_matmul import (K_ALIGN, _aligned, _pad_to,
                                              check_operands, decode_args,
                                              dequant, int_matmul_exact,
                                              k_major_weight)
from repro_torch.kernels.ternary_packed import (n_align, packed_stream,
                                                unpack_ternary)


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


def weight_route(shape, strides, m, aligned=True) -> str:
    """How `split_ternary` hands a ``(K, N)`` ``w_q`` of these strides to
    the kernel at M = ``m`` (``"k_major"``, ``"pad"`` or ``"transpose"``,
    as `quant_matmul.weight_route`), N aligned to `n_align` (m)."""
    return _qm.weight_route(shape, strides, aligned, n_align(m))


def kernel_operands(x_q, w_q, w_packed, sw):
    """The operands the kernel takes, on any device: x_q with K padded to
    `K_ALIGN`, ``w_q`` as the K-major ``(N_pad, K_pad)`` codes, the packed
    stream and ``sw`` with N padded to `n_align` (M) (zeros); copies of a
    weight are counted in ``split_ternary.transposed_copies``."""
    m = x_q.shape[0]
    na = n_align(m)
    wk = k_major_weight(w_q, split_ternary, na)
    wp, copied = packed_stream(w_packed, na)
    split_ternary.transposed_copies += copied
    xq = _aligned(_pad_to(x_q, K_ALIGN, 1), 16)
    swp = _aligned(_pad_to(sw, na, 0), 16)
    return xq, wk, wp, swp


def split_ternary(x_q, w_q, w_packed, sx, sw, boundary: int):
    """x_q (M, K) int8; w_q (K, N) int8 codes (any strides; the transposed
    view of a contiguous (N, K) tensor goes to the kernel without a copy);
    w_packed (ceil(K/4), N) uint8 (rows past K hold code 0); sx one-element
    f32; sw (N,) f32; boundary: first column read from the packed
    stream."""
    m, k, n = check_operands(x_q, w_q, sx, sw)
    kp = w_packed.shape[0]
    if w_packed.dtype != torch.uint8 or w_packed.dim() != 2 or \
            w_packed.shape[1] != n or not k <= 4 * kp <= k + 3:
        raise ValueError(f"w_packed {tuple(w_packed.shape)} "
                         f"{w_packed.dtype} does not pack w_q "
                         f"{tuple(w_q.shape)}")
    if not 0 <= boundary <= n:
        raise ValueError(f"boundary {boundary} outside [0, {n}]")
    if x_q.device.type == "cpu":
        return split_ternary_plain(x_q, w_q, w_packed, sx, sw, boundary)
    if x_q.device.type != "cuda":
        raise ValueError(f"no split_ternary kernel for {x_q.device}")
    _build.refuse_grad("split_ternary", x_q, w_q, w_packed, sx, sw)
    if w_packed.device != x_q.device:
        raise ValueError(f"operands on {x_q.device} and {w_packed.device}")
    xq, wk, wp, swp = kernel_operands(x_q, w_q, w_packed, sw)
    sxc = sx.reshape(1).contiguous()
    n_pad = wk.shape[0]
    out = torch.empty((m, n_pad), dtype=torch.float32, device=x_q.device)
    if m:
        _build.launch("split_ternary", xq.data_ptr(), wk.data_ptr(),
                      wp.data_ptr(), sxc.data_ptr(), swp.data_ptr(),
                      out.data_ptr(), m, n_pad, wk.shape[1], kp,
                      int(boundary),
                      *decode_args(m, wk.shape[1], n_pad, x_q.device),
                      torch.cuda.current_stream(x_q.device).cuda_stream)
        split_ternary.launches += 1
    return out[:, :n] if n_pad != n else out


split_ternary.launches = 0
split_ternary.transposed_copies = 0
