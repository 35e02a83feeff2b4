"""Fused int8 + bf16 two-domain matmul (the paper's Fig. 3 layer on a GPU
tensor-core pair): output columns below ``boundary`` are ``f32(x_q @ w_q)
* sx * sw[n]`` (exact int32 accumulation), columns at or above it ``x_bf16
@ w_bf16`` with float32 accumulation; one float32 output.

The CUDA kernel (``csrc/split_precision.cu``, sm_90a) replaces the Pallas
TPU kernel ``split_precision_matmul`` of ``repro/kernels/
split_precision.py``.  What bounds it on an H100: the weight stream at
decode (int8 codes below the boundary, bf16 above), operations at prefill.
It reads ``w_q`` K-major, as the (N, K) tensor behind a transposed view
(the layout `runtime.execute.prepare_layer` gives the split_precision
layers), and ``w_bf16`` row-major as held.  At M <= 16 the decode GEMM of
``csrc/int8_gemv.cuh`` runs ``mma.sync`` int8 products on the int8 columns
and fmaf on the bf16 ones; above that one ``wgmma`` GEMM
(``csrc/int8_wgmma.cuh``) runs int8 tensor-core tiles below the boundary
and bf16 tensor-core tiles (f32 accumulators) at or above it, both in the
tile the boundary falls in.  The choice is made per column, ``w_q`` is read
only below the boundary and ``w_bf16`` only at or above it (per column
tile on the wgmma path).

The int8 columns are bit-identical to `split_precision_plain`.  The bf16
columns sum K products in another order than the plain version (which
contracts in float64 and rounds once): at decode each lane sums its K rows
in order, then lanes, warps and cluster blocks are summed in a fixed order;
on the wgmma path the tensor cores sum each 16-wide K step in an order of
their own.  Either way they agree within the float32 summation bound ``K *
2**-24 * sum_k |x * w| + 2**-24 * |y|`` (`bf16_error_bound`).

`split_precision` launches the kernel for CUDA tensors and runs
`split_precision_plain` only for CPU tensors.  ``split_precision.launches``
counts kernel launches, ``split_precision.transposed_copies`` the calls
that copied a weight into the kernel's layout: ``w_q`` not K-major or off
the alignment (`weight_route`), or ``w_bf16`` not contiguous or with K or N
off it (each copied weight counts one).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import quant_matmul as _qm
from repro_torch.kernels.quant_matmul import (DECODE_M, K_ALIGN, _aligned,
                                              _pad_to, check_operands,
                                              decode_args, k_major_weight,
                                              quant_matmul_plain, sm_count)
from repro_torch.kernels.ternary_packed import n_align


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


#: the K splits (cluster sizes) of the wgmma GEMM (M > 16) of
#: split_precision and ternary_matmul, split_precision's K values per stage
#: (`PrecisionCodes`) and the fewest stages a split keeps.  The kernel takes
#: up to 8, but at the served M 512 x N 512 a split of 8 ran slower than 4
#: for both (chip_smoke.py's split sweep): 16 clusters of 8 blocks of over
#: 128 KB of shared memory do not fit the card at once
WGMMA_SPLITS = (1, 2, 4)
WGMMA_STAGE_K = 64
WGMMA_MIN_STAGES = 4


def wgmma_split(m: int, k: int, n: int, sms: int,
                stage_k: int = WGMMA_STAGE_K) -> int:
    """The K split of the wgmma GEMM (``csrc/int8_wgmma.cuh``) at (M, K, N)
    on ``sms`` SMs, for a source of ``stage_k`` K values per stage
    (split_precision's by default): the fewest of `WGMMA_SPLITS` whose grid
    (128 x 128 tiles x split) holds a block per SM, else the most, without
    leaving a split fewer than `WGMMA_MIN_STAGES` stages.  (A source of
    128- or 256-column tiles runs 128 wherever the tiles leave SMs idle:
    `pick_bn` takes 256 only past one wave of 128-column tiles.)"""
    tiles = -(-m // 128) * -(-n // 128)
    stages = -(-k // stage_k)
    best = 1
    for split in WGMMA_SPLITS:
        if stages < WGMMA_MIN_STAGES * split:
            break
        best = split
        if tiles * split >= sms:
            break
    return best


def wgmma_k_slices(k: int, split: int, stage_k: int):
    """The K ranges the ``split`` ranks of a cluster of the wgmma GEMM sum,
    as the kernel computes them: rank r takes stages ``[r * S // split,
    (r + 1) * S // split)`` of the ``S = ceil(k / stage_k)``, clipped to
    ``k``."""
    stages = -(-k // stage_k)
    return [(min(r * stages // split * stage_k, k),
             min((r + 1) * stages // split * stage_k, k))
            for r in range(split)]


def launch_args(m: int, k: int, n: int, device: torch.device):
    """The plan arguments of a launch: the decode GEMM's ``(bn, split)`` at
    M <= 16, ``(0, wgmma_split)`` above."""
    if m <= DECODE_M:
        return decode_args(m, k, n, device)
    return 0, wgmma_split(m, k, n, sm_count(device))


def weight_route(shape, strides, m, aligned=True) -> str:
    """How `split_precision` hands a ``(K, N)`` ``w_q`` of these strides to
    the kernel at M = ``m`` (``"k_major"``, ``"pad"`` or ``"transpose"``,
    as `quant_matmul.weight_route`), N aligned to `n_align` (m)."""
    return _qm.weight_route(shape, strides, aligned, n_align(m))


def bf16_weight(w_bf16, align: int):
    """(``w_bf16`` as the kernel reads it: contiguous (K, N) row-major,
    16-byte aligned, K zero-padded to `K_ALIGN` and N to ``align``; whether
    that took a copy)."""
    k, n = w_bf16.shape
    if w_bf16.is_contiguous() and k % K_ALIGN == 0 and n % align == 0 and \
            w_bf16.data_ptr() % 16 == 0:
        return w_bf16, False
    return _aligned(_pad_to(_pad_to(w_bf16, K_ALIGN, 0), align, 1), 16), True


def kernel_operands(x, x_q, w_bf16, w_q, sw):
    """The operands the kernel takes, on any device: x and x_q with K padded
    to `K_ALIGN`, ``w_bf16`` (K_pad, N_pad) row-major, ``w_q`` as the
    K-major ``(N_pad, K_pad)`` codes and ``sw`` with N padded to `n_align`
    (M) (zeros); each copied weight is counted in
    ``split_precision.transposed_copies``."""
    na = n_align(x_q.shape[0])
    wk = k_major_weight(w_q, split_precision, na)
    wb, copied = bf16_weight(w_bf16, na)
    split_precision.transposed_copies += copied
    return (_aligned(_pad_to(x, K_ALIGN, 1), 16),
            _aligned(_pad_to(x_q, K_ALIGN, 1), 16), wb, wk,
            _aligned(_pad_to(sw, na, 0), 16))


def split_precision(x, x_q, sx, w_bf16, w_q, sw, boundary: int):
    """x (M, K) bf16, x_q (M, K) int8, sx one-element f32, w_bf16 (K, N)
    bf16, w_q (K, N) int8 (any strides; the transposed view of a
    contiguous (N, K) tensor goes to the kernel without a copy), sw (N,)
    f32; boundary: first bf16-domain column -> (M, N) f32.  K is
    zero-padded to `K_ALIGN` and N to `n_align` (M) for the kernel."""
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
    xb, xq, wb, wk, swp = kernel_operands(x, x_q, w_bf16, w_q, sw)
    sxc = sx.reshape(1).contiguous()
    n_pad, k_pad = wk.shape
    out = torch.empty((m, n_pad), dtype=torch.float32, device=x_q.device)
    if m and n_pad:
        _build.launch("split_precision", xb.data_ptr(), xq.data_ptr(),
                      wb.data_ptr(), wk.data_ptr(), sxc.data_ptr(),
                      swp.data_ptr(), out.data_ptr(), m, n_pad, k_pad,
                      int(boundary), *launch_args(m, k_pad, n_pad, x_q.device),
                      torch.cuda.current_stream(x_q.device).cuda_stream)
        split_precision.launches += 1
    return out[:, :n] if n_pad != n else out


split_precision.launches = 0
split_precision.transposed_copies = 0
