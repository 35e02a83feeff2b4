"""w8a8 matmul: int8 ``x_q (M, K)`` @ int8 ``w_q (K, N)`` -> exact int32,
then ``f32(acc) * sx * sw[n]``.

The CUDA kernel (``csrc/quant_matmul.cu``, sm_90a) replaces the Pallas TPU
kernel ``quant_matmul`` of ``repro/kernels/quant_matmul.py``.  What bounds
it on an H100: the int8 weight stream at decode (M = batch), int8
operations at prefill.  It tiles x and w through shared memory and
contracts 4 K values per ``__dp4a``; the epilogue applies the scales in the
plain version's order, so the two agree bit for bit.

`quant_matmul` launches the kernel for CUDA tensors and runs
`quant_matmul_plain` only for CPU tensors.  ``quant_matmul.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _pad_to(x: torch.Tensor, mult: int, dim: int) -> torch.Tensor:
    """Zero-pad ``dim`` of ``x`` up to a multiple of ``mult``."""
    pad = (-x.shape[dim]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def int_matmul_exact(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact integer product of int8 operands as float64 (|acc| <
    127 * 127 * K stays far below 2**53; a float32 product would not be
    exact once 127**2 * K > 2**24)."""
    return x_q.to(torch.float64) @ w_q.to(torch.float64)


def dequant(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor):
    """The kernels' epilogue: ``f32(acc) * sx * sw[n]``, in that order."""
    return acc.to(torch.float32) * sx * sw[None, :]


def quant_matmul_plain(x_q, w_q, sx, sw):
    """Plain PyTorch version: (M, N) float32."""
    return dequant(int_matmul_exact(x_q, w_q), sx, sw)


def check_operands(x_q, w_q, sx, sw):
    """Device, dtype, shape and contiguity checks shared by the wrappers."""
    m, k = x_q.shape
    if w_q.dim() != 2 or w_q.shape[0] != k:
        raise ValueError(f"x_q {tuple(x_q.shape)} and w_q "
                         f"{tuple(w_q.shape)} do not contract")
    if w_q.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {x_q.dtype} and "
                        f"{w_q.dtype}")
    check_epilogue(x_q, w_q, sx, sw)
    return m, k, w_q.shape[1]


def check_epilogue(x_q, w, sx, sw):
    """The int8 activations, the per-tensor and per-column steps of an
    (M, K) x weight ``w`` with N columns, all on one device."""
    n = w.shape[1]
    if x_q.dtype != torch.int8:
        raise TypeError(f"int8 activations expected, got {x_q.dtype}")
    if sx.dtype != torch.float32 or sx.numel() != 1:
        raise TypeError("sx must be a one-element float32 tensor")
    if sw.dtype != torch.float32 or tuple(sw.shape) != (n,):
        raise TypeError(f"sw must be float32 of shape ({n},)")
    dev = x_q.device
    for t in (w, sx, sw):
        if t.device != dev:
            raise ValueError(f"operands on {dev} and {t.device}")


def quant_matmul(x_q, w_q, sx, sw):
    """x_q (M, K) int8, w_q (K, N) int8, sx one-element f32, sw (N,) f32
    -> (M, N) f32.  K and N are zero-padded to multiples of 4 for the
    kernel's 4-byte loads."""
    m, k, n = check_operands(x_q, w_q, sx, sw)
    if x_q.device.type == "cpu":
        return quant_matmul_plain(x_q, w_q, sx, sw)
    if x_q.device.type != "cuda":
        raise ValueError(f"no quant_matmul kernel for {x_q.device}")
    xq = _pad_to(x_q, 4, 1).contiguous()
    wq = _pad_to(_pad_to(w_q, 4, 0), 4, 1).contiguous()
    swp = _pad_to(sw, 4, 0).contiguous()
    sxc = sx.reshape(1).contiguous()
    n4, k4 = wq.shape[1], wq.shape[0]
    out = torch.empty((m, n4), dtype=torch.float32, device=x_q.device)
    if m:
        _build.launch("quant_matmul", xq.data_ptr(), wq.data_ptr(),
                      sxc.data_ptr(), swp.data_ptr(), out.data_ptr(),
                      m, n4, k4, torch.cuda.current_stream(
                          x_q.device).cuda_stream)
        quant_matmul.launches += 1
    return out[:, :n] if n4 != n else out


quant_matmul.launches = 0
