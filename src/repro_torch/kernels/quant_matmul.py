"""w8a8 matmul: int8 ``x_q (M, K)`` @ int8 ``w_q (K, N)`` -> exact int32,
then ``f32(acc) * sx * sw[n]``.

The CUDA kernel (``csrc/quant_matmul.cu``, sm_90a) replaces the Pallas TPU
kernel ``quant_matmul`` of ``repro/kernels/quant_matmul.py``.  What bounds
it on an H100: the int8 weight stream at decode (M = batch), int8
operations at prefill.  It reads the weight K-major, as the (N, K) tensor
behind a transposed ``w_q`` view (the layout `runtime.execute.prepare_layer`
gives the quant_matmul layers): at M <= 16 a ``__dp4a`` GEMM with 16-byte
weight loads, above that int8 ``wgmma`` tiles fed by a TMA ring.  The
epilogue applies the scales in the plain version's order, so the two agree
bit for bit.

`quant_matmul` launches the kernel for CUDA tensors and runs
`quant_matmul_plain` only for CPU tensors.  ``quant_matmul.launches``
counts kernel launches, ``quant_matmul.transposed_copies`` the calls that
had to copy ``w_q`` into the kernel's layout: a row-major weight
transposed, or a K-major one whose K or address is off the alignment
padded (`weight_route`).
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


#: the kernel takes K in multiples of this: a TMA row stride is a multiple
#: of 16 bytes
K_ALIGN = 16


def weight_route(shape, strides, aligned=True, n_align=1) -> str:
    """How a ``(K, N)`` int8 weight of these strides reaches a kernel that
    reads it K-major as ``(N, K)`` with K a multiple of `K_ALIGN` and N one
    of ``n_align``: ``"k_major"``, the transposed view of a contiguous
    ``(N, K)`` tensor at a 16-byte-aligned address (``aligned``), passed
    with no copy; ``"pad"``, K-major but with K or N off its multiple or
    the address off the alignment, copied zero-padded; ``"transpose"``, any
    other layout (row-major), copied into the K-major layout.  Either copy
    is made once per call."""
    k, n = shape
    k_major = (strides[0] == 1 or k == 1) and (strides[1] == k or n == 1)
    if not k_major:
        return "transpose"
    return ("k_major" if k % K_ALIGN == 0 and n % n_align == 0 and aligned
            else "pad")


def k_major_weight(w_q: torch.Tensor, owner, n_align: int = 1):
    """The ``(N_pad, K_pad)`` contiguous int8 weight a kernel reads, K
    zero-padded to `K_ALIGN` and N to ``n_align``: ``w_q.t()`` itself on
    the ``"k_major"`` route, else a copy, counted in
    ``owner.transposed_copies``."""
    route = weight_route(tuple(w_q.shape), w_q.stride(),
                         w_q.data_ptr() % 16 == 0, n_align)
    if route == "k_major":
        return w_q.t()
    owner.transposed_copies += 1
    return _aligned(_pad_to(_pad_to(w_q.t(), K_ALIGN, 1), n_align, 0), 16)


def _k_major(w_q: torch.Tensor) -> torch.Tensor:
    """`k_major_weight` of quant_matmul (any N)."""
    return k_major_weight(w_q, quant_matmul)


def _aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """``t`` contiguous at an address aligned to ``nbytes``."""
    t = t.contiguous()
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def quant_matmul(x_q, w_q, sx, sw):
    """x_q (M, K) int8, w_q (K, N) int8 (any strides; the transposed view of
    a contiguous (N, K) tensor goes to the kernel without a copy), sx
    one-element f32, sw (N,) f32 -> (M, N) f32.  K is zero-padded to a
    multiple of `K_ALIGN` for the kernel."""
    m, k, n = check_operands(x_q, w_q, sx, sw)
    if x_q.device.type == "cpu":
        return quant_matmul_plain(x_q, w_q, sx, sw)
    if x_q.device.type != "cuda":
        raise ValueError(f"no quant_matmul kernel for {x_q.device}")
    wk = _k_major(w_q)
    xq = _aligned(_pad_to(x_q, K_ALIGN, 1), 16)
    swc = _aligned(sw, 8)
    sxc = sx.reshape(1).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    if m and n:
        _build.launch("quant_matmul", xq.data_ptr(), wk.data_ptr(),
                      sxc.data_ptr(), swc.data_ptr(), out.data_ptr(),
                      m, n, wk.shape[1], torch.cuda.current_stream(
                          x_q.device).cuda_stream)
        quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
quant_matmul.transposed_copies = 0
