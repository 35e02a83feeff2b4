"""w8a8 matmul: int8 ``x_q (M, K)`` @ int8 ``w_q (K, N)`` -> exact int32,
then ``f32(acc) * sx * sw[n]``.

The CUDA kernel (``csrc/quant_matmul.cu``, sm_90a) replaces the Pallas TPU
kernel ``quant_matmul`` of ``repro/kernels/quant_matmul.py``.  What bounds
it on an H100: the int8 weight stream at decode (M = batch), int8
operations at prefill.  It reads the weight K-major, as the (N, K) tensor
behind a transposed ``w_q`` view (the layout `runtime.execute.prepare_layer`
gives the quant_matmul layers): at M <= 16 the decode GEMM of
``csrc/int8_gemv.cuh`` (each column tile's K slices spread over the blocks
of a cluster, ``mma.sync`` int8 products, the partial sums reduced through
distributed shared memory; `decode_plan` picks the tile and the split),
above that int8 ``wgmma`` tiles fed by a TMA ring.  The epilogue applies
the scales in the plain version's order, so the two agree bit for bit.

`quant_matmul` launches the kernel for CUDA tensors and runs
`quant_matmul_plain` only for CPU tensors.  ``quant_matmul.launches``
counts kernel launches, ``quant_matmul.transposed_copies`` the calls that
had to copy ``w_q`` into the kernel's layout: a row-major weight
transposed, or a K-major one whose K or address is off the alignment
padded (`weight_route`).
"""
from __future__ import annotations

import functools

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


#: the decode GEMM (``csrc/int8_gemv.cuh``): its column tiles, its K
#: splits (the cluster sizes), the K bytes of a chunk and the most chunks
#: of K one block stages, and its warps per block
DECODE_BN = (128, 64, 32, 16)
DECODE_SPLITS = (1, 2, 4, 8)
DECODE_CHUNK = 64
DECODE_SPAN = 32
DECODE_WARPS = 8
#: the decode GEMM takes M up to this
DECODE_M = 16


def decode_plan(m: int, k: int, n: int, sms: int):
    """``(bn, split)`` of the decode GEMM at M = ``m`` (1 .. 16): a grid of
    ``ceil(n / bn)`` column tiles x ``split`` K slices (one cluster per
    column tile) on a card of ``sms`` SMs.  The widest tile, then the
    fewest splits, whose grid holds at least two blocks per SM; where none
    does, the largest grid.  ``split`` is at least ``ceil(chunks /
    DECODE_SPAN)``, so that a block's slice of x fits its shared memory."""
    if not 1 <= m <= DECODE_M:
        raise ValueError(f"the decode GEMM takes M 1 .. {DECODE_M}, not {m}")
    chunks = -(-k // DECODE_CHUNK)
    least = -(-chunks // DECODE_SPAN)
    best = None
    for bn in DECODE_BN:
        for split in DECODE_SPLITS:
            if split < least:
                continue
            blocks = -(-n // bn) * split
            if blocks >= 2 * sms:
                return bn, split
            if best is None or blocks > best[0]:
                best = (blocks, bn, split)
    if best is None:
        raise ValueError(f"K {k} needs more than {DECODE_SPLITS[-1]} "
                         f"splits of {DECODE_SPAN * DECODE_CHUNK} bytes")
    return best[1], best[2]


def decode_k_slices(k: int, bn: int, split: int):
    """The K-byte ranges the decode GEMM's blocks and warps read, as the
    kernel computes them: ``{(rank, part): (lo, hi)}`` for each cluster
    rank and each of its ``DECODE_WARPS // (bn // 16)`` warps of one
    16-column group, chunks split evenly, clipped to ``k``."""
    chunks = -(-k // DECODE_CHUNK)
    wpg = DECODE_WARPS // (bn // 16)
    parts = split * wpg
    out = {}
    for rank in range(split):
        for wk in range(wpg):
            p = rank * wpg + wk
            lo, hi = p * chunks // parts, (p + 1) * chunks // parts
            out[(rank, wk)] = (min(lo * DECODE_CHUNK, k),
                               min(hi * DECODE_CHUNK, k))
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SMs of the card of ``device`` (the current card if it names
    none)."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def decode_args(m: int, k: int, n: int, device: torch.device):
    """The plan arguments of a launch: `decode_plan` on the card of
    ``device`` at M <= 16, (0, 0) above (the prefill GEMMs take none)."""
    if m > DECODE_M:
        return 0, 0
    return decode_plan(m, k, n, sm_count(device))


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
                      m, n, wk.shape[1],
                      *decode_args(m, wk.shape[1], n, x_q.device),
                      torch.cuda.current_stream(x_q.device).cuda_stream)
        quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
quant_matmul.transposed_copies = 0
