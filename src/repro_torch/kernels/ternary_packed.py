"""2-bit packing of ternary weight codes, the layout the ``split_ternary``
kernel streams for its ternary columns.

``w_packed[k, n]`` holds the codes of K rows ``4k .. 4k+3`` of column n,
code c in bits ``2c .. 2c+1``, biased by +1 (00 -> -1, 01 -> 0, 10 -> +1):
bit-identical to ``repro.kernels.ternary_packed``.
"""
from __future__ import annotations

import torch


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
