"""int8 gradient compression with error feedback (``repro.optim.compression``
counterpart): each gradient leaf plus its carried residual becomes int8
codes and one float32 scale, 4x fewer bytes than float32 for the
all-reduce of a data-parallel step; the quantisation error is carried to
the next step (error feedback: Seide et al.; Karimireddy et al. 2019), so
compressed SGD converges like the uncompressed one.

    comp, residual = compress_with_feedback(grads, residual)
    grads = decompress(comp)        # after the all-reduce

The arithmetic is the JAX package's, step for step: ``g32 = g + r``,
``scale = max(max|g32|, 1e-12) / 127``, codes ``round(g32 / scale)``
(half to even, as ``jnp.round``) clipped to +-127, the new residual
``g32 - codes * scale``.  Plain tensor code: the JAX package has no
kernel for it either.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import tree as T


class Q8(NamedTuple):
    """A compressed leaf: int8 codes and a float32 0-d scale (a leaf of
    the compressed tree, not a node)."""
    codes: torch.Tensor
    scale: torch.Tensor


def _is_q8(x) -> bool:
    return isinstance(x, Q8)


def _quant_leaf(g, r):
    g = g.to(torch.float32) + r
    scale = torch.clamp_min(torch.max(torch.abs(g)), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    err = g - q.to(torch.float32) * scale
    return Q8(q, scale), err


def init_residual(params):
    """float32 zeros of each leaf's shape."""
    return T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)


def compress_with_feedback(grads, residual):
    """-> (the tree of `Q8` leaves, the new residual tree)."""
    out = [_quant_leaf(g, r) for g, r in zip(T.leaves(grads),
                                               T.leaves(residual))]
    return (T.unflatten(grads, [q for q, _ in out]),
            T.unflatten(grads, [e for _, e in out]))


def decompress(compressed):
    """float32 ``codes * scale`` per leaf."""
    return T.tree_map(lambda q: q.codes.to(torch.float32) * q.scale,
                      compressed, is_leaf=_is_q8)


def compressed_bytes(compressed) -> int:
    """Bytes on the wire: one per code, four per scale."""
    return sum(q.codes.numel() + 4
               for q in T.leaves(compressed, is_leaf=_is_q8))
