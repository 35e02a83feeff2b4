"""Fake-quantization primitives (``repro.core.quant`` counterparts; paper
Eq. 5, FQ-Conv / PACT style):

    Q(x) = (e^s / (2^{n-1}-1)) * round((2^{n-1}-1) * clip(x / e^s, -1, 1))

with a trainable log-scale ``s`` and straight-through-estimator (STE)
gradients through ``round``.  ``n = 2`` is ternarization {-1, 0, +1}
(DIANA's AIMC weights), ``n = 8`` the digital accelerator's format.

The clips are ``torch.minimum(torch.maximum(x, lo), hi)`` with tensor
bounds: at a bound they pass half the gradient, as JAX's ``jnp.clip``
does, where ``torch.clamp`` passes all of it.  The bound is reached at
initialisation: `init_log_scale` puts each layer's largest weight exactly
at 1 after ``x / exp(log_scale)``.

The output-channel axis is the LAST axis of a weight tensor (dense
``(in, out)``, conv HWIO ``(kh, kw, in, out)``).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


def _ste_round(x: torch.Tensor) -> torch.Tensor:
    """round(x) forward, identity gradient backward."""
    return x + (torch.round(x) - x).detach()


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: half the gradient at a bound (see the module doc).
    The bounds are filled on ``x``'s device (no host-to-device copy)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def qlevels(n_bits: int) -> int:
    """Number of positive levels of a symmetric signed n-bit format."""
    return 2 ** (n_bits - 1) - 1


def fake_quant(x: torch.Tensor, log_scale: torch.Tensor,
               n_bits: int) -> torch.Tensor:
    """Symmetric signed fake-quantization with a trainable scale (Eq. 5).
    ``log_scale`` is a scalar (per tensor) or broadcasts to the last axis
    of ``x`` (per channel); >= 16 bits is the identity domain."""
    if n_bits >= 16:
        return x
    levels = qlevels(n_bits)
    scale = torch.exp(log_scale)
    xn = _clip(x / scale, -1.0, 1.0)
    q = _ste_round(xn * levels) / levels
    return q * scale


def quantize_int(x: torch.Tensor, log_scale, n_bits: int) -> torch.Tensor:
    """True integer quantization: int8 codes of ``x`` at ``exp(log_scale)``."""
    levels = qlevels(n_bits)
    scale = torch.exp(torch.as_tensor(log_scale, dtype=torch.float32,
                                      device=x.device))
    xn = torch.clamp(x / scale, -1.0, 1.0)
    return torch.round(xn * levels).to(torch.int8)


def dequantize_int(q: torch.Tensor, log_scale, n_bits: int) -> torch.Tensor:
    levels = qlevels(n_bits)
    scale = torch.exp(torch.as_tensor(log_scale, dtype=torch.float32,
                                      device=q.device))
    return q.to(torch.float32) * (scale / levels)


def fake_quant_act(x: torch.Tensor, log_scale: torch.Tensor,
                   n_bits: int) -> torch.Tensor:
    """Unsigned activation fake-quantization (post-ReLU ranges), clip to
    [0, 1] of ``exp(log_scale)``."""
    if n_bits >= 16:
        return x
    levels = 2 ** n_bits - 1
    scale = torch.exp(log_scale)
    xn = _clip(x / scale, 0.0, 1.0)
    q = _ste_round(xn * levels) / levels
    return q * scale


def truncate_lsb(x_codes: torch.Tensor) -> torch.Tensor:
    """Drop the least-significant bit of 8-bit activation codes (the AIMC's
    7-bit D/A converters)."""
    return (x_codes.to(torch.int32) >> 1) << 1


def init_log_scale(w: torch.Tensor, per_channel: bool = False) -> torch.Tensor:
    """log(max|w|) in float32, floored at 1e-8: a 0-d tensor, or one value
    per output channel (last axis) with ``per_channel``."""
    a = torch.abs(w.to(torch.float32))
    if per_channel:
        m = torch.amax(a, dim=tuple(range(w.dim() - 1)))
    else:
        m = torch.max(a)
    return torch.log(torch.clamp(m, min=1e-8))


@dataclasses.dataclass(frozen=True)
class PrecisionDomain:
    """One accelerator in ODiMO's view: a precision + a cost identity."""
    name: str
    weight_bits: int          # 2 => ternary, 8 => int8, >=16 => identity
    act_bits: int = 8

    @property
    def is_identity(self) -> bool:
        return self.weight_bits >= 16


# The DIANA SoC of the paper (Sec. II-A / III-B).
DIANA_DIGITAL = PrecisionDomain("digital", weight_bits=8, act_bits=8)
DIANA_AIMC = PrecisionDomain("aimc", weight_bits=2, act_bits=7)
DIANA_DOMAINS: Sequence[PrecisionDomain] = (DIANA_DIGITAL, DIANA_AIMC)

# The modelled TPU's precision domains (int8 MXU path at 2x bf16 peak; bf16
# identity), kept for the ``tpu_v5e`` platform.
TPU_INT8 = PrecisionDomain("int8", weight_bits=8, act_bits=8)
TPU_INT4 = PrecisionDomain("int4", weight_bits=4, act_bits=8)
TPU_BF16 = PrecisionDomain("bf16", weight_bits=16, act_bits=16)
TPU_DOMAINS: Sequence[PrecisionDomain] = (TPU_INT8, TPU_BF16)
