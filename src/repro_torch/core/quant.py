"""Deployment-side quantization primitives (``repro.core.quant``
counterparts): symmetric signed integer codes with a log-scale, and the
DIANA precision domains."""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


def qlevels(n_bits: int) -> int:
    """Number of positive levels of a symmetric signed n-bit format."""
    return 2 ** (n_bits - 1) - 1


def quantize_int(x: torch.Tensor, log_scale, n_bits: int) -> torch.Tensor:
    """True integer quantization: int8 codes of ``x`` at ``exp(log_scale)``."""
    levels = qlevels(n_bits)
    scale = torch.exp(torch.as_tensor(log_scale, dtype=torch.float32,
                                      device=x.device))
    xn = torch.clamp(x / scale, -1.0, 1.0)
    return torch.round(xn * levels).to(torch.int8)


def init_log_scale(w: torch.Tensor) -> torch.Tensor:
    """log(max|w|) in float32 (floored at 1e-8), a 0-d tensor."""
    m = torch.max(torch.abs(w.to(torch.float32)))
    return torch.log(torch.clamp(m, min=1e-8))


@dataclasses.dataclass(frozen=True)
class PrecisionDomain:
    """One accelerator in ODiMO's view: a precision + a cost identity."""
    name: str
    weight_bits: int          # 2 => ternary, 8 => int8, >=16 => identity
    act_bits: int = 8


# The DIANA SoC of the paper (Sec. II-A / III-B).
DIANA_DIGITAL = PrecisionDomain("digital", weight_bits=8, act_bits=8)
DIANA_AIMC = PrecisionDomain("aimc", weight_bits=2, act_bits=7)
DIANA_DOMAINS: Sequence[PrecisionDomain] = (DIANA_DIGITAL, DIANA_AIMC)
