"""ODiMO channel-wise DNAS mixing (``repro.core.odimo`` counterparts;
paper Sec. III-A, Eq. 1).

For a weight tensor W with output channels on the LAST axis, each layer
keeps one trainable vector alpha_i in R^{C_out} per precision domain and
one trainable fake-quant log-scale per domain.  The effective weight is
the per-channel softmax(alpha / tau)-weighted sum of the N fake-quantized
copies.  State lives in plain dicts of tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import quant
from repro_torch.core.quant import PrecisionDomain


@dataclasses.dataclass(frozen=True)
class ODiMOSpec:
    """Search configuration shared by every ODiMO-managed layer."""
    domains: Sequence[PrecisionDomain] = quant.DIANA_DOMAINS
    init_tau: float = 1.0
    final_tau: float = 0.05
    act_bits: int = 7          # worst case of the domains (Sec. III-B)

    @property
    def n_domains(self) -> int:
        return len(self.domains)


def init_layer_state(gen: torch.Generator, w: torch.Tensor,
                     spec: ODiMOSpec) -> dict:
    """Per-layer ODiMO state on ``w``'s device: ``alpha`` (N, C_out), small
    normal noise drawn from ``gen`` so channels can break ties, and
    ``log_scales`` (N,), each log(max|w|)."""
    n, c_out = spec.n_domains, int(w.shape[-1])
    alpha = 0.01 * torch.randn((n, c_out), generator=gen, device=w.device,
                               dtype=torch.float32)
    log_scales = torch.stack([quant.init_log_scale(w) for _ in range(n)])
    return {"alpha": alpha, "log_scales": log_scales}


def alpha_bar(alpha: torch.Tensor, tau) -> torch.Tensor:
    """(N, C_out) softmax over the domain axis at temperature tau."""
    return torch.softmax(alpha / tau, dim=0)


def effective_weight(w: torch.Tensor, state: dict, spec: ODiMOSpec,
                     tau) -> torch.Tensor:
    """Eq. 1: hat(W)_c = sum_i abar_{c,i} * fake_quant_i(W_c)."""
    ab = alpha_bar(state["alpha"], tau)
    out = torch.zeros_like(w)
    for i, dom in enumerate(spec.domains):
        wq = quant.fake_quant(w, state["log_scales"][i], dom.weight_bits)
        out = out + ab[i] * wq  # broadcast over the last (C_out) axis
    return out


def discretized_weight(w: torch.Tensor, state: dict,
                       spec: ODiMOSpec) -> torch.Tensor:
    """Post-search weight: each channel quantized by its argmax domain."""
    assign = torch.argmax(state["alpha"], dim=0)
    out = torch.zeros_like(w)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    for i, dom in enumerate(spec.domains):
        wq = quant.fake_quant(w, state["log_scales"][i], dom.weight_bits)
        out = out + torch.where(assign == i, wq, zero)
    return out


def assignment(state: dict) -> torch.Tensor:
    """(C_out,) argmax domain index per output channel."""
    return torch.argmax(state["alpha"], dim=0)


def domain_counts(state: dict, n_domains: int) -> torch.Tensor:
    """Discrete channel count per domain after argmax."""
    a = assignment(state)
    return torch.stack([torch.sum(a == i) for i in range(n_domains)])


def expected_counts(state: dict, tau) -> torch.Tensor:
    """Continuous (search-time) channel mass per domain: sum_c abar."""
    return torch.sum(alpha_bar(state["alpha"], tau), dim=-1)


def tau_schedule(step, total_steps: int, spec: ODiMOSpec) -> torch.Tensor:
    """Exponential temperature annealing init_tau -> final_tau, a float32
    0-d tensor (JAX's float32 arithmetic)."""
    f32 = torch.float32
    frac = torch.clamp(torch.tensor(step, dtype=f32) / max(total_steps, 1),
                       0.0, 1.0)
    log_t = (1 - frac) * torch.log(torch.tensor(spec.init_tau, dtype=f32)) \
        + frac * torch.log(torch.tensor(spec.final_tau, dtype=f32))
    return torch.exp(log_t)
