"""The ODiMO regularized objective (``repro.core.losses`` counterparts;
paper Eq. 2-4):

    total = task_loss + lambda * cost_loss(alpha)

A layer's latency is the max over its parallel accelerators, smoothed with
a LogSumExp (the paper's smooth differentiable approximation of max).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.cost_models import CostModel, LayerGeometry


def smooth_max(x: torch.Tensor, beta, dim: int = -1) -> torch.Tensor:
    """LogSumExp smooth max in units of x: ``beta * log(sum(exp(x /
    beta)))``, shifted by the (detached) max; beta -> 0 is the hard max."""
    m = torch.amax(x, dim=dim, keepdim=True).detach()
    return (m + beta * torch.log(torch.sum(torch.exp((x - m) / beta),
                                           dim=dim, keepdim=True))
            ).squeeze(dim)


def expected_channels(alpha_bar: torch.Tensor) -> torch.Tensor:
    """alpha_bar (N, C_out) softmax masses -> expected C_out per domain."""
    return torch.sum(alpha_bar, dim=-1)


def _beta(lat: torch.Tensor, smooth_beta):
    """The smooth max's scale: ~2 % of the layer's mean latency, unless
    given (``jnp.maximum``'s tie gradient, as in JAX)."""
    if smooth_beta is not None:
        return smooth_beta
    return torch.maximum(torch.mean(lat) * 0.02, lat.new_full((), 1e-9))


def latency_loss(cost_model: CostModel, geoms: Sequence[LayerGeometry],
                 alpha_bars: Sequence[torch.Tensor],
                 smooth_beta: float | None = None):
    """Eq. 3: the sum over layers of the (smooth) max latency across
    domains."""
    total = 0.0
    for geom, ab in zip(geoms, alpha_bars):
        lat = cost_model.latency(geom, expected_channels(ab))
        total = total + smooth_max(lat, _beta(lat, smooth_beta))
    return total


def energy_loss(cost_model: CostModel, geoms: Sequence[LayerGeometry],
                alpha_bars: Sequence[torch.Tensor],
                smooth_beta: float | None = None):
    """Eq. 4: sum_l sum_i P_act_i * LAT_i + P_idle_i * (M_l - LAT_i)."""
    total = 0.0
    if alpha_bars:
        dev = alpha_bars[0].device
        p_act, p_idle = (cost_model.p_act().to(dev),
                         cost_model.p_idle().to(dev))
    for geom, ab in zip(geoms, alpha_bars):
        lat = cost_model.latency(geom, expected_channels(ab))
        m = smooth_max(lat, _beta(lat, smooth_beta))
        total = total + torch.sum(p_act * lat + p_idle * (m - lat))
    return total


def exact_latency(cost_model: CostModel, geoms, counts_per_domain):
    """Hard-max latency of a discretized mapping (evaluation path)."""
    total = 0.0
    for geom, counts in zip(geoms, counts_per_domain):
        total = total + torch.max(cost_model.latency(geom, counts))
    return total


def exact_energy(cost_model: CostModel, geoms, counts_per_domain):
    p_act, p_idle = cost_model.p_act(), cost_model.p_idle()
    total = 0.0
    for geom, counts in zip(geoms, counts_per_domain):
        lat = cost_model.latency(geom, counts)
        m = torch.max(lat)
        total = total + torch.sum(p_act * lat + p_idle * (m - lat))
    return total


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return torch.mean(nll)
