"""Differentiable hardware cost models (``repro.core.cost_models``
counterparts; paper Sec. III-C, Fig. 5, and the modelled TPU).

Every model maps a layer geometry and the number of output channels
assigned to each precision domain, ``c_out_i``, to a latency per domain.
``c_out_i`` is continuous during the DNAS search (a sum of softmax masses,
differentiable) and integer after discretization, so one code path serves
both.  Ceil is a straight-through estimator (`ste_ceil`): the exact value
forward, identity gradient backward.

``c_out_per_domain`` is a float32 tensor (or array) with the domain axis
first: shape ``(N,)``, or ``(N, K)`` to price K splits in one call (the
static `repro_torch.core.baselines.min_cost` search); each latency has
its shape.
The arithmetic follows the JAX models' order, in float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.quant import PrecisionDomain

_F = torch.float32


def ste_ceil(x: torch.Tensor) -> torch.Tensor:
    """ceil(x) forward, identity gradient backward (cost models only)."""
    return x + (torch.ceil(x) - x).detach()


def _const_ceil(v: float) -> float:
    """ceil of a geometry constant in float32, as JAX's ``ste_ceil`` of a
    Python float computes it (the float is cast first)."""
    return float(math.ceil(np.float32(v)))


def _counts(c_out_per_domain) -> torch.Tensor:
    """The counts as a float32 tensor (numpy or lists are taken too)."""
    return torch.as_tensor(c_out_per_domain, dtype=_F)


def _per_domain(v: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """A per-domain (N,) tensor shaped to broadcast against ``c``."""
    return v.to(c.device).reshape((-1,) + (1,) * (c.dim() - 1))


@dataclasses.dataclass(frozen=True)
class LayerGeometry:
    """Geometry of a Conv/FC layer as used by the latency models; dense
    layers are the ``fx = fy = ox = oy = 1`` special case."""
    c_in: int
    c_out: int
    fx: int = 1
    fy: int = 1
    ox: int = 1
    oy: int = 1
    groups: int = 1  # depthwise convs: groups == c_in (pinned, not searched)

    @property
    def macs_per_out_channel(self) -> int:
        return (self.c_in // self.groups) * self.fx * self.fy * self.ox * \
            self.oy

    def macs(self, c_out: float) -> float:
        return self.macs_per_out_channel * c_out


class CostModel:
    """Interface: latency per domain + active/idle powers per domain."""

    domains: Sequence[PrecisionDomain]

    def latency(self, geom: LayerGeometry,
                c_out_per_domain: torch.Tensor) -> torch.Tensor:
        """-> float32 latencies, one per domain (0 channels -> 0)."""
        raise NotImplementedError

    def p_act(self) -> torch.Tensor:
        raise NotImplementedError

    def p_idle(self) -> torch.Tensor:
        raise NotImplementedError


class DianaCostModel(CostModel):
    """The paper's analytical DIANA models (Sec. III-C).  Domain order is
    (digital, aimc); latencies in cycles at 260 MHz.  Powers (mW) are
    representative of the ISSCC'22 DIANA numbers."""

    AIMC_ROWS = 1152     # c_in * fx * fy folded onto array rows
    AIMC_COLS = 512      # output channels per array program
    AIMC_DMA_FACTOR = 2 * 4
    DIG_PE_COUT = 16
    DIG_PE_OY = 16
    FREQ_HZ = 260e6

    def __init__(self, p_act_mw=(28.0, 12.0), p_idle_mw=(4.0, 2.0)):
        from repro_torch.core.quant import DIANA_DOMAINS
        self.domains = DIANA_DOMAINS
        self._p_act = torch.tensor(p_act_mw, dtype=_F)
        self._p_idle = torch.tensor(p_idle_mw, dtype=_F)

    def lat_aimc(self, geom: LayerGeometry, c_out: torch.Tensor):
        n_col_programs = ste_ceil(c_out / self.AIMC_COLS)
        rows = _const_ceil(geom.c_in * geom.fx * geom.fy / self.AIMC_ROWS)
        compute = rows * n_col_programs * geom.ox * geom.oy
        dma = self.AIMC_DMA_FACTOR * geom.c_in * n_col_programs
        return compute + dma

    def lat_digital(self, geom: LayerGeometry, c_out: torch.Tensor):
        oy = _const_ceil(geom.oy / self.DIG_PE_OY)
        compute = (ste_ceil(c_out / self.DIG_PE_COUT) * oy
                   * geom.c_in * geom.ox * geom.fx * geom.fy)
        wload = geom.c_in * c_out * geom.fx * geom.fy
        return compute + wload

    def latency(self, geom: LayerGeometry,
                c_out_per_domain: torch.Tensor) -> torch.Tensor:
        c = _counts(c_out_per_domain)
        lat = torch.stack([self.lat_digital(geom, c[0]),
                           self.lat_aimc(geom, c[1])])
        # a domain with (continuously) zero channels contributes zero
        active = (c > 1e-6).to(lat.dtype)
        return lat * active

    def p_act(self) -> torch.Tensor:
        return self._p_act

    def p_idle(self) -> torch.Tensor:
        return self._p_idle

    def cycles_to_ms(self, cycles) -> torch.Tensor:
        return torch.as_tensor(cycles, dtype=_F) / self.FREQ_HZ * 1e3

    def energy_uj(self, lat_cycles, layer_max) -> torch.Tensor:
        """Eq. 4 for one layer, cycles + mW -> uJ."""
        t = _counts(lat_cycles) / self.FREQ_HZ
        tm = _counts(layer_max).to(t.device) / self.FREQ_HZ
        return torch.sum(self._p_act.to(t.device) * t +
                         self._p_idle.to(t.device) * (tm - t)) * 1e3


class AbstractCostModel(CostModel):
    """Fig. 5 models: latency proportional to OPs, ``macs * c_out /
    throughput`` per domain.  ``ideal_shutdown=False`` -> P_idle = P_act,
    ``True`` -> P_idle = 0.  ``domains`` (default: DIANA's two), ``p_act``
    and ``throughput`` (MACs per time unit, default 1) describe any domain
    tuple, e.g. the 3-domain ``gap9_like`` or the ``gpu_tc_like`` pair."""

    def __init__(self, ideal_shutdown: bool, p_act=(10.0, 1.0),
                 domains=None, throughput=None):
        from repro_torch.core.quant import DIANA_DOMAINS
        self.domains = tuple(domains) if domains is not None \
            else tuple(DIANA_DOMAINS)
        n = len(self.domains)
        self.ideal_shutdown = ideal_shutdown
        self._p_act = torch.tensor(p_act, dtype=_F)
        self._thr = (torch.tensor(throughput, dtype=_F)
                     if throughput is not None else torch.ones(n, dtype=_F))
        if self._p_act.shape[0] != n or self._thr.shape[0] != n:
            raise ValueError(f"p_act/throughput must match {n} domains")
        self._p_idle = torch.zeros(n, dtype=_F) if ideal_shutdown \
            else self._p_act

    def latency(self, geom: LayerGeometry,
                c_out_per_domain: torch.Tensor) -> torch.Tensor:
        c = _counts(c_out_per_domain)
        return geom.macs_per_out_channel * c / _per_domain(self._thr, c)

    def p_act(self) -> torch.Tensor:
        return self._p_act

    def p_idle(self) -> torch.Tensor:
        return self._p_idle


class TPUCostModel(CostModel):
    """The roofline cost model of the ``tpu_v5e`` platform.

    Each precision domain i owns ``chips_i`` chips of a tensor-parallel
    group and computes its channel slice as
    ``LAT_i = max(FLOPs_i / (chips_i * peak_i), bytes_i / (chips_i *
    hbm_bw))``, int8 at 2x the bf16 peak, weight bytes scaling with the
    bit-width; energy from per-FLOP energies and a per-chip idle draw.

    The constants (197 TFLOP/s bf16, 394 TOP/s int8, 819 GB/s) DEFINE the
    modelled platform, as in the JAX package, so that a search on
    ``tpu_v5e`` gives the same mapping in both packages.  They are not
    measurements of the device this package runs on.
    """

    HBM_BW = 819e9
    PEAK_BF16 = 197e12
    E_PER_FLOP_BF16 = 0.6e-12   # J, representative
    E_PER_BYTE = 12e-12         # J, HBM access
    P_IDLE_W = 60.0             # per-chip idle draw

    def __init__(self, domains: Sequence[PrecisionDomain] | None = None,
                 chips_per_domain: Sequence[int] = (1, 1)):
        from repro_torch.core.quant import TPU_DOMAINS
        self.domains = tuple(domains) if domains is not None \
            else tuple(TPU_DOMAINS)
        self.chips = torch.tensor(chips_per_domain, dtype=_F)
        peaks, wbytes, eflops = [], [], []
        for d in self.domains:
            if d.weight_bits <= 8:
                peaks.append(2 * self.PEAK_BF16)       # int8 path
                wbytes.append(max(d.weight_bits, 4) / 8.0)
                eflops.append(self.E_PER_FLOP_BF16 / 2)
            else:
                peaks.append(self.PEAK_BF16)
                wbytes.append(2.0)
                eflops.append(self.E_PER_FLOP_BF16)
        self.peaks = torch.tensor(peaks, dtype=_F)
        self.wbytes = torch.tensor(wbytes, dtype=_F)
        self.eflops = torch.tensor(eflops, dtype=_F)

    def latency(self, geom: LayerGeometry,
                c_out_per_domain: torch.Tensor) -> torch.Tensor:
        c = _counts(c_out_per_domain)
        flops = 2.0 * geom.macs_per_out_channel * c
        bytes_ = geom.c_in * geom.fx * geom.fy * c * \
            _per_domain(self.wbytes, c)
        chips = _per_domain(self.chips, c)
        t_comp = flops / (chips * _per_domain(self.peaks, c))
        t_mem = bytes_ / (chips * self.HBM_BW)
        lat = torch.maximum(t_comp, t_mem)
        active = (c > 1e-6).to(lat.dtype)
        return lat * active

    def p_act(self) -> torch.Tensor:
        # effective active power ~ peak * energy per flop, per domain
        return self.peaks * self.eflops

    def p_idle(self) -> torch.Tensor:
        return torch.full((len(self.domains),), self.P_IDLE_W, dtype=_F)
