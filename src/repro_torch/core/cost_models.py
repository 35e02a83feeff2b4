"""Analytical hardware cost models (``repro.core.cost_models``
counterparts), in numpy float32 with the JAX models' arithmetic: the
static channel split that the mapping emission searches is priced here.
Only what the emission needs is ported (the DIANA models and the Fig. 5
abstract model); the differentiable (search-time) use of these models and
the TPU roofline model wait for the search slice."""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.quant import PrecisionDomain

_F = np.float32


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
    groups: int = 1

    @property
    def macs_per_out_channel(self) -> int:
        return (self.c_in // self.groups) * self.fx * self.fy * self.ox * \
            self.oy


class CostModel:
    """Interface: latency per domain + active/idle powers per domain."""

    domains: Sequence[PrecisionDomain]

    def latency(self, geom: LayerGeometry,
                c_out_per_domain: np.ndarray) -> np.ndarray:
        """-> float32 array (N,) of latencies, one per domain."""
        raise NotImplementedError

    def p_act(self) -> np.ndarray:
        raise NotImplementedError

    def p_idle(self) -> np.ndarray:
        raise NotImplementedError


class DianaCostModel(CostModel):
    """The paper's analytical DIANA models (Sec. III-C).  Domain order is
    (digital, aimc); latencies in cycles @ 260 MHz."""

    AIMC_ROWS = 1152
    AIMC_COLS = 512
    AIMC_DMA_FACTOR = 2 * 4
    DIG_PE_COUT = 16
    DIG_PE_OY = 16
    FREQ_HZ = 260e6

    def __init__(self, p_act_mw=(28.0, 12.0), p_idle_mw=(4.0, 2.0)):
        from repro_torch.core.quant import DIANA_DOMAINS
        self.domains = DIANA_DOMAINS
        self._p_act = np.asarray(p_act_mw, _F)
        self._p_idle = np.asarray(p_idle_mw, _F)

    def lat_aimc(self, geom: LayerGeometry, c_out):
        n_col_programs = np.ceil(c_out / _F(self.AIMC_COLS))
        rows = np.ceil(_F(geom.c_in * geom.fx * geom.fy / self.AIMC_ROWS))
        compute = rows * n_col_programs * _F(geom.ox) * _F(geom.oy)
        dma = _F(self.AIMC_DMA_FACTOR * geom.c_in) * n_col_programs
        return compute + dma

    def lat_digital(self, geom: LayerGeometry, c_out):
        compute = (np.ceil(c_out / _F(self.DIG_PE_COUT))
                   * np.ceil(_F(geom.oy / self.DIG_PE_OY))
                   * _F(geom.c_in) * _F(geom.ox) * _F(geom.fx) * _F(geom.fy))
        wload = _F(geom.c_in) * c_out * _F(geom.fx) * _F(geom.fy)
        return compute + wload

    def latency(self, geom: LayerGeometry, c_out_per_domain) -> np.ndarray:
        c = np.asarray(c_out_per_domain, _F)
        lat = np.stack([self.lat_digital(geom, c[0]),
                        self.lat_aimc(geom, c[1])]).astype(_F)
        # a domain with zero channels contributes zero latency
        return lat * (c > 1e-6).astype(_F)

    def p_act(self) -> np.ndarray:
        return self._p_act

    def p_idle(self) -> np.ndarray:
        return self._p_idle


class AbstractCostModel(CostModel):
    """Fig. 5 models: latency proportional to OPs, ``macs * c_out /
    throughput`` per domain.  ``ideal_shutdown=False`` -> P_idle = P_act,
    ``True`` -> P_idle = 0.  ``domains`` (default: DIANA's two), ``p_act``
    and ``throughput`` (MACs per time unit, default 1) describe any domain
    tuple, e.g. the ``gpu_tc_like`` pair."""

    def __init__(self, ideal_shutdown: bool, p_act=(10.0, 1.0),
                 domains=None, throughput=None):
        from repro_torch.core.quant import DIANA_DOMAINS
        self.domains = tuple(domains) if domains is not None \
            else tuple(DIANA_DOMAINS)
        n = len(self.domains)
        self.ideal_shutdown = ideal_shutdown
        self._p_act = np.asarray(p_act, _F)
        self._thr = (np.asarray(throughput, _F) if throughput is not None
                     else np.ones(n, _F))
        if self._p_act.shape[0] != n or self._thr.shape[0] != n:
            raise ValueError(f"p_act/throughput must match {n} domains")
        self._p_idle = np.zeros(n, _F) if ideal_shutdown else self._p_act

    def latency(self, geom: LayerGeometry, c_out_per_domain) -> np.ndarray:
        c = np.asarray(c_out_per_domain, _F)
        return (_F(geom.macs_per_out_channel) * c / self._thr).astype(_F)

    def p_act(self) -> np.ndarray:
        return self._p_act

    def p_idle(self) -> np.ndarray:
        return self._p_idle
