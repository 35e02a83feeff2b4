"""Baseline mappings of the paper (``repro.core.baselines``
counterparts; Sec. IV-A):

  all_8bit        : every channel on the digital (8-bit) accelerator
  all_ternary     : every channel on the AIMC (ternary) accelerator
  io8_backbone_ter: first and last layers digital, everything else AIMC
  min_cost        : per-layer channel split statically minimizing Eq. 3 or
                    Eq. 4, ignoring accuracy; ties maximize digital channels

Assignments are (C_out,) int64 numpy arrays in the cost model's domain
indexing (0 = digital / 8-bit, 1 = AIMC / ternary on DIANA).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core.cost_models import CostModel, LayerGeometry


def all_domain(geoms: Sequence[LayerGeometry], domain: int
               ) -> List[np.ndarray]:
    return [np.full(g.c_out, domain, dtype=np.int64) for g in geoms]


def all_8bit(geoms: Sequence[LayerGeometry]) -> List[np.ndarray]:
    return all_domain(geoms, 0)


def all_ternary(geoms: Sequence[LayerGeometry]) -> List[np.ndarray]:
    return all_domain(geoms, 1)


def io8_backbone_ternary(geoms: Sequence[LayerGeometry]) -> List[np.ndarray]:
    out = all_domain(geoms, 1)
    out[0][:] = 0
    out[-1][:] = 0
    return out


def _split_costs(cm: CostModel, geom: LayerGeometry,
                 objective: str) -> List[float]:
    """Cost of every split ``(k digital, C_out - k ternary)``, k = 0 ..
    C_out, priced in one batched call (each column's float32 arithmetic
    is that of a single-split call)."""
    k = torch.arange(geom.c_out + 1, dtype=torch.float32)
    lat = cm.latency(geom, torch.stack([k, geom.c_out - k]))
    m = torch.amax(lat, dim=0)
    if objective == "latency":
        return m.tolist()
    p_act, p_idle = cm.p_act()[:, None], cm.p_idle()[:, None]
    return torch.sum(p_act * lat + p_idle * (m - lat), dim=0).tolist()


def _best_digital_count(cm: CostModel, geom: LayerGeometry,
                        objective: str) -> int:
    best_k, best_cost = 0, float("inf")
    for k, c in enumerate(_split_costs(cm, geom, objective)):
        # ties keep the LARGER digital count (expected to help accuracy)
        rel = abs(best_cost) if best_cost != float("inf") else 1.0
        if c < best_cost - 1e-9 * rel or abs(c - best_cost) <= 1e-9 * rel:
            best_cost, best_k = min(c, best_cost), k
    return best_k


def min_cost(cm: CostModel, geoms: Sequence[LayerGeometry],
             objective: str = "latency",
             searchable: Sequence[bool] | None = None) -> List[np.ndarray]:
    """Exhaustive per-layer split search; ``searchable[l] = False`` pins
    layer l to the digital domain.  Layers of one geometry share one
    search (the split depends on nothing else)."""
    best: Dict[LayerGeometry, int] = {}
    assigns: List[np.ndarray] = []
    for li, geom in enumerate(geoms):
        if searchable is not None and not searchable[li]:
            assigns.append(np.zeros(geom.c_out, dtype=np.int64))
            continue
        if geom not in best:
            best[geom] = _best_digital_count(cm, geom, objective)
        a = np.ones(geom.c_out, dtype=np.int64)
        a[:best[geom]] = 0
        assigns.append(a)
    return assigns


def counts_from_assignments(assigns: Sequence[np.ndarray], n_domains: int):
    return [np.asarray([int(np.sum(a == i)) for i in range(n_domains)])
            for a in assigns]
