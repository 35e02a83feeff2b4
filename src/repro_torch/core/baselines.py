"""The paper's min-cost static mapping (``repro.core.baselines``
counterparts of ``_layer_cost``, ``min_cost`` and
``counts_from_assignments``)."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.cost_models import CostModel, LayerGeometry


def _layer_cost(cm: CostModel, geom: LayerGeometry, k_dig: int,
                objective: str) -> float:
    counts = np.asarray([k_dig, geom.c_out - k_dig], dtype=np.float32)
    lat = cm.latency(geom, counts)
    m = np.max(lat)
    if objective == "latency":
        return float(m)
    p_act, p_idle = cm.p_act(), cm.p_idle()
    return float(np.sum(p_act * lat + p_idle * (m - lat), dtype=np.float32))


def _best_digital_count(cm: CostModel, geom: LayerGeometry,
                        objective: str) -> int:
    best_k, best_cost = 0, float("inf")
    for k in range(geom.c_out + 1):
        c = _layer_cost(cm, geom, k, objective)
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
