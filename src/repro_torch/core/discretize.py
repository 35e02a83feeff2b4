"""The Fig. 3 channel regrouping used by lowering
(``repro.core.discretize`` counterparts)."""
from __future__ import annotations

from typing import List

import numpy as np


def stable_perm(assign: np.ndarray) -> np.ndarray:
    """Permutation grouping channels by domain id, preserving relative order."""
    return np.argsort(assign, kind="stable")


def split_points(assign_sorted: np.ndarray, n_domains: int) -> List[int]:
    """Cumulative boundaries of the contiguous domain groups after sorting."""
    counts = [int(np.sum(assign_sorted == i)) for i in range(n_domains)]
    bounds, acc = [], 0
    for c in counts:
        acc += c
        bounds.append(acc)
    return bounds
