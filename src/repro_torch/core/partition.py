"""Precision-domain -> tensor-parallel sub-group planning
(``repro.core.partition`` counterpart).

Domain i of a layer gets a contiguous sub-group of the tensor-parallel
axis sized in proportion to its single-device latency share, so that all
domains finish together (the paper's smooth-max balance, solved exactly at
the device-allocation level).  Given the per-layer channel counts that the
search discretized, this module sizes each domain's sub-group
(water-filling on the cost model's latency), emits per-layer column
ranges into the reorganized weight matrix (Fig. 3 layout) and checks the
plan: every channel covered once, device counts summing to the axis size.

The cost models of `repro_torch.core.cost_models` return float32 tensors;
they are read into numpy where the JAX package calls ``np.asarray``, so
that the water-filling sees the same float32 values.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.core.cost_models import CostModel, LayerGeometry


@dataclasses.dataclass(frozen=True)
class DomainShard:
    domain: int          # precision-domain index
    devices: int         # devices of the model axis assigned to the domain
    col_start: int       # first output channel (post-reorg) of this domain
    col_end: int


@dataclasses.dataclass
class LayerPlan:
    geom: LayerGeometry
    shards: List[DomainShard]

    def check(self, tp_size: int):
        cols = sorted((s.col_start, s.col_end) for s in self.shards)
        assert cols[0][0] == 0 and cols[-1][1] == self.geom.c_out
        for (a, b), (c, d) in zip(cols, cols[1:]):
            assert b == c, "channel ranges must tile exactly"
        assert sum(s.devices for s in self.shards) == tp_size


def size_subgroups(cost_model: CostModel, geom: LayerGeometry,
                   counts: Sequence[int], tp_size: int) -> List[int]:
    """Devices per domain in proportion to that domain's single-device
    latency share (equalizes finish times: the max in Eq. 3 becomes
    tight)."""
    lat = cost_model.latency(geom, np.asarray(counts, np.float32))
    lat = np.maximum(lat.detach().cpu().numpy(), 0.0)
    if lat.sum() == 0:
        out = [0] * len(counts)
        out[0] = tp_size
        return out
    raw = lat / lat.sum() * tp_size
    dev = np.floor(raw).astype(int)
    # give leftovers to the largest fractional parts; every active domain
    # gets at least one device
    active = np.asarray(counts) > 0
    dev[active & (dev == 0)] = 1
    while dev.sum() > tp_size:
        i = int(np.argmax(dev))
        dev[i] -= 1
    frac = raw - np.floor(raw)
    order = np.argsort(-frac)
    k = 0
    while dev.sum() < tp_size:
        i = int(order[k % len(order)])
        if active[i] or dev.sum() + 1 == tp_size:
            dev[i] += 1
        k += 1
    return [int(d) for d in dev]


def plan_layer(cost_model: CostModel, geom: LayerGeometry,
               counts: Sequence[int], tp_size: int) -> LayerPlan:
    """Reorg-ordered channel ranges + device allocation for one layer."""
    devs = size_subgroups(cost_model, geom, counts, tp_size)
    shards, col = [], 0
    for i, (c, d) in enumerate(zip(counts, devs)):
        shards.append(DomainShard(domain=i, devices=d, col_start=col,
                                  col_end=col + int(c)))
        col += int(c)
    plan = LayerPlan(geom=geom, shards=shards)
    plan.check(tp_size)
    return plan


def plan_network(cost_model: CostModel, geoms: Sequence[LayerGeometry],
                 counts_per_layer: Sequence[Sequence[int]],
                 tp_size: int) -> List[LayerPlan]:
    return [plan_layer(cost_model, g, c, tp_size)
            for g, c in zip(geoms, counts_per_layer)]
