"""Discretization and the layer-reorganization pass of paper Fig. 3
(``repro.core.discretize`` counterparts).

After the search every output channel goes to its argmax domain.  Channels
of one accelerator are in general scattered; this pass permutes each
layer's output channels (and the NEXT layer's input channels) so that
same-domain channels are contiguous, splitting the layer into N
sub-layers that run in parallel with no data marshaling.  Lowering
(`repro_torch.runtime.lower`) uses `stable_perm` / `split_points`.

Weight layouts: dense ``(C_in, C_out)`` (in axis 0), conv HWIO ``(kh, kw,
C_in, C_out)`` (in axis -2); the out axis is always -1.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class ReorgLayer:
    """One ODiMO-managed layer of a sequential chain."""
    w: torch.Tensor              # out channels on the last axis
    b: torch.Tensor | None       # (C_out,) or None
    assign: np.ndarray           # (C_out,) int domain index per channel
    in_axis: int = 0             # axis of w indexed by the PREVIOUS perm
    extras: dict | None = None   # other per-out-channel tensors


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


def _take(t: torch.Tensor, perm: np.ndarray, dim: int) -> torch.Tensor:
    return torch.index_select(t, dim, torch.from_numpy(perm).to(t.device))


def reorg_chain(layers: Sequence[ReorgLayer], n_domains: int):
    """Apply the Fig. 3 pass to a sequential chain of layers.

    Returns (new_layers, per-layer split boundaries).  Layer l's output
    permutation is applied to layer l+1's input axis; the final layer's
    outputs are NOT permuted (the network's outputs keep their meaning).
    """
    new_layers: List[ReorgLayer] = []
    bounds_per_layer: List[List[int]] = []
    prev_perm: np.ndarray | None = None
    last = len(layers) - 1
    for li, layer in enumerate(layers):
        w, b = layer.w, layer.b
        if prev_perm is not None:
            w = _take(w, prev_perm, layer.in_axis)
        perm = (np.arange(layer.assign.shape[0]) if li == last
                else stable_perm(layer.assign))
        w = _take(w, perm, w.dim() - 1)
        if b is not None:
            b = _take(b, perm, 0)
        extras = None
        if layer.extras:
            extras = {k: _take(v, perm, v.dim() - 1)
                      for k, v in layer.extras.items()}
        a_sorted = layer.assign[perm]
        new_layers.append(ReorgLayer(w=w, b=b, assign=a_sorted,
                                     in_axis=layer.in_axis, extras=extras))
        bounds_per_layer.append(split_points(a_sorted, n_domains))
        prev_perm = perm
    return new_layers, bounds_per_layer


def sublayer_slices(bounds: List[int]):
    """[(start, end)] per domain from cumulative boundaries."""
    out, start = [], 0
    for end in bounds:
        out.append((start, end))
        start = end
    return out


# --------------------------------------------------------------------------
# Mapping-artifact consumption (plain dicts, so core never imports api)
# --------------------------------------------------------------------------

def assignments_from_artifact(artifact) -> List[np.ndarray]:
    """Per-layer (C_out,) domain assignments of a mapping artifact (a
    `repro_torch.api.MappingArtifact` or its plain-dict / JSON form)."""
    if hasattr(artifact, "to_dict"):
        artifact = artifact.to_dict()
    return [np.asarray(l["assignment"], dtype=np.int64)
            for l in artifact["layers"]]


def reorg_chain_from_artifact(layers: Sequence[ReorgLayer], artifact):
    """The Fig. 3 pass driven by a stored mapping artifact: ``layers`` is
    the chain in artifact layer order, each layer's ``assign`` replaced by
    the artifact's, with the artifact's domain count."""
    if hasattr(artifact, "to_dict"):
        artifact = artifact.to_dict()
    assigns = assignments_from_artifact(artifact)
    if len(assigns) != len(layers):
        raise ValueError(f"artifact has {len(assigns)} layers, chain has "
                         f"{len(layers)}")
    layers = [dataclasses.replace(l, assign=a)
              for l, a in zip(layers, assigns)]
    return reorg_chain(layers, len(artifact["domains"]))
