"""Mapping emission of the training entry point (``repro.launch.train``
counterpart).  Only `emit_static_mapping` is ported; the training loop
waits for the training slice."""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.api import MappingArtifact, Platform
from repro_torch.core import baselines, quant
from repro_torch.core.cost_models import LayerGeometry


def _flatten_with_path(tree, path=()) -> Iterator[Tuple[List[str], object]]:
    """Leaves with their key paths in ``jax.tree_util`` flatten order (dict
    keys sorted, sequences in order), so layer names and their order match
    the JAX package's emission."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_path(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_path(v, path + (str(i),))
    else:
        yield list(path), tree


def emit_static_mapping(params, cfg, platform, out_path, max_cout=512,
                        stacked_prefixes=("units", "enc_units"),
                        act_log_scale=None, bias=None):
    """Write a schema-v2 mapping artifact for the model's projection
    weights: per-layer min-cost static channel split (paper Sec. IV
    baselines) under the named platform's cost model, with max-abs weight
    quant scales so the artifact lowers to an executable `ExecutionPlan`.

    Layer names are params paths in flatten order.  2-D ``(C_in, C_out)``
    weights give one layer each; 3-D ``(R, C_in, C_out)`` stacked weights
    under a ``stacked_prefixes`` subtree give one layer PER REPEAT, named
    ``path@r`` with that repeat's own scale.  Layers wider than
    ``max_cout`` output channels are pinned to domain 0 (the exhaustive
    split search is O(C_out) cost evaluations).  ``act_log_scale`` pins a
    static activation scale on every layer (None: dynamic per call).

    ``bias=(domain_name, fraction)`` overrides the min-cost split of every
    searchable layer: its first ``round(fraction * C_out)`` channels go to
    that domain and the rest to domain 0 (domain 1 when the biased domain
    is domain 0).  ``("aimc", 1.0)`` on ``diana`` is the paper's
    all-ternary baseline on the searchable layers.
    """
    plat = Platform.get(platform)
    cm, spec = plat.cost_model(), plat.spec()
    names, geoms, searchable, scales = [], [], [], []

    def w_scale(w):
        ls = float(quant.init_log_scale(w))
        return {"w_log_scales": [ls] * spec.n_domains,
                "act_log_scale": (float(act_log_scale)
                                  if act_log_scale is not None else None)}

    for parts, leaf in _flatten_with_path(params):
        if not parts or parts[-1] != "w" or not isinstance(leaf,
                                                           torch.Tensor):
            continue
        parts = parts[:-1]
        name = "/".join(parts)
        if leaf.dim() == 2:
            names.append(name)
            geoms.append(LayerGeometry(c_in=leaf.shape[0],
                                       c_out=leaf.shape[1]))
            searchable.append(leaf.shape[1] <= max_cout)
            scales.append(w_scale(leaf))
        elif leaf.dim() == 3 and parts and parts[0] in stacked_prefixes:
            for r in range(leaf.shape[0]):
                names.append(f"{name}@{r}")
                geoms.append(LayerGeometry(c_in=leaf.shape[1],
                                           c_out=leaf.shape[2]))
                searchable.append(leaf.shape[2] <= max_cout)
                scales.append(w_scale(leaf[r]))
    assigns = baselines.min_cost(cm, geoms, "latency", searchable)
    if bias is not None:
        dom_name, frac = bias
        dom_names = [d.name for d in spec.domains]
        if dom_name not in dom_names:
            raise ValueError(f"bias domain {dom_name!r} is not on platform "
                             f"{plat.name} (domains: {dom_names})")
        if not (0.0 <= frac <= 1.0):
            raise ValueError(f"bias fraction must be in [0, 1], got {frac}")
        di = dom_names.index(dom_name)
        other = 0 if di != 0 else min(1, spec.n_domains - 1)
        for li, a in enumerate(assigns):
            if not searchable[li]:
                continue
            k = int(round(frac * a.size))
            forced = np.full(a.size, other, dtype=np.int64)
            forced[:k] = di
            assigns[li] = forced
    counts = baselines.counts_from_assignments(assigns, spec.n_domains)
    plan = list(zip(names, geoms, searchable))
    art = MappingArtifact.from_search(cfg.name, spec, plan, assigns, counts,
                                      platform=plat.name, objective="latency",
                                      scales=scales)
    art.save(out_path)
    print(f"[train] wrote mapping artifact ({len(names)} layers, schema v"
          f"{art.schema_version}, platform={plat.name}) -> {out_path}")
    return art
