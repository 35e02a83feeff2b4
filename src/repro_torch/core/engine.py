"""The ODiMO search's shared types and the Eq. 2 loss builder
(``repro.core.engine`` counterparts; paper Sec. III-B):

    pretrain (fp) -> DNAS search (Eq. 2, tau annealed) -> discretize
    -> fine-tune (task loss only, exact formats) -> evaluate the mapping

The flow itself is `repro_torch.api.pipeline` (composable stages);
`run_odimo` and `evaluate_fixed_mapping` are thin wrappers over it for
the ``(init_fn, apply_fn, plan_fn)`` tuple façade.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import numpy as np

from repro_torch.core import losses, odimo
from repro_torch.core.cost_models import CostModel
from repro_torch.core.odimo import ODiMOSpec


@dataclasses.dataclass
class SearchConfig:
    lam: float = 1e-6                 # lambda, regularization strength (Eq. 2)
    objective: str = "latency"        # or "energy"
    pretrain_steps: int = 300
    search_steps: int = 400
    finetune_steps: int = 300
    batch: int = 64
    lr: float = 2e-3
    alpha_lr: float = 1e-2
    eval_batches: int = 8
    seed: int = 0


def make_loss_fn(apply_fn, plan, spec: ODiMOSpec, cost_model: CostModel,
                 cfg: SearchConfig, managed_paths_fn):
    """``loss_fn(params, batch, tau, mode) -> (loss, (task, reg))``: the
    cross entropy, plus ``lam`` x the latency or energy regularizer over
    the searchable managed layers in mode ``"search"`` (reg 0.0 in the
    other modes)."""
    geoms = [g for (_, g, s) in plan]
    searchable = [s for (_, g, s) in plan]

    def loss_fn(params, batch, tau, mode):
        x, y = batch
        logits = apply_fn(params, x, mode=mode, tau=tau)
        task = losses.cross_entropy(logits, y)
        if mode != "search":
            return task, (task, 0.0)
        layer_dicts = managed_paths_fn(params)
        abars, g_s = [], []
        for d, geom, s in zip(layer_dicts, geoms, searchable):
            if not s or "odimo" not in d:
                continue
            abars.append(odimo.alpha_bar(d["odimo"]["alpha"], tau))
            g_s.append(geom)
        if cfg.objective == "latency":
            reg = losses.latency_loss(cost_model, g_s, abars)
        else:
            reg = losses.energy_loss(cost_model, g_s, abars)
        return task + cfg.lam * reg, (task, reg)

    return loss_fn


@dataclasses.dataclass
class SearchResult:
    params: Any
    assignments: List[np.ndarray]       # per searchable layer, (C_out,) ints
    counts: List[np.ndarray]
    accuracy: float
    latency: float                      # exact, discretized (cost-model units)
    energy: float
    history: dict


def _as_search_result(res) -> SearchResult:
    return SearchResult(params=res.params, assignments=res.assignments,
                        counts=res.counts, accuracy=res.accuracy,
                        latency=res.latency, energy=res.energy,
                        history=res.history)


def run_odimo(model, cfg_model, spec: ODiMOSpec, cost_model: CostModel,
              scfg: SearchConfig, data_fn: Callable[[int, int], Any],
              verbose: bool = False, managed_fn=None,
              device="cuda") -> SearchResult:
    """The full paper pipeline on an ``(init_fn, apply_fn, plan_fn)``
    façade, on ``device`` (the card unless the caller asks for the
    CPU)."""
    from repro_torch.api import ModelHandle, SearchPipeline, VerboseCallback
    handle = ModelHandle.from_legacy(model, cfg_model, managed_fn=managed_fn)
    pipe = SearchPipeline(handle, spec=spec, cost_model=cost_model,
                          config=scfg, data_fn=data_fn,
                          callbacks=(VerboseCallback(),) if verbose else (),
                          device=device)
    return _as_search_result(pipe.run())


def evaluate_fixed_mapping(model, cfg_model, spec, cost_model: CostModel,
                           scfg: SearchConfig, data_fn,
                           assignments: List[np.ndarray],
                           train_steps: int | None = None,
                           managed_fn=None, device="cuda") -> SearchResult:
    """Train with a FIXED channel->domain mapping (the baselines) and
    evaluate it."""
    from repro_torch.api import ModelHandle, SearchPipeline
    handle = ModelHandle.from_legacy(model, cfg_model, managed_fn=managed_fn)
    pipe = SearchPipeline.fixed_mapping(handle, assignments,
                                        train_steps=train_steps, spec=spec,
                                        cost_model=cost_model, config=scfg,
                                        data_fn=data_fn, device=device)
    return _as_search_result(pipe.run())
