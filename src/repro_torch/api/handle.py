"""`ModelHandle`: the typed model façade the mapping search runs over
(``repro.api.handle`` counterpart).

A handle bundles what ODiMO needs from a model: parameter init, the
mode-aware forward, the layer plan (geometry + searchability) and the
lookup of the ODiMO-managed layer dicts in the params.  The model config
is bound at construction.  The default lookup resolves the plan names as
slash-separated params paths (``"blocks/0/c1"`` -> ``params["blocks"][0]
["c1"]``); custom layouts pass ``managed_layers``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import tree as T
from repro_torch.core.cost_models import LayerGeometry
from repro_torch.models.managed import get_by_path

Plan = List[Tuple[str, LayerGeometry, bool]]


def _generator(gen, device) -> torch.Generator:
    """``gen`` itself, or a generator on ``device`` seeded with the int
    ``gen``."""
    if isinstance(gen, torch.Generator):
        return gen
    return torch.Generator(device=device).manual_seed(int(gen))


@dataclasses.dataclass(frozen=True)
class ModelHandle:
    """Typed façade over a searchable model.

    init(gen, spec)                   -> params on ``gen``'s device (an
                                         int seed seeds a generator on
                                         ``device=``, the card unless the
                                         caller asks for the CPU)
    apply(params, x, spec, mode, tau) -> logits
    plan()                            -> [(name, LayerGeometry, searchable)]
    managed_layers(params)            -> managed layer dicts, plan order
                                         (None => lookup by plan names)
    """
    name: str
    init: Callable[..., Any]
    apply: Callable[..., torch.Tensor]
    plan: Callable[[], Plan]
    managed_layers: Callable[[Any], List[dict]] | None = None
    config: Any = None

    def layers(self, params) -> List[dict]:
        """Managed layer dicts of ``params``, in plan order."""
        if self.managed_layers is not None:
            return self.managed_layers(params)
        return [get_by_path(params, name) for (name, _, _) in self.plan()]

    def geometries(self) -> List[LayerGeometry]:
        return [g for (_, g, _) in self.plan()]

    def searchable(self) -> List[bool]:
        return [s for (_, _, s) in self.plan()]

    def with_assignments(self, params, assignments: Sequence[np.ndarray],
                         n_domains: int, margin: float = 10.0):
        """A NEW params tree whose alphas one-hot-encode a fixed
        channel->domain mapping (large-margin logits).

        Functional: the managed dicts are located with `layers` and the
        matching alpha tensors swapped by identity, so the input tree is
        left untouched."""
        layers = self.layers(params)
        if len(assignments) != len(layers):
            raise ValueError(
                f"{self.name}: {len(assignments)} assignments for "
                f"{len(layers)} managed layers (one per plan entry required)")
        replacements = {}
        for d, a in zip(layers, assignments):
            if "odimo" not in d:
                continue
            alpha = d["odimo"]["alpha"]
            onehot = np.eye(n_domains)[np.asarray(a)].T * margin
            replacements[id(alpha)] = torch.as_tensor(
                onehot, dtype=torch.float32, device=alpha.device)
        leaf_ids = {id(leaf) for leaf in T.leaves(params)}
        if not set(replacements).issubset(leaf_ids):
            raise ValueError(
                f"{self.name}: managed_layers returned alpha tensors that "
                "are not leaves of the given params; with_assignments "
                "needs the original (non-copied) layer dicts")
        return T.tree_map(lambda leaf: replacements.get(id(leaf), leaf),
                          params)

    # ---- adapters --------------------------------------------------------

    @classmethod
    def from_legacy(cls, model, cfg, managed_fn=None,
                    name: str | None = None) -> "ModelHandle":
        """Wrap an ``(init_fn, apply_fn, plan_fn)`` façade tuple (+
        optional ``managed_fn``)."""
        init_fn, apply_raw, plan_fn = model
        return cls(
            name=name or getattr(cfg, "name", "legacy"),
            init=lambda gen, spec, device="cuda": init_fn(
                _generator(gen, device), cfg, spec),
            apply=lambda p, x, spec, mode, tau: apply_raw(p, x, cfg, spec,
                                                          mode, tau),
            plan=lambda: plan_fn(cfg),
            managed_layers=managed_fn,
            config=cfg,
        )


def cnn_handle(cfg) -> ModelHandle:
    """Handle over the paper's CNN façades (`repro_torch.models.cnn`)."""
    from repro_torch.models import cnn
    return ModelHandle.from_legacy(cnn.get_model(cfg), cfg, name=cfg.name)


def mlp_handle(cfg=None, **kw) -> ModelHandle:
    """Handle over the managed-Dense MLP façade."""
    from repro_torch.models import facades
    if cfg is None:
        cfg = facades.MLPConfig(**kw)
    return ModelHandle.from_legacy(
        (facades.mlp_init, facades.mlp_apply, facades.mlp_plan), cfg,
        name=cfg.name)


def transformer_handle(cfg=None, **kw) -> ModelHandle:
    """Handle over the managed transformer-encoder classifier façade."""
    from repro_torch.models import facades
    if cfg is None:
        cfg = facades.EncoderConfig(**kw)
    return ModelHandle.from_legacy(
        (facades.encoder_init, facades.encoder_apply, facades.encoder_plan),
        cfg, name=cfg.name)
