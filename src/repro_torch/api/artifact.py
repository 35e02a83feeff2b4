"""`MappingArtifact`: the serializable result of a mapping search.

One JSON document records everything needed to re-deploy (or re-evaluate) a
discovered channel->domain mapping without re-running the DNAS:

    {
      "schema_version": 2,
      "model": "resnet20_tiny",
      "platform": "diana",            # registry name, or null for ad hoc
      "objective": "latency",
      "lam": 5e-07,
      "seed": 0,
      "domains": [{"name": "digital", "weight_bits": 8, "act_bits": 8}, ...],
      "layers": [{"name": "stem", "searchable": true,
                  "assignment": [0, 1, ...],     # domain idx per out channel
                  "counts": [12, 4],             # channels per domain
                  "scales": {                    # v2: quant scales (optional)
                    "w_log_scales": [s_dom0, s_dom1, ...],
                    "act_log_scale": 0.13 | null}}, ...],
      "metrics": {"accuracy": ..., "latency": ..., "energy": ...}
    }

Schema v2 adds the optional per-layer ``scales`` block so the artifact is
self-contained for *execution*: `repro_torch.runtime.lower` compiles it into an
`ExecutionPlan` (per-layer kernel + reorg permutation + aligned boundaries).
v1 documents (no ``scales``) still load and lower — executors then fall back
to max-abs scale statistics of the weights they bind to.

Consumers: `repro_torch.runtime.lower` (-> per-layer planned execution
in ``launch/serve.py --mapping``).  Documents are interchangeable with
``repro.api.MappingArtifact``'s.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

SCHEMA_VERSION = 2


@dataclasses.dataclass
class MappingArtifact:
    model: str
    domains: List[Dict[str, Any]]
    layers: List[Dict[str, Any]]
    platform: str | None = None
    objective: str | None = None
    lam: float | None = None
    seed: int | None = None
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    schema_version: int = SCHEMA_VERSION

    # ---- construction ----------------------------------------------------

    @classmethod
    def from_search(cls, model_name: str, spec, plan, assignments,
                    counts, platform=None, objective=None, lam=None,
                    seed=None, metrics=None, scales=None) -> "MappingArtifact":
        """``scales``: optional per-layer list of
        ``{"w_log_scales": [...], "act_log_scale": float | None}`` dicts
        (None entries allowed) — the schema-v2 execution scales."""
        if not (len(plan) == len(assignments) == len(counts)):
            raise ValueError(f"plan/assignments/counts length mismatch: "
                             f"{len(plan)}/{len(assignments)}/{len(counts)}")
        if scales is not None and len(scales) != len(plan):
            raise ValueError(f"plan/scales length mismatch: "
                             f"{len(plan)}/{len(scales)}")
        domains = [dict(name=d.name, weight_bits=d.weight_bits,
                        act_bits=d.act_bits) for d in spec.domains]
        layers = []
        for i, ((name, geom, searchable), a, c) in enumerate(
                zip(plan, assignments, counts)):
            layer = dict(name=name, searchable=bool(searchable),
                         assignment=[int(v) for v in np.asarray(a)],
                         counts=[int(v) for v in np.asarray(c)])
            # grouped/depthwise convs carry their group count so the
            # runtime can lower them block-diagonally (LayerPlan.groups)
            groups = int(getattr(geom, "groups", 1) or 1)
            if groups > 1:
                layer["groups"] = groups
            if scales is not None and scales[i] is not None:
                layer["scales"] = scales[i]
            layers.append(layer)
        return cls(model=model_name, domains=domains, layers=layers,
                   platform=platform, objective=objective, lam=lam,
                   seed=seed, metrics=dict(metrics or {}))

    # ---- accessors -------------------------------------------------------

    def assignments(self) -> List[np.ndarray]:
        return [np.asarray(l["assignment"], dtype=np.int64)
                for l in self.layers]

    def counts(self) -> List[np.ndarray]:
        return [np.asarray(l["counts"], dtype=np.int64) for l in self.layers]

    @property
    def n_domains(self) -> int:
        return len(self.domains)

    def domain_channel_fractions(self, searchable_only: bool = False
                                 ) -> np.ndarray:
        """Fraction of all channels assigned to each domain.

        ``searchable_only=True`` counts only ``searchable: true`` layers —
        pinned layers never had a choice, so they must not vote when a
        consumer (the KV-cache precision choice of ``serve``) derives a
        majority domain.  Counts all layers when none are searchable.
        """
        tot = np.zeros(self.n_domains, dtype=np.float64)
        for l in self.layers:
            if searchable_only and not l.get("searchable", True):
                continue
            tot += np.asarray(l["counts"], dtype=np.float64)
        if searchable_only and tot.sum() == 0.0:
            return self.domain_channel_fractions(searchable_only=False)
        return tot / max(tot.sum(), 1.0)

    # ---- (de)serialization ----------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, indent: int | None = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "MappingArtifact":
        d = dict(d)
        version = d.pop("schema_version", SCHEMA_VERSION)
        if version > SCHEMA_VERSION:
            raise ValueError(f"mapping artifact schema v{version} is newer "
                             f"than supported v{SCHEMA_VERSION}")
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(schema_version=version,
                   **{k: v for k, v in d.items() if k in fields})

    @classmethod
    def from_json(cls, s: str) -> "MappingArtifact":
        return cls.from_dict(json.loads(s))

    def save(self, path) -> Path:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.to_json())
        return p

    @classmethod
    def load(cls, path) -> "MappingArtifact":
        return cls.from_json(Path(path).read_text())
