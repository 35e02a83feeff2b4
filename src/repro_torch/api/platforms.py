"""`Platform`: named bundles of precision domains + a cost model
(``repro.api.platforms`` counterpart).  The port registers ``diana``, the
platform of its main path; the others wait for the search slice."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from repro_torch.core import quant
from repro_torch.core.cost_models import CostModel, DianaCostModel
from repro_torch.core.odimo import ODiMOSpec
from repro_torch.core.quant import PrecisionDomain

_REGISTRY: Dict[str, "Platform"] = {}


@dataclasses.dataclass(frozen=True)
class Platform:
    """A named accelerator target for the mapping search."""
    name: str
    domains: Tuple[PrecisionDomain, ...]
    cost_model_factory: Callable[[], CostModel]
    description: str = ""

    def spec(self, **overrides) -> ODiMOSpec:
        """ODiMOSpec for this platform; shared activations default to the
        worst-case bit-width across domains (paper Sec. III-B)."""
        kw = dict(domains=self.domains,
                  act_bits=min(d.act_bits for d in self.domains))
        kw.update(overrides)
        return ODiMOSpec(**kw)

    def cost_model(self, **kw) -> CostModel:
        return self.cost_model_factory(**kw)

    @staticmethod
    def register(platform: "Platform", overwrite: bool = False) -> "Platform":
        if platform.name in _REGISTRY and not overwrite:
            raise ValueError(
                f"platform {platform.name!r} already registered "
                f"(pass overwrite=True to replace)")
        _REGISTRY[platform.name] = platform
        return platform

    @staticmethod
    def get(name: "str | Platform") -> "Platform":
        if isinstance(name, Platform):
            return name
        try:
            return _REGISTRY[name]
        except KeyError:
            raise KeyError(f"unknown platform {name!r}; "
                           f"registered: {sorted(_REGISTRY)}") from None


Platform.register(Platform(
    name="diana",
    domains=tuple(quant.DIANA_DOMAINS),
    cost_model_factory=DianaCostModel,
    description="DIANA digital (8-bit) + AIMC (ternary), Sec. III-C models"))
