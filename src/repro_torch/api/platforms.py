"""`Platform`: named bundles of precision domains + a cost model
(``repro.api.platforms`` counterpart), registered with the JAX package's
values:

    "diana"                 DIANA SoC analytical models (paper Sec. III-C)
    "diana_abstract"        Fig. 5 abstract model, P_idle = P_act
    "diana_ideal_shutdown"  Fig. 5 abstract model, P_idle = 0
    "tpu_v5e"               the modelled TPU's roofline (int8 vs bf16
                            domains; `TPUCostModel`)
    "gap9_like"             GAP9-class 3-domain SoC: digital int8 NE16,
                            analog 2-bit in-memory array, fp16 DSP cluster
    "gpu_tc_like"           GPU tensor-core pair: int8 MMA @2x fp16
                            throughput (mixed layers fuse to the
                            split_precision kernel)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

from repro_torch.core import quant
from repro_torch.core.cost_models import (AbstractCostModel, CostModel,
                                          DianaCostModel, TPUCostModel)
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

    def kernel_capabilities(self) -> Dict[Tuple[str, ...], Tuple[str, str]]:
        """The runtime's kernel registry projected onto this platform: for
        each single domain and each ordered pair a layer could activate,
        the ``(kernel, note)`` it lowers to (fp fallbacks carry the
        reason)."""
        from repro_torch.runtime.lower import select_kernel
        n = len(self.domains)
        bits = [d.weight_bits for d in self.domains]
        out: Dict[Tuple[str, ...], Tuple[str, str]] = {}
        singles = [(i,) for i in range(n)]
        pairs = [(i, j) for i in range(n) for j in range(n) if i < j]
        for idx in singles + pairs:
            counts = [1 if i in idx else 0 for i in range(n)]
            out[tuple(self.domains[i].name for i in idx)] = \
                select_kernel(counts, bits)
        return out

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

    @staticmethod
    def names() -> Sequence[str]:
        return sorted(_REGISTRY)

    @staticmethod
    def unregister(name: str) -> None:
        _REGISTRY.pop(name, None)


Platform.register(Platform(
    name="diana",
    domains=tuple(quant.DIANA_DOMAINS),
    cost_model_factory=DianaCostModel,
    description="DIANA digital (8-bit) + AIMC (ternary), Sec. III-C models"))

Platform.register(Platform(
    name="diana_abstract",
    domains=tuple(quant.DIANA_DOMAINS),
    cost_model_factory=lambda **kw: AbstractCostModel(ideal_shutdown=False,
                                                      **kw),
    description="Fig. 5 abstract HW, P_idle = P_act"))

Platform.register(Platform(
    name="diana_ideal_shutdown",
    domains=tuple(quant.DIANA_DOMAINS),
    cost_model_factory=lambda **kw: AbstractCostModel(ideal_shutdown=True,
                                                      **kw),
    description="Fig. 5 abstract HW, P_idle = 0 (ideal shutdown)"))

Platform.register(Platform(
    name="tpu_v5e",
    domains=tuple(quant.TPU_DOMAINS),
    cost_model_factory=TPUCostModel,
    description="TPU v5e roofline model: int8 @2x peak vs bf16"))

# GAP9-class 3-domain SoC.  Domain 0 stays the digital int8 accelerator, so
# the pinning convention (non-searchable layers -> domain 0) keeps its
# meaning; the analog array is fastest and cheapest but 2-bit, the fp16
# cluster the slow high-precision escape hatch.
GAP9_DOMAINS = (
    PrecisionDomain("ne16", weight_bits=8, act_bits=8),
    PrecisionDomain("analog", weight_bits=2, act_bits=7),
    PrecisionDomain("cluster_fp16", weight_bits=16, act_bits=16),
)

Platform.register(Platform(
    name="gap9_like",
    domains=GAP9_DOMAINS,
    cost_model_factory=lambda **kw: AbstractCostModel(
        ideal_shutdown=False, domains=GAP9_DOMAINS,
        p_act=(10.0, 1.0, 40.0), throughput=(4.0, 16.0, 1.0), **kw),
    description="GAP9-like: digital int8 NE16 + analog 2-bit array + "
                "fp16 cluster, OP-proportional latency model"))

# GPU tensor-core pair.  The int8 domain comes first so mixed layers match
# the split_precision kernel's ("q", "f") registry key: int8 columns lead,
# identity columns trail.
GPU_TC_DOMAINS = (
    PrecisionDomain("tc_int8", weight_bits=8, act_bits=8),
    PrecisionDomain("tc_fp16", weight_bits=16, act_bits=16),
)

Platform.register(Platform(
    name="gpu_tc_like",
    domains=GPU_TC_DOMAINS,
    cost_model_factory=lambda **kw: AbstractCostModel(
        ideal_shutdown=True, domains=GPU_TC_DOMAINS,
        p_act=(20.0, 45.0), throughput=(2.0, 1.0), **kw),
    description="GPU tensor-core pair: int8 MMA @2x fp16 throughput, "
                "idle SMs clock-gated (ideal shutdown), OP-proportional "
                "latency"))
