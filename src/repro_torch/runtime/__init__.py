"""Mapping-execution runtime (``repro.runtime`` counterpart): lower a
`MappingArtifact` to an `ExecutionPlan`, bind it to params, and execute
planned layers through the port's CUDA kernels.

    plan    = lower(artifact, params=params)
    backend = PlannedBackend(plan, params)
    with repro_torch.models._backend.use(backend):
        logits, caches = transformer.prefill(params, cfg, tokens, caches)
"""
from repro_torch.runtime.plan import (KERNEL_FP, KERNEL_QUANT, KERNEL_SPLIT,
                                      KERNEL_SPLIT_TERNARY, KERNEL_TERNARY,
                                      KERNELS, ExecutionPlan, LayerPlan,
                                      LoweringError)
from repro_torch.runtime.registry import (KernelCapability,
                                          capability_matrix, kernel_for,
                                          register_kernel, unregister_kernel)
from repro_torch.runtime.lower import lower, resolve_layer_params
from repro_torch.runtime.execute import (ExecutionError, PlannedBackend,
                                         PreparedLayer, execute_layer,
                                         prepare_layer)

__all__ = [
    "ExecutionError", "ExecutionPlan", "KernelCapability", "LayerPlan",
    "LoweringError", "PlannedBackend", "PreparedLayer", "KERNELS",
    "KERNEL_FP", "KERNEL_QUANT", "KERNEL_SPLIT", "KERNEL_SPLIT_TERNARY",
    "KERNEL_TERNARY", "capability_matrix", "execute_layer", "kernel_for",
    "lower", "prepare_layer", "register_kernel", "resolve_layer_params",
    "unregister_kernel",
]
