"""Mapping-execution runtime (``repro.runtime`` counterpart): lower a
`MappingArtifact` to an `ExecutionPlan`, bind it to params, and execute
planned layers through the port's CUDA kernels.

    plan    = lower(artifact, params=params)
    backend = PlannedBackend(plan, params)
    with repro_torch.models._backend.use(backend):
        logits, caches = transformer.prefill(params, cfg, tokens, caches)

A `PlanSet` binds several plans of the same weights as one precision bank
(``PlanSet({"target": plan_a, "draft": plan_b}, params)``), selected per
call by ``variant=`` (``transformer.prefill(..., variant="draft")``).

Conv layers (4-D HWIO weights, grouped ones included) bind too and run
through im2col (`execute_conv_layer`) when the model's conv call sites
(`repro_torch.models.managed.conv2d`) consult the backend.
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
                                         PlanSet, PreparedLayer,
                                         execute_conv_layer, execute_layer,
                                         im2col, prepare_layer,
                                         prepared_nbytes)

__all__ = [
    "ExecutionError", "ExecutionPlan", "KernelCapability", "LayerPlan",
    "LoweringError", "PlanSet", "PlannedBackend", "PreparedLayer",
    "KERNELS",
    "KERNEL_FP", "KERNEL_QUANT", "KERNEL_SPLIT", "KERNEL_SPLIT_TERNARY",
    "KERNEL_TERNARY", "capability_matrix", "execute_conv_layer",
    "execute_layer", "im2col", "kernel_for", "lower", "prepare_layer",
    "prepared_nbytes", "register_kernel", "resolve_layer_params",
    "unregister_kernel",
]
