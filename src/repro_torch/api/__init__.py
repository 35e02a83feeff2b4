"""The mapping API (``repro.api`` counterpart).

`ModelHandle` (`repro_torch.api.handle`): the typed model façade,
``init(gen, spec)``, ``apply(params, x, spec, mode, tau)``, ``plan()``
and ``managed_layers``; adapters `cnn_handle`, `mlp_handle`,
`transformer_handle` and ``ModelHandle.from_legacy``.

`Platform` (`repro_torch.api.platforms`): named precision domains + a
cost model (``"diana"``, ``"diana_abstract"``, ``"diana_ideal_shutdown"``,
``"tpu_v5e"``, ``"gap9_like"``, ``"gpu_tc_like"``).

`SearchPipeline` (`repro_torch.api.pipeline`): the paper's flow as
stages, on the card unless the caller passes ``device="cpu"``::

    pipe = SearchPipeline(cnn_handle(cfg), "diana",
                          config=SearchConfig(lam=5e-7), data_fn=data_fn)
    res = pipe.run()
    res.artifact.save("mapping.json")
    plan = lower(res.artifact, params=res.params, handle=handle)
    backend = runtime.PlannedBackend(plan, res.params, handle=handle)
    with repro_torch.models.managed.matmul_backend(backend):
        logits = handle.apply(res.params, x, spec, "deploy", 1.0)

`MappingArtifact` (`repro_torch.api.artifact`): the schema-v2 JSON
mapping that `lower` and ``launch/serve.py --mapping`` consume.
"""
from repro_torch.api.artifact import SCHEMA_VERSION, MappingArtifact
from repro_torch.api.handle import (ModelHandle, cnn_handle, mlp_handle,
                                    transformer_handle)
from repro_torch.api.pipeline import (ApplyMapping, Discretize, DNASSearch,
                                      Evaluate, Finetune, FinetuneFixed,
                                      PipelineCallback, PipelineResult,
                                      PipelineState, Pretrain,
                                      SearchPipeline, Stage, VerboseCallback,
                                      default_stages, fixed_mapping_stages)
from repro_torch.api.platforms import Platform
from repro_torch.core.engine import SearchConfig, SearchResult
from repro_torch.runtime import ExecutionPlan, LayerPlan, LoweringError, lower

__all__ = [
    "ApplyMapping", "Discretize", "DNASSearch", "Evaluate", "ExecutionPlan",
    "Finetune", "FinetuneFixed", "LayerPlan", "LoweringError",
    "MappingArtifact", "ModelHandle", "Platform", "PipelineCallback",
    "PipelineResult", "PipelineState", "Pretrain", "SCHEMA_VERSION",
    "SearchConfig", "SearchPipeline", "SearchResult", "Stage",
    "VerboseCallback", "cnn_handle", "default_stages",
    "fixed_mapping_stages", "lower", "mlp_handle", "transformer_handle",
]
