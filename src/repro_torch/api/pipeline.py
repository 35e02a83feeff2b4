"""`SearchPipeline`: the ODiMO search as composable stages
(``repro.api.pipeline`` counterpart).

The paper's training flow (Sec. III-B),

    pretrain (fp) -> DNAS search (Eq. 2) -> discretize -> finetune -> evaluate

is a list of stage objects sharing one train step, one eval step and a
mutable `PipelineState`.  ``[ApplyMapping(a), FinetuneFixed(), Evaluate()]``
evaluates a fixed mapping (the baselines).  Callbacks observe stages and
steps; `Discretize` emits a `MappingArtifact`.

The train step is the JAX package's: the loss and its gradient with
respect to every params leaf (``torch.autograd.grad``; a leaf the mode
does not use gets a zero gradient, as in JAX), the alpha gradients scaled
by ``alpha_lr / lr``, then AdamW (`repro_torch.optim.adamw`).  The
pipeline runs on ``device`` (the card unless the caller passes
``device="cpu"``): it initialises the params there from ``seed``, and
params or batches on another device are an error, never a fall-back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.api.artifact import MappingArtifact
from repro_torch.api.handle import ModelHandle
from repro_torch.api.platforms import Platform
from repro_torch.core import engine, losses, odimo
from repro_torch.core import tree as T
from repro_torch.core.baselines import counts_from_assignments
from repro_torch.core.cost_models import CostModel
from repro_torch.core.odimo import ODiMOSpec
from repro_torch.optim import adamw

# Disjoint data-stream offsets of the stages (the JAX package's).
SEARCH_DATA_OFFSET = 10_000
FINETUNE_DATA_OFFSET = 20_000
EVAL_DATA_OFFSET = 90_000

# --------------------------------------------------------------------------
# Callbacks
# --------------------------------------------------------------------------

class PipelineCallback:
    """Observer hooks; override any subset."""

    def on_stage_start(self, stage: "Stage", state: "PipelineState") -> None:
        pass

    def on_stage_end(self, stage: "Stage", state: "PipelineState") -> None:
        pass

    def on_step(self, stage: "Stage", step: int,
                metrics: Dict[str, float]) -> None:
        pass


class VerboseCallback(PipelineCallback):
    """Progress prints every ``every`` steps."""

    def __init__(self, every: int = 100):
        self.every = every

    def on_step(self, stage, step, metrics):
        if step % self.every:
            return
        extra = " ".join(f"{k}={v:.4g}" for k, v in metrics.items()
                         if k != "loss")
        print(f"[{stage.name} {step}] loss={metrics.get('loss', 0.0):.4f}"
              + (f" {extra}" if extra else ""))


# --------------------------------------------------------------------------
# State + context
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PipelineState:
    """Mutable state threaded through the stages."""
    params: Any
    history: Dict[str, list] = dataclasses.field(default_factory=dict)
    assignments: List[np.ndarray] | None = None
    counts: List[np.ndarray] | None = None
    accuracy: float | None = None
    latency: float | None = None
    energy: float | None = None
    artifact: MappingArtifact | None = None


@dataclasses.dataclass
class PipelineContext:
    """Per-run machinery shared by all stages."""
    handle: ModelHandle
    spec: ODiMOSpec
    cost_model: CostModel
    scfg: engine.SearchConfig
    data_fn: Callable[[int, int], Any]
    plan: list
    train_step: Callable
    eval_step: Callable
    apply_fn: Callable
    ocfg: adamw.AdamWConfig
    platform_name: str | None
    callbacks: Sequence[PipelineCallback]
    device: torch.device

    @property
    def geoms(self):
        return [g for (_, g, _) in self.plan]

    @property
    def searchable(self):
        return [s for (_, _, s) in self.plan]

    def emit_step(self, stage, step, metrics):
        for cb in self.callbacks:
            cb.on_step(stage, step, metrics)

    def batch(self, step: int):
        """The data stream's batch ``step``, held to the run's device."""
        x, y = self.data_fn(step, self.scfg.batch)
        _check_device((x, y), self.device, "data_fn batch")
        return x, y


@dataclasses.dataclass
class PipelineResult:
    """Search outcome; superset of `engine.SearchResult`."""
    params: Any
    assignments: List[np.ndarray]
    counts: List[np.ndarray]
    accuracy: float
    latency: float
    energy: float
    history: dict
    artifact: MappingArtifact | None = None


def _check_device(tree, device: torch.device, what: str):
    for leaf in T.leaves(tree):
        if leaf.device.type != device.type:
            raise ValueError(f"{what} holds a tensor on {leaf.device}, but "
                             f"the pipeline runs on {device}")


def _is_alpha(path) -> bool:
    return "alpha" in path


def _grads(loss, params, leaves_req, paths, scale_alpha: float | None):
    """The gradient tree of ``loss`` with respect to ``leaves_req`` (the
    params' leaves): zeros where a leaf is unused, alpha gradients times
    ``scale_alpha`` (None: zeroed)."""
    gs = torch.autograd.grad(loss, leaves_req, allow_unused=True)
    out = []
    for path, leaf, g in zip(paths, leaves_req, gs):
        if g is None:
            g = torch.zeros_like(leaf)
        if _is_alpha(path):
            g = torch.zeros_like(leaf) if scale_alpha is None \
                else g * scale_alpha
        out.append(g)
    return T.unflatten(params, out)


def _traced(params):
    """(params with fresh grad-requiring leaves, those leaves, paths)."""
    pl = T.leaves_with_paths(params)
    req = [leaf.detach().requires_grad_(True) for _, leaf in pl]
    return T.unflatten(params, req), req, [p for p, _ in pl]


# --------------------------------------------------------------------------
# Stages
# --------------------------------------------------------------------------

class Stage:
    name = "stage"

    def run(self, ctx: PipelineContext, state: PipelineState) -> None:
        raise NotImplementedError


@dataclasses.dataclass
class Pretrain(Stage):
    """Phase 1: full-precision task pretraining."""
    steps: int | None = None
    name = "pretrain"

    def run(self, ctx, state):
        scfg = ctx.scfg
        steps = self.steps if self.steps is not None else scfg.pretrain_steps
        opt = adamw.init(state.params, ctx.ocfg)
        hist = state.history.setdefault("pretrain", [])
        for step in range(steps):
            state.params, opt, l, task, _ = ctx.train_step(
                state.params, opt, ctx.batch(step), 1.0, scfg.lr, "fp")
            hist.append(float(l))
            ctx.emit_step(self, step, {"loss": hist[-1]})


@dataclasses.dataclass
class DNASSearch(Stage):
    """Phase 2: DNAS over channel->domain alphas (Eq. 2, tau annealed)."""
    steps: int | None = None
    name = "search"

    def run(self, ctx, state):
        scfg = ctx.scfg
        steps = self.steps if self.steps is not None else scfg.search_steps
        opt = adamw.init(state.params, ctx.ocfg)
        hist = state.history.setdefault("search", [])
        for step in range(steps):
            tau = float(odimo.tau_schedule(step, steps, ctx.spec))
            state.params, opt, l, task, reg = ctx.train_step(
                state.params, opt, ctx.batch(SEARCH_DATA_OFFSET + step),
                tau, scfg.lr, "search")
            l, task, reg = torch.stack([l, task, reg]).tolist()  # one sync
            hist.append((task, reg))
            ctx.emit_step(self, step, {"loss": l, "task": task, "reg": reg,
                                       "tau": tau})


def _layer_scales(layer_dicts) -> list:
    """Schema-v2 per-layer quant scales from the trained ODiMO states (None
    for unmanaged layers): what `repro_torch.runtime.lower` executes
    with."""
    scales = []
    for d in layer_dicts:
        if "odimo" in d:
            entry = {"w_log_scales": [float(v) for v in
                                      d["odimo"]["log_scales"].tolist()]}
            als = d.get("act_log_scale")
            entry["act_log_scale"] = (float(als) if als is not None
                                      else None)
            scales.append(entry)
        else:
            scales.append(None)
    return scales


@dataclasses.dataclass
class Discretize(Stage):
    """Phase 3: argmax assignment per channel + the mapping artifact."""
    name = "discretize"

    def run(self, ctx, state):
        layer_dicts = ctx.handle.layers(state.params)
        assignments = []
        for d, s in zip(layer_dicts, ctx.searchable):
            if s and "odimo" in d:
                a = odimo.assignment(d["odimo"]).cpu().numpy()
            else:
                a = np.zeros(d["w"].shape[-1], dtype=np.int64)  # pinned: 0
            assignments.append(a)
        counts = counts_from_assignments(assignments,
                                         ctx.spec.n_domains)
        state.assignments, state.counts = assignments, counts
        state.artifact = MappingArtifact.from_search(
            ctx.handle.name, ctx.spec, ctx.plan, assignments, counts,
            platform=ctx.platform_name, objective=ctx.scfg.objective,
            lam=ctx.scfg.lam, seed=ctx.scfg.seed,
            scales=_layer_scales(layer_dicts))


@dataclasses.dataclass
class Finetune(Stage):
    """Phase 4: task-loss-only finetuning in exact discretized formats."""
    steps: int | None = None
    lr_scale: float = 0.3
    name = "finetune"

    def run(self, ctx, state):
        scfg = ctx.scfg
        steps = self.steps if self.steps is not None else scfg.finetune_steps
        opt = adamw.init(state.params, ctx.ocfg)
        hist = state.history.setdefault("finetune", [])
        for step in range(steps):
            state.params, opt, l, task, _ = ctx.train_step(
                state.params, opt, ctx.batch(FINETUNE_DATA_OFFSET + step),
                1.0, scfg.lr * self.lr_scale, "finetune")
            hist.append(float(l))
            ctx.emit_step(self, step, {"loss": hist[-1]})


@dataclasses.dataclass
class ApplyMapping(Stage):
    """Inject a FIXED channel->domain mapping (one-hot alphas): the entry
    stage of baseline evaluations (`ModelHandle.with_assignments`)."""
    assignments: Sequence[np.ndarray] = ()
    name = "apply_mapping"

    def run(self, ctx, state):
        assigns = [np.asarray(a, dtype=np.int64) for a in self.assignments]
        state.params = ctx.handle.with_assignments(
            state.params, assigns, ctx.spec.n_domains)
        state.assignments = assigns
        state.counts = counts_from_assignments(assigns, ctx.spec.n_domains)
        state.artifact = MappingArtifact.from_search(
            ctx.handle.name, ctx.spec, ctx.plan, assigns, state.counts,
            platform=ctx.platform_name, objective=ctx.scfg.objective,
            lam=ctx.scfg.lam, seed=ctx.scfg.seed,
            scales=_layer_scales(ctx.handle.layers(state.params)))


@dataclasses.dataclass
class FinetuneFixed(Stage):
    """Train with frozen alphas (a fixed mapping), task loss only."""
    steps: int | None = None
    name = "finetune_fixed"

    def run(self, ctx, state):
        scfg = ctx.scfg
        steps = self.steps if self.steps is not None else (
            scfg.pretrain_steps + scfg.finetune_steps)

        def ft_step(params, opt, batch):
            p, req, paths = _traced(params)
            x, y = batch
            l = losses.cross_entropy(ctx.apply_fn(p, x, "finetune", 1.0), y)
            grads = _grads(l, params, req, paths, None)
            with torch.no_grad():
                params, opt, _ = adamw.update(grads, opt, params, ctx.ocfg,
                                              lr=scfg.lr)
            return params, opt, l.detach()

        opt = adamw.init(state.params, ctx.ocfg)
        hist = state.history.setdefault("finetune_fixed", [])
        for step in range(steps):
            state.params, opt, l = ft_step(state.params, opt,
                                           ctx.batch(step))
            hist.append(float(l))
            ctx.emit_step(self, step, {"loss": hist[-1]})


@dataclasses.dataclass
class Evaluate(Stage):
    """Final accuracy + exact (discretized) latency / energy."""
    name = "evaluate"

    def run(self, ctx, state):
        scfg = ctx.scfg
        accs = [float(ctx.eval_step(state.params,
                                    ctx.batch(EVAL_DATA_OFFSET + b), 1.0,
                                    "finetune"))
                for b in range(scfg.eval_batches)]
        state.accuracy = float(np.mean(accs))
        if state.counts is None:
            raise ValueError("Evaluate needs counts: run Discretize or "
                             "ApplyMapping first")
        state.latency = float(losses.exact_latency(ctx.cost_model, ctx.geoms,
                                                   state.counts))
        state.energy = float(losses.exact_energy(ctx.cost_model, ctx.geoms,
                                                 state.counts))
        if state.artifact is not None:
            state.artifact.metrics.update(accuracy=state.accuracy,
                                          latency=state.latency,
                                          energy=state.energy)


def default_stages() -> List[Stage]:
    """The paper's full flow."""
    return [Pretrain(), DNASSearch(), Discretize(), Finetune(), Evaluate()]


def fixed_mapping_stages(assignments,
                         train_steps: int | None = None) -> List[Stage]:
    """The baseline flow."""
    return [ApplyMapping(assignments), FinetuneFixed(train_steps), Evaluate()]


# --------------------------------------------------------------------------
# Pipeline
# --------------------------------------------------------------------------

class SearchPipeline:
    """Composable ODiMO mapping search over a `ModelHandle`.

    Hardware comes from a registered `Platform` (by name or instance) or
    from an explicit (spec, cost_model) pair; explicit values override the
    platform's.

        pipe = SearchPipeline(cnn_handle(cfg), "diana",
                              config=SearchConfig(lam=5e-7),
                              data_fn=data_fn)          # device="cuda"
        res = pipe.run()          # PipelineResult; res.artifact is JSON-able

    ``data_fn(step, batch) -> (x, labels)`` must give tensors on the
    pipeline's device.

    Stage checkpoints: with ``checkpoint_dir`` set, the params are saved
    (`repro_torch.checkpoint`: atomic, hash-verified) after every
    `Pretrain` stage, the expensive prefix that every lambda point of a
    Pareto sweep shares.  A later pipeline built with
    ``resume_from=checkpoint_dir`` (same handle and stages) restores them
    and restarts at the stage AFTER the checkpointed one (the paper's
    flow: straight at `DNASSearch`), as an uninterrupted run would go on,
    since the stages' data streams are offset-addressed.
    """

    def __init__(self, handle: ModelHandle, platform=None, *,
                 spec: ODiMOSpec | None = None,
                 cost_model: CostModel | None = None,
                 config: engine.SearchConfig | None = None,
                 data_fn: Callable[[int, int], Any],
                 stages: Sequence[Stage] | None = None,
                 callbacks: Sequence[PipelineCallback] = (),
                 checkpoint_dir: str | None = None,
                 resume_from: str | None = None,
                 device="cuda"):
        self.handle = handle
        plat = Platform.get(platform) if platform is not None else None
        self.platform_name = plat.name if plat is not None else None
        if spec is not None:
            self.spec = spec
        elif plat is not None:
            self.spec = plat.spec()
        else:
            self.spec = ODiMOSpec()
        if cost_model is not None:
            self.cost_model = cost_model
        elif plat is not None:
            self.cost_model = plat.cost_model()
        else:
            raise ValueError("SearchPipeline needs a platform or an explicit "
                             "cost_model")
        self.scfg = config if config is not None else engine.SearchConfig()
        self.data_fn = data_fn
        self.stages = list(stages) if stages is not None else default_stages()
        self.callbacks = tuple(callbacks)
        self.checkpoint_dir = checkpoint_dir
        self.resume_from = resume_from
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SearchPipeline(device='cuda') needs a CUDA "
                               "device; pass device='cpu' to run on the CPU")

    @classmethod
    def fixed_mapping(cls, handle, assignments, platform=None, *,
                      train_steps: int | None = None, **kw) -> "SearchPipeline":
        """Pipeline evaluating a FIXED mapping (the baselines)."""
        return cls(handle, platform,
                   stages=fixed_mapping_stages(assignments, train_steps), **kw)

    # ------------------------------------------------------------------

    def _build_context(self) -> PipelineContext:
        scfg, spec = self.scfg, self.spec
        handle = self.handle
        plan = handle.plan()
        apply_fn = lambda p, x, mode, tau: handle.apply(p, x, spec, mode, tau)
        ocfg = adamw.AdamWConfig(lr=scfg.lr)
        loss_fn = engine.make_loss_fn(apply_fn, plan, spec, self.cost_model,
                                      scfg, handle.layers)
        ratio = scfg.alpha_lr / scfg.lr   # alpha's own lr, by its grads

        def train_step(params, opt, batch, tau, lr, mode):
            p, req, paths = _traced(params)
            l, (task, reg) = loss_fn(p, batch, tau, mode)
            grads = _grads(l, params, req, paths, ratio)
            with torch.no_grad():
                params, opt, _ = adamw.update(grads, opt, params, ocfg,
                                              lr=lr)
            reg = reg.detach() if torch.is_tensor(reg) else reg
            return params, opt, l.detach(), task.detach(), reg

        @torch.no_grad()
        def eval_step(params, batch, tau, mode):
            x, y = batch
            logits = apply_fn(params, x, mode=mode, tau=tau)
            return torch.mean((torch.argmax(logits, -1) == y).float())

        return PipelineContext(handle=handle, spec=spec,
                               cost_model=self.cost_model, scfg=scfg,
                               data_fn=self.data_fn, plan=plan,
                               train_step=train_step, eval_step=eval_step,
                               apply_fn=apply_fn, ocfg=ocfg,
                               platform_name=self.platform_name,
                               callbacks=self.callbacks, device=self.device)

    def run(self, init_params=None) -> PipelineResult:
        from repro_torch.checkpoint import checkpoint as ckpt
        ctx = self._build_context()
        if init_params is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.scfg.seed)
            init_params = self.handle.init(gen, self.spec)
        _check_device(init_params, self.device, "init_params")
        stages = list(enumerate(self.stages))
        if self.resume_from is not None:
            step = ckpt.latest_step(self.resume_from)
            if step is None:
                raise FileNotFoundError(
                    f"resume_from={self.resume_from!r}: no committed "
                    f"pipeline checkpoint found")
            extra = ckpt.restore_extra(self.resume_from, step)
            init_params = ckpt.restore(self.resume_from, step, init_params)
            stages = stages[int(extra["stage_index"]) + 1:]
        state = PipelineState(params=init_params)
        for i, stage in stages:
            for cb in self.callbacks:
                cb.on_stage_start(stage, state)
            stage.run(ctx, state)
            if self.checkpoint_dir is not None and \
                    isinstance(stage, Pretrain):
                ckpt.save(self.checkpoint_dir, i + 1, state.params,
                          extra={"stage": stage.name, "stage_index": i})
            for cb in self.callbacks:
                cb.on_stage_end(stage, state)
        return PipelineResult(
            params=state.params,
            assignments=state.assignments if state.assignments is not None
            else [],
            counts=state.counts if state.counts is not None else [],
            accuracy=state.accuracy if state.accuracy is not None else 0.0,
            latency=state.latency if state.latency is not None else 0.0,
            energy=state.energy if state.energy is not None else 0.0,
            history=state.history, artifact=state.artifact)
