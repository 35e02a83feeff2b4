"""`Engine`: continuous-batching inference over (optionally planned) LMs
(``repro.serving.engine`` counterpart).

One engine owns a fixed pool of ``max_batch`` decode slots and runs the
standard continuous-batching loop (ADMIT -> PREFILL -> DECODE -> RETIRE).
Two KV layouts back the slots, as in the JAX package:

``kv_layout="paged"`` (default) — the block-table layout:
  * KV lives in a SHARED pool of ``num_pages`` fixed-size pages
    (`transformer.init_paged_cache`; row 0 is the trash page that masked
    writes land in).  Each slot maps logical positions to pages through a
    (W,) page-table row; attention gathers the slot's pages into a dense
    view under the per-slot ``q_pos0`` / ``kv_len`` masks.  Peak KV
    memory scales with the tokens in flight, not B x max_len.
  * CHUNKED PREFILL: prompts stream into their pages ``prefill_chunk``
    tokens per engine step (`transformer.prefill_chunk`, one call for all
    prefilling slots at the fixed shape (B, C)), interleaved with the
    decode steps of the other slots.  Admission requires free pages for
    ceil(min(prompt + budget, W * page_size) / page_size) pages, not
    ``prompt_len < max_len``.
  * PREFIX CACHING (`repro_torch.serving.paged.PagePool`): once a prompt's
    pages are written they are registered under exact token-prefix keys; a
    later prompt sharing the prefix maps the SAME pages (a copy-on-write
    copy for a partly covered tail page, `transformer.copy_pages`) and
    prefills only its own suffix.  The device pool stays resident across
    `run` calls, so a repeated trace is served from cache.
  * ROBUSTNESS: under ``Scheduler(policy="deadline")`` a strictly more
    urgent waiting request preempts the least urgent running one
    (retire-and-requeue: its committed tokens are kept and its filled
    pages parked in the prefix cache; it resumes by prefilling prompt +
    committed tokens, which gives the same tokens as an unpreempted run
    under static scales).  ``max_queue_depth`` / ``page_watermark`` /
    ``request_timeout_s`` shed the backlog with a `ShedResult`.
  * FAULT CONTAINMENT: every decode step and every chunk row that
    completes a prompt is screened for non-finite logits on the device:
    such a slot commits nothing, its pages are purged from the prefix
    cache and released, the slot sits out ``quarantine_steps`` steps and
    the request is requeued once with its committed tokens, then shed with
    ``reason="fault"``.  ``injector`` (`repro_torch.serving.faults
    .FaultInjector`) injects faults: a NaN added to a slot's decode logits
    on the device, NaN written into the floating-point KV of a slot's
    page, or a stuck slot, which commits nothing and which the
    `repro_torch.distributed.HeartbeatMonitor` on the engine's step clock
    catches after ``heartbeat_steps`` silent steps; a `StragglerPolicy`
    over decode-step wall times counts ``stats["straggler_events"]``.

MULTI-PLAN SERVING (paged) -- with a `repro_torch.runtime.PlanSet` bound
as ``backend`` (precision variants over ONE params dict):
  * SELF-SPECULATIVE DECODING (``speculate=(draft, target)``): each
    decode round drafts ``draft_k`` greedy tokens per slot with ``k``
    paged decode steps under the ``draft`` variant (a slot at capacity
    holds its token), then verifies them in ONE ``prefill_chunk(...,
    full_logits=True)`` under ``target`` over ``[t0, d1..dk]``, and
    commits the longest agreeing prefix plus the bonus target token,
    applying the retire predicates per token.  Verify rewrites every KV
    position the draft wrote with target numerics, so the committed cache
    is the target-only cache and the tokens are those of target-only
    greedy decoding (static activation scales).  The caches are updated in
    place, so on a recurrent arch (zamba2) the round clones the per-slot
    state before drafting, puts it back before verify, and after the
    commits replays the slots that accepted part of their draft over
    exactly their committed tokens (`_replay`: one more target chunk, only
    in rounds with a partial accept), as the JAX engine's snapshot,
    ``restore_slots`` and ``replay_fn`` do.  Paged-only, greedy-only.
  * SLO ROUTING (``slo_routes={"interactive": "draft", ...}``): a
    request's SLO class picks its variant.  Chunk and decode steps run
    once per active variant group with the other slots masked inactive,
    so their paged KV writes land in the trash page: a request's KV is
    written under its own variant only.  The variant (and the
    ``degraded`` flag) is pinned at a request's first admission and kept
    on every resume.
  * DEGRADATION (``degrade_to=variant, ttft_target_s=...``): a sliding
    p95 over observed TTFTs (``degrade_window``); on a breach NEW
    admissions route to the cheaper variant, and route back once the p95
    falls below ``degrade_recover_frac`` x the target (hysteresis).
    Transitions are in ``degrade_log`` / ``stats["degrade_transitions"]``;
    requests served degraded carry ``RequestResult.degraded``.
  SLO routing and degradation turn the prefix cache off: routed KV
  numerics depend on the variant, so pages cannot be shared across
  requests.

``kv_layout="dense"`` — B slots of ``max_len`` positions each, one ragged
prefill per admission group (`transformer.prefill` with ``lengths=`` into
a fresh ``(kp, max_len)`` cache; the prompt length is bucketed to a
power-of-two multiple of ``prefill_bucket`` and the group size to a power
of two, exactly as in the JAX package), `transformer.scatter_cache`
admission of the group's real rows, and one decode step per engine step
over all B slots.  A prompt group over 2048 tokens prefills through the
chunked (flash) attention.

FRONTEND ARCHS (llama-3.2-vision-11b, seamless-m4t-large-v2): each request
carries its frontend row (``Request.frontend``, held in bfloat16 as the
JAX engine holds it; a missing row raises).  The dense layout passes the
admission group's rows to its prefill, padded with the last row; the paged
one keeps each slot's row in a buffer that every chunk step passes whole,
so the cross memory of every slot is rewritten and seamless's encoder
runs over every slot's rows at each chunk, as in the JAX package.  The
prefix cache is off and speculation refused for them, as there.

With a `repro_torch.runtime.PlannedBackend` or `PlanSet` passed as
``backend``, every forward runs under `_backend.use(backend)`, so each
covered projection executes its planned kernel and engine latency IS
mapped latency.

Each engine step makes one host-to-device upload and one device-to-host
copy (`Engine._upload`, `Engine._download`): a chunk step uploads its
tokens (B, C), fill positions, valid counts and page table packed in one
tensor (`chunk_inputs`); a paged decode step the last tokens, lengths,
active flags and page table (`paged_decode_inputs`); a dense one the last
tokens, write positions and active flags (`decode_inputs`); each step
downloads its tokens (and, paged, its finite-logit flags) in one
``.cpu()``.  A routed step makes one upload and one download per variant
group; a speculative round uploads its inputs once (`spec_inputs`) and
downloads the drafted and verified tokens once.  No ``.item()`` and no
Python branch on a device value, so every step keeps one fixed shape that
a CUDA graph can capture.

Every ValueError of the JAX engine is raised with the same message.  The
JAX engine's ``trace_counts`` (jit retraces) has no counterpart: torch
runs eagerly and traces nothing.

Exactness notes: outputs are token-identical to per-request serving
(padding and masking are exact, in both layouts), provided the bound plan
uses STATIC activation scales; dynamic max-abs activation quantization is
computed over the whole pooled batch (in a chunk step also over the idle
and decoding slots' masked rows) and therefore depends on batch
composition.
"""
from __future__ import annotations

import time
import warnings
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.distributed.fault_tolerance import (HeartbeatMonitor,
                                                     StragglerPolicy)
from repro_torch.models import _backend
from repro_torch.models import transformer as T
from repro_torch.serving.batch import BatchState
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.metrics import RequestResult, ShedResult, percentile
from repro_torch.serving.paged import PagePool
from repro_torch.serving.sampling import (SamplingParams, request_generator,
                                          sample_tokens)
from repro_torch.serving.scheduler import (Request, RequestQueue, Scheduler,
                                           urgency)

EngineResult = Union[RequestResult, ShedResult]

KV_LAYOUTS = ("paged", "dense")

# prefix sharing is only sound when ALL sequence state is page-resident
# (pure attention KV) and per-token compute is batch-composition-free
_PREFIX_SAFE_KINDS = frozenset({"attn", "shared_attn", "mla"})


class Engine:
    """Continuous-batching serving engine (see module docstring).

    Parameters:
      cfg, params   — the LM (`repro_torch.configs` ArchConfig + its
                      weights); the engine runs on the params' device.
      max_batch     — pool size B (concurrent requests).
      max_len       — per-slot sequence capacity: dense slots hold exactly
                      ``max_len`` tokens; paged slots hold ``W * page_size``
                      with W = ceil(max_len / page_size) (requests beyond
                      that retire as "length_cap").  A dense prompt group
                      over 2048 tokens prefills through the chunked
                      attention, which needs ``max_len`` to be a multiple
                      of 1024.
      backend       — optional matmul backend (`PlannedBackend` /
                      `PlanSet`) installed around every forward.
      scheduler     — a `Scheduler` (default: continuous policy).
      prefill_bucket— dense layout: minimum prompt padding; group prompt
                      lengths round up to the next power-of-two multiple of
                      it.
      kv_layout     — "paged" (default) or "dense".
      page_size     — paged: tokens per KV page (16).
      num_pages     — paged: pool capacity (default B * W: the dense
                      layout's worst-case capacity).
      prefill_chunk — paged: prompt tokens per chunked-prefill step
                      (default 2 * page_size).
      prefix_cache  — paged: hash-share prompt pages across requests
                      (switched off for archs where sharing is unsound).
      speculate     — optional ``(draft_variant, target_variant)`` pair of
                      variant names on the bound `PlanSet`: self-
                      speculative decoding (see module docstring).
      draft_k       — tokens drafted per speculative round (default 4).
      slo_routes    — optional ``{slo_class: variant_name}`` map routing
                      each request's SLO class to a plan variant.
      sampling      — optional `SamplingParams`; None = greedy (default).
      max_queue_depth  — shed (``ShedResult(reason="queue_depth")``) the
                         newest visible queued requests beyond this depth.
      page_watermark   — paged: fraction in (0, 1]; when free pages drop
                         below it, shed every visible queued request behind
                         the head of line (``reason="page_watermark"``).
      request_timeout_s— wall-clock budget per request measured from when
                         it became schedulable: queued requests shed
                         (``reason="timeout"``), running requests retire
                         with partial tokens (``finish_reason="timeout"``).
      max_preemptions  — paged: per-request retire-and-requeue cap under
                         the deadline policy.
      degrade_to       — paged: `PlanSet` variant new admissions route to
                         while the TTFT p95 estimate breaches
                         ``ttft_target_s`` (required together; the p95 over
                         the last ``degrade_window`` TTFTs; hysteresis
                         recovery at ``degrade_recover_frac * target``).
      injector         — paged: optional `FaultInjector`.
      quarantine_steps — paged: steps a slot sits out after a detected
                         fault.
      heartbeat_steps  — paged: step-clock deadline of the stuck-slot
                         monitor.
    """

    def __init__(self, cfg, params, *, max_batch: int = 8, max_len: int = 64,
                 backend=None, scheduler: Optional[Scheduler] = None,
                 prefill_bucket: int = 8, kv_layout: str = "paged",
                 page_size: int = 16, num_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = True,
                 speculate: Optional[Tuple[str, str]] = None,
                 draft_k: int = 4,
                 slo_routes: Optional[Dict[str, str]] = None,
                 sampling: Optional[SamplingParams] = None,
                 max_queue_depth: Optional[int] = None,
                 page_watermark: Optional[float] = None,
                 request_timeout_s: Optional[float] = None,
                 max_preemptions: int = 2,
                 degrade_to: Optional[str] = None,
                 ttft_target_s: Optional[float] = None,
                 degrade_window: int = 8,
                 degrade_recover_frac: float = 0.7,
                 injector: Optional[FaultInjector] = None,
                 quarantine_steps: int = 2,
                 heartbeat_steps: int = 32):
        if kv_layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout must be one of {KV_LAYOUTS}, "
                             f"got {kv_layout!r}")
        self.cfg = cfg
        self.params = params
        self.max_batch = int(max_batch)
        self.max_len = int(max_len)
        self.backend = backend
        self.scheduler = scheduler or Scheduler()
        self.prefill_bucket = max(1, int(prefill_bucket))
        self.kv_layout = kv_layout
        self.sampling = sampling
        self.draft_k = int(draft_k)
        self._spec = tuple(speculate) if speculate is not None else None
        self.slo_routes = dict(slo_routes) if slo_routes else None
        self.max_queue_depth = max_queue_depth
        self.page_watermark = page_watermark
        self.request_timeout_s = request_timeout_s
        self.max_preemptions = int(max_preemptions)
        self.degrade_to = degrade_to
        self.injector = injector
        self.quarantine_steps = int(quarantine_steps)
        self.heartbeat_steps = int(heartbeat_steps)
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1, "
                             f"got {max_queue_depth}")
        if page_watermark is not None and not 0.0 < page_watermark <= 1.0:
            raise ValueError(f"page_watermark must be in (0, 1], "
                             f"got {page_watermark}")
        if request_timeout_s is not None and request_timeout_s < 0:
            raise ValueError(f"request_timeout_s must be >= 0, "
                             f"got {request_timeout_s}")
        if (degrade_to is None) != (ttft_target_s is None):
            raise ValueError("degrade_to and ttft_target_s come together: "
                             "the degraded variant needs a TTFT target to "
                             "defend (and vice versa)")
        self._degrade = (_DegradeController(ttft_target_s,
                                            window=degrade_window,
                                            recover_frac=degrade_recover_frac)
                         if degrade_to is not None else None)
        self.degrade_log = self._degrade.transitions if self._degrade else []
        self.device = params["emb"].device
        self.stats: Dict[str, float] = {}
        self._validate_multiplan(cfg, backend, kv_layout, speculate,
                                 sampling, scheduler)

        if kv_layout == "paged":
            self.page_size = int(page_size)
            self.pages_per_slot = -(-self.max_len // self.page_size)
            self.slot_cap = self.pages_per_slot * self.page_size
            self.num_pages = (int(num_pages) if num_pages is not None
                              else self.max_batch * self.pages_per_slot)
            self.prefill_chunk = (int(prefill_chunk) if prefill_chunk
                                  else 2 * self.page_size)
            # degrade_to joins slo_routes here: both make KV numerics
            # variant-dependent, so pages cannot be shared across requests
            self.prefix_cache = bool(prefix_cache) and \
                cfg.moe is None and not cfg.frontend and \
                set(cfg.pattern) <= _PREFIX_SAFE_KINDS and \
                not self.slo_routes and self.degrade_to is None
            self.pool_mgr = PagePool(self.num_pages, self.page_size)
            # the DEVICE page pool persists across run() calls: the
            # allocator's hash index outlives a run, so the pages it can
            # match must stay resident too
            self._paged_caches = None
        else:
            self.slot_cap = self.max_len
            self.prefix_cache = False

        self._kv_axes = T.cache_kv_axes(cfg)
        self._has_recurrent = any(ax.startswith("slot") for ax in
                                  T.tree_leaves(self._kv_axes))
        self._kv_capacity_bytes, self._kv_page_bytes = self._kv_footprint()
        self._req_counter = 0
        # robustness bookkeeping (cleared per run): per-request resume /
        # serving metadata, quarantined slots' release steps, stuck-until
        # markers and the slots whose next decode logits get a NaN
        self._req_meta: Dict[int, dict] = {}
        self._quarantine: Dict[int, int] = {}
        self._stuck: Dict[int, int] = {}
        self._inject_slots: List[int] = []
        self._monitor: Optional[HeartbeatMonitor] = None
        # paged: each slot's frontend row (max_batch, frontend_tokens,
        # d_model), passed to every chunk step
        self._fe_buf: Optional[torch.Tensor] = None

    def _validate_multiplan(self, cfg, backend, kv_layout, speculate,
                            sampling, scheduler):
        """The JAX engine's checks of the multi-plan and robustness
        arguments, in its order and with its messages."""
        variant_names = getattr(backend, "variant_names", None)
        if self._spec is not None:
            if len(self._spec) != 2 or not all(
                    isinstance(v, str) for v in self._spec):
                raise ValueError(
                    f"speculate must be a (draft_variant, target_variant) "
                    f"pair of variant names, got {speculate!r}")
            if kv_layout != "paged":
                raise ValueError(
                    "speculative decoding requires kv_layout='paged': the "
                    "dense layout writes garbage KV at masked slots' live "
                    "positions, so draft/verify masking would corrupt "
                    "co-batched state (paged masked writes hit the trash "
                    "page)")
            if cfg.moe is not None:
                raise ValueError(
                    "speculative decoding is unsupported for MoE archs: "
                    "expert dispatch is batch-composition-dependent, so "
                    "verify logits would not match sequential decoding")
            if cfg.frontend:
                raise ValueError(
                    "speculative decoding is unsupported for frontend "
                    "(cross-attention) archs")
            if sampling is not None:
                raise ValueError(
                    "speculative decoding is greedy-only (its token-"
                    "identity guarantee is an argmax property); drop "
                    "`sampling` or `speculate`")
            if self.slo_routes:
                raise ValueError(
                    "speculate and slo_routes are mutually exclusive: "
                    "speculation pins every slot to the draft/target pair")
            if self.draft_k < 1:
                raise ValueError(f"draft_k must be >= 1, got {self.draft_k}")
            if variant_names is None:
                raise ValueError(
                    "speculate needs a multi-variant PlanSet backend "
                    "(`repro.runtime.PlanSet`); got "
                    f"{type(backend).__name__ if backend is not None else None}")
            for v in self._spec:
                if v not in variant_names:
                    raise ValueError(
                        f"speculate variant {v!r} is not bound: this "
                        f"PlanSet has {list(variant_names)}")
        if self.slo_routes:
            if kv_layout != "paged":
                raise ValueError(
                    "SLO routing requires kv_layout='paged': variant-"
                    "grouped decode masks the other groups' slots, and "
                    "only the paged layout routes masked KV writes to the "
                    "trash page instead of live positions")
            if variant_names is None:
                raise ValueError(
                    "slo_routes needs a multi-variant PlanSet backend "
                    "(`repro.runtime.PlanSet`); got "
                    f"{type(backend).__name__ if backend is not None else None}")
            for cls, v in self.slo_routes.items():
                if v not in variant_names:
                    raise ValueError(
                        f"slo_routes[{cls!r}] -> {v!r} is not bound: this "
                        f"PlanSet has {list(variant_names)}")
        if self.degrade_to is not None:
            if kv_layout != "paged":
                raise ValueError(
                    "precision degradation requires kv_layout='paged' "
                    "(variant-grouped execution masks into the trash page)")
            if variant_names is None:
                raise ValueError(
                    "degrade_to needs a multi-variant PlanSet backend "
                    "(`repro.runtime.PlanSet`); got "
                    f"{type(backend).__name__ if backend is not None else None}")
            if self.degrade_to not in variant_names:
                raise ValueError(
                    f"degrade_to={self.degrade_to!r} is not bound: this "
                    f"PlanSet has {list(variant_names)}")
        if self.injector is not None and kv_layout != "paged":
            raise ValueError(
                "fault injection requires kv_layout='paged' (containment "
                "releases/purges pages and requeues via chunked prefill)")
        if self._spec is not None and (
                self.injector is not None or self.degrade_to is not None
                or (scheduler is not None and scheduler.preempts)):
            raise ValueError(
                "speculate is incompatible with fault injection, precision "
                "degradation, and deadline preemption: a speculative round "
                "commits multiple tokens under a pinned draft/target pair, "
                "which the per-step containment/routing machinery does not "
                "cover")

    # ---- helpers ---------------------------------------------------------

    def _kv_footprint(self):
        """(total sequence-KV bytes of the pool, bytes per page or None):
        the ``"page"`` leaves of `transformer.cache_kv_axes` only (per-slot
        recurrent state is the same in both layouts and left out, so that
        dense and paged peaks compare what paging changes); the paged
        total excludes the trash row."""
        if self.kv_layout == "paged":
            specs = T.paged_cache_specs(self.cfg, self.max_batch,
                                        self.num_pages + 1, self.page_size)
        else:
            specs = T.cache_specs(self.cfg, self.max_batch, self.max_len)
        total = per_page = 0
        for leaf, ax in zip(T.tree_leaves(specs),
                            T.tree_leaves(self._kv_axes)):
            if not ax.startswith("page"):
                continue
            nbytes = leaf.numel() * leaf.element_size()
            total += nbytes
            if self.kv_layout == "paged":
                # bytes of ONE page across all stacked layers
                rows = leaf.shape[1] if ax == "page1" else leaf.shape[0]
                per_page += nbytes // rows
        if self.kv_layout == "paged":
            return per_page * self.num_pages, per_page
        return total, None

    def _bucket(self, n: int) -> int:
        b = self.prefill_bucket
        while b < n:
            b *= 2
        return min(b, self.max_len)

    def _gbucket(self, k: int) -> int:
        """Admission-group size bucket (next power of two), as the JAX
        package's, which bounds its prefill retraces."""
        g = 1
        while g < k:
            g *= 2
        return min(g, self.max_batch)

    def _pages_needed(self, req: Request) -> int:
        total = min(req.prompt_len + req.max_new_tokens, self.slot_cap)
        return self.pool_mgr.pages_for(total)

    def _frontend_row(self, req: Request) -> torch.Tensor:
        """``req``'s frontend row (frontend_tokens, d_model) on the device
        in bfloat16, as the JAX engine holds it (a planned projection then
        returns bfloat16, as JAX's does; an unplanned one promotes to the
        weights' dtype)."""
        if req.frontend is None:
            raise ValueError(
                f"arch {self.cfg.name} needs a per-request cross-attention "
                f"`frontend`, missing on: [{req.rid!r}]")
        row = req.frontend
        if not isinstance(row, torch.Tensor):
            row = torch.from_numpy(np.asarray(row, np.float32))
        return row.to(self.device, torch.bfloat16)

    def _route(self, req: Request) -> Optional[str]:
        """The plan variant serving ``req``: the speculative target (all
        slots), the request's routed SLO class, or the backend default."""
        if self._spec is not None:
            return self._spec[1]
        if self.slo_routes and req.slo is not None:
            return self.slo_routes[req.slo]
        return None

    def _meta(self, req: Request) -> dict:
        """Per-request serving metadata, created at FIRST admission.
        ``variant`` / ``degraded`` are pinned here and reused on every
        resume: a request's KV numerics stay under one variant for its
        whole lifetime.  ``tokens`` / ``t_first`` hold the committed state
        a preempted or faulted request resumes from."""
        meta = self._req_meta.get(id(req))
        if meta is None:
            degraded = self._degrade is not None and self._degrade.active
            meta = {"variant": (self.degrade_to if degraded
                                else self._route(req)),
                    "degraded": degraded, "tokens": [], "t_first": None,
                    "preemptions": 0, "requeues": 0}
            self._req_meta[id(req)] = meta
        return meta

    def _eff_prompt(self, req: Request) -> np.ndarray:
        """The token stream to prefill: the original prompt, plus — for a
        request resuming after preemption/fault-requeue — every committed
        token.  Prefilling that stream reproduces the preempted slot's
        decode state exactly."""
        meta = self._req_meta.get(id(req))
        if meta and meta["tokens"]:
            return np.concatenate(
                [req.prompt, np.asarray(meta["tokens"], np.int32)])
        return req.prompt

    def _next_generator(self) -> Optional[torch.Generator]:
        """The next admitted request's sampling generator (None when the
        engine is greedy)."""
        if self.sampling is None:
            return None
        gen = request_generator(self.sampling.seed, self._req_counter,
                                self.device)
        self._req_counter += 1
        return gen

    def _pick(self, logits, gens) -> torch.Tensor:
        """Greedy argmax, or one sample per row with a generator."""
        if self.sampling is None:
            return torch.argmax(logits, dim=-1)
        return sample_tokens(logits, gens, self.sampling)

    def _upload(self, inputs: np.ndarray) -> torch.Tensor:
        """An engine step's one host-to-device copy."""
        return torch.from_numpy(inputs).to(self.device)

    def _download(self, out: torch.Tensor) -> np.ndarray:
        """An engine step's one device-to-host copy (the step's sync)."""
        return out.cpu().numpy()

    def _validate(self, requests: Sequence[Request]):
        for r in requests:
            if self.slo_routes and r.slo is not None \
                    and r.slo not in self.slo_routes:
                raise ValueError(
                    f"request {r.rid!r}: SLO class {r.slo!r} has no route "
                    f"(routes cover {sorted(self.slo_routes)})")
            if self.kv_layout == "dense":
                if r.prompt_len >= self.max_len:
                    raise ValueError(
                        f"request {r.rid!r}: prompt_len {r.prompt_len} does "
                        f"not fit the engine's max_len {self.max_len} "
                        f"(needs prompt_len < max_len)")
                continue
            need = self._pages_needed(r)
            if r.prompt_len >= self.slot_cap or need > self.num_pages:
                warnings.warn(
                    f"unservable request {r.rid!r}: needs {need} pages "
                    f"({r.prompt_len} prompt + {r.max_new_tokens} new tokens "
                    f"@ page_size {self.page_size}) but the pool caps at "
                    f"{self.num_pages} pages x {self.page_size} tokens "
                    f"(slot capacity {self.slot_cap})")
                raise ValueError(
                    f"request {r.rid!r}: needs {need} pages, pool has "
                    f"{self.num_pages} (slot capacity {self.slot_cap} "
                    f"tokens)")

    def decode_inputs(self, batch: BatchState) -> np.ndarray:
        """The dense decode step's one upload, (3, B) int64: each slot's
        last token, write position and active flag.  An inactive slot
        writes at position 0 (its KV is never read: admission overwrites
        the whole slot), never at its stale length, which may be
        ``max_len``."""
        index = np.where(batch.active, batch.lengths, 0)
        return np.stack([batch.last_tok, index,
                         batch.active]).astype(np.int64)

    def paged_decode_inputs(self, batch: BatchState,
                            active: Optional[np.ndarray] = None,
                            inject: Optional[np.ndarray] = None
                            ) -> np.ndarray:
        """The paged decode step's one upload, (B, 3 + W) int64: each
        slot's last token, length, active flag (``active``: a variant
        group's slots; default every active slot) and page-table row, and
        with ``inject`` one more column, the slots whose logits get a NaN.
        An inactive slot's write goes to the trash page whatever its length
        (``active`` is the write mask)."""
        act = batch.active if active is None else active
        cols = [np.stack([batch.last_tok, batch.lengths, act], 1),
                batch.page_table]
        if inject is not None:
            cols.append(inject[:, None])
        return np.concatenate(cols, axis=1).astype(np.int64)

    def spec_inputs(self, batch: BatchState, vcount: np.ndarray
                    ) -> np.ndarray:
        """A speculative round's one upload, (B, 4 + W) int64: each slot's
        last token, length, active flag, verify count (the chunk's valid
        tokens: ``min(k + 1, capacity - length)``, 0 when inactive) and
        page-table row."""
        return np.concatenate(
            [np.stack([batch.last_tok, batch.lengths, batch.active,
                       vcount], 1), batch.page_table],
            axis=1).astype(np.int64)

    def chunk_inputs(self, batch: BatchState) -> np.ndarray:
        """The chunk step's one upload, (B, C + 2 + W) int64: each slot's
        next (up to) C prompt tokens, left-aligned, its fill position, its
        count of valid tokens (0 for slots that are not prefilling) and
        its page-table row."""
        B, C = self.max_batch, self.prefill_chunk
        tokens = np.zeros((B, C), np.int64)
        valid = np.zeros(B, np.int64)
        for b in np.nonzero(batch.prefilling)[0]:
            prompt = batch.pending[b].prompt
            pos = int(batch.fill_pos[b])
            n = min(C, len(prompt) - pos)
            tokens[b, :n] = prompt[pos:pos + n]
            valid[b] = n
        return np.concatenate([tokens, batch.fill_pos[:, None],
                               valid[:, None], batch.page_table],
                              axis=1).astype(np.int64)

    # ---- retirement (host-side, vectorized) ------------------------------

    def _release_pages(self, batch: BatchState, slot: int):
        self.pool_mgr.release(batch.slot_pages[slot])
        batch.slot_pages[slot] = []
        batch.page_table[slot, :] = 0

    def _retire_slot(self, batch: BatchState, slot: int, reason: str,
                     now: float, step: int,
                     results: Dict[int, EngineResult]):
        st = batch.retire(slot)
        req = st.request
        if self.kv_layout == "paged":
            self._release_pages(batch, slot)
        meta = self._req_meta.get(id(req), {})
        results[id(req)] = RequestResult(
            rid=req.rid, prompt_len=req.prompt_len, tokens=st.tokens,
            finish_reason=reason, ttft_s=st.t_first - st.t_ready,
            finish_s=now - st.t_ready, admitted_step=st.admitted_step,
            finished_step=step, slo=req.slo,
            variant=meta.get("variant"),
            degraded=bool(meta.get("degraded", False)),
            preemptions=int(meta.get("preemptions", 0)),
            requeues=int(meta.get("requeues", 0)))

    def _slot_reason(self, batch: BatchState, slot: int) -> Optional[str]:
        st = batch.slots[slot]
        req = st.request
        if req.eos_id is not None and st.tokens[-1] == req.eos_id:
            return "eos"
        if len(st.tokens) >= req.max_new_tokens:
            return "max_new_tokens"
        if int(batch.lengths[slot]) >= self.slot_cap:
            return "length_cap"   # no room to embed the next token
        return None

    def _maybe_retire(self, batch: BatchState, slot: int, now: float,
                      step: int, results: Dict[int, EngineResult]) -> bool:
        reason = self._slot_reason(batch, slot)
        if reason is None:
            return False
        self._retire_slot(batch, slot, reason, now, step, results)
        return True

    def _postdecode(self, batch: BatchState, tok: np.ndarray, now: float,
                    step: int, results: Dict[int, EngineResult],
                    exclude: Optional[np.ndarray] = None):
        """Record one decode step's tokens and retire finished slots — the
        one host sync happened already (``tok``); every predicate below
        reads host-side numpy mirrors, no per-slot device pulls.
        ``exclude`` masks slots that must NOT commit this step (stuck, or
        their logits were not finite)."""
        act = batch.active
        if exclude is not None:
            act = act & ~exclude
        idx = np.nonzero(act)[0]
        if self._monitor is not None:
            for b in idx:               # a commit is a liveness beat
                self._monitor.beat(int(b))
        batch.last_tok[idx] = tok[idx]
        batch.lengths[idx] += 1
        batch.n_gen[idx] += 1
        eos_hit = act & (batch.eos_id >= 0) & (tok == batch.eos_id)
        budget = act & (batch.n_gen >= batch.max_new)
        cap = act & (batch.lengths >= self.slot_cap)
        for b in idx:
            batch.slots[b].tokens.append(int(tok[b]))
        for b in np.nonzero(eos_hit | budget | cap)[0]:
            reason = ("eos" if eos_hit[b] else
                      "max_new_tokens" if budget[b] else "length_cap")
            self._retire_slot(batch, int(b), reason, now, step, results)

    # ---- dense admission -------------------------------------------------

    def _admit_dense(self, batch: BatchState, admits, step: int,
                     t_ready: Dict[int, float]) -> List[int]:
        """One ragged prefill of the admission group into a fresh cache,
        whose real rows are scattered into their slots.  The group is
        padded to ``kp`` rows by repeating the last request, as in the JAX
        package (same shapes, so the same kernels); the padding rows are
        computed but neither scattered nor read.  A frontend arch's rows
        (`_frontend_row`) are padded the same way."""
        slots = [s for s, _ in admits]
        reqs = [r for _, r in admits]
        k = len(reqs)
        kp = self._gbucket(k)                 # pad the GROUP SIZE too
        P = self._bucket(max(r.prompt_len for r in reqs))
        prompts = np.zeros((kp, P), np.int64)
        lengths = np.zeros(kp, np.int64)
        for i, r in enumerate(reqs):
            prompts[i, :r.prompt_len] = r.prompt
            lengths[i] = r.prompt_len
        prompts[k:] = prompts[k - 1]
        lengths[k:] = lengths[k - 1]
        gens = [self._next_generator() for _ in reqs] + [None] * (kp - k)
        dev = self.device
        frontend = None
        if self.cfg.frontend:
            rows = [self._frontend_row(r) for r in reqs]
            frontend = torch.stack(rows + [rows[-1]] * (kp - k))
        t0 = time.monotonic()
        fresh = T.init_cache(self.cfg, kp, self.max_len, device=dev)
        logits, fresh = T.prefill(self.params, self.cfg,
                                  torch.from_numpy(prompts).to(dev), fresh,
                                  lengths=torch.from_numpy(lengths).to(dev),
                                  cross_source=frontend)
        tok0 = self._pick(logits, gens)
        T.scatter_cache(batch.caches, fresh,
                        torch.tensor(slots, dtype=torch.int64, device=dev))
        del fresh
        tok0 = self._download(tok0)       # sync: first tokens materialized
        t1 = time.monotonic()
        self.stats["prefill_s"] += t1 - t0
        self.stats["prefill_calls"] += 1
        for i, (slot, req) in enumerate(admits):
            batch.assign(slot, req, int(tok0[i]),
                         t_ready=t_ready[id(req)], t_first=t1, step=step)
            batch.gens[slot] = gens[i]
        return slots

    # ---- paged admission + chunked prefill -------------------------------

    def _slot_leaves(self, caches):
        """``[(leaf, slot axis)]``: the per-slot (recurrent) state of
        ``caches``, the ``"slot"`` leaves of `transformer.cache_kv_axes`."""
        return [(leaf, int(ax[4:])) for leaf, ax in
                zip(T.tree_leaves(caches), T.tree_leaves(self._kv_axes))
                if ax.startswith("slot")]

    def _admit_paged(self, batch: BatchState, admits, step: int,
                     t_ready: Dict[int, float]):
        """Map (and with the prefix cache, share) each admitted request's
        pages and zero its slot's recurrent state, which must not leak from
        the slot's previous occupant (resumes included: they prefill their
        committed tokens again).  A frontend arch's row goes into the
        slot's row of the frontend buffer that every chunk step reads."""
        cow_pairs = []
        for slot, req in admits:
            meta = self._meta(req)
            prompt = self._eff_prompt(req)
            if meta["tokens"]:
                self.stats["resumes"] += 1
            need = self._pages_needed(req)
            hit_len, shared, cow_src = (
                self.pool_mgr.match(prompt) if self.prefix_cache
                else (0, [], None))
            pages = shared + self.pool_mgr.alloc(need - len(shared))
            if cow_src is not None:
                cow_pairs.append((cow_src, pages[len(shared)]))
            batch.start_prefill(slot, req, pages, hit_len,
                                t_ready=t_ready[id(req)], step=step,
                                prompt=prompt,
                                prior_tokens=meta["tokens"],
                                t_first=meta["t_first"])
            batch.variant[slot] = meta["variant"]
            batch.gens[slot] = self._next_generator()
            if self.cfg.frontend:
                row = self._frontend_row(req)
                if self._fe_buf is None:
                    self._fe_buf = row.new_zeros((self.max_batch,
                                                  *row.shape))
                self._fe_buf[slot] = row
            for leaf, axis in self._slot_leaves(batch.caches):
                leaf.select(axis, slot).zero_()
        if cow_pairs:
            # copy-on-write before the admitting slots' first chunk
            src, dst = torch.tensor(cow_pairs, dtype=torch.int64).t() \
                .contiguous().to(self.device)
            T.copy_pages(batch.caches, src, dst, self._kv_axes)
            for src, _ in cow_pairs:
                self.pool_mgr.release_cow(src)

    def _register_prompt(self, batch: BatchState, slot: int):
        """Publish a fully prefilled prompt's pages for prefix sharing
        (the EFFECTIVE prompt: resumes include committed tokens)."""
        if not self.prefix_cache:
            return
        prompt = batch.pending[slot].prompt
        pages = batch.slot_pages[slot]
        for key, end in self.pool_mgr.prompt_keys(prompt):
            self.pool_mgr.register(pages[(end - 1) // self.page_size], key)

    def _variant_groups(self, batch: BatchState, sel: np.ndarray):
        """``[(variant, [slots...]), ...]`` grouping ``sel`` by per-slot
        plan variant (deterministic order: default group first)."""
        groups: Dict[Optional[str], List[int]] = {}
        for b in sel:
            groups.setdefault(batch.variant[b], []).append(int(b))
        return sorted(groups.items(),
                      key=lambda kv: (kv[0] is not None, kv[0] or ""))

    def _chunk_step(self, batch: BatchState, step: int,
                    results: Dict[int, EngineResult], queue: RequestQueue,
                    t_ready: Dict[int, float]):
        """Stream the next ``prefill_chunk`` tokens of EVERY prefilling
        slot in one fixed-shape call per plan-variant group (one call when
        nothing is routed; the other groups' rows are masked, so their KV
        writes land in the trash page); slots whose prompt completes get
        their first token from this chunk's logits and join decode (those
        whose logits are not finite go through fault containment).  Only
        completing slots draw a sample: a mid-prompt slot's generator
        does not advance."""
        B, C = self.max_batch, self.prefill_chunk
        sel = np.nonzero(batch.prefilling)[0]
        inputs = self.chunk_inputs(batch)
        valid = inputs[:, C + 1].copy()
        completes = [bool(batch.prefilling[b]) and
                     batch.fill_pos[b] + valid[b] >=
                     len(batch.pending[b].prompt)
                     for b in range(B)]
        t0 = time.monotonic()
        tok = np.zeros(B, np.int64)
        ok = np.ones(B, np.int64)
        for var, group in self._variant_groups(batch, sel):
            member = np.zeros(B, bool)
            member[group] = True
            grp = inputs.copy()
            grp[:, C + 1] = np.where(member, valid, 0)
            gens = [g if done and member[b] else None for b, (g, done) in
                    enumerate(zip(batch.gens, completes))]
            x = self._upload(grp)
            logits, batch.caches = T.prefill_chunk(
                self.params, self.cfg, x[:, :C], batch.caches, x[:, C],
                x[:, C + 1], x[:, C + 2:], variant=var,
                cross_source=self._fe_buf)
            fin = torch.isfinite(logits).all(dim=-1)
            got, fin = self._download(torch.stack([self._pick(logits, gens),
                                                   fin.long()]))
            tok[group], ok[group] = got[group], fin[group]
            self.stats["prefill_calls"] += 1
        t1 = time.monotonic()
        self.stats["prefill_s"] += t1 - t0
        batch.fill_pos[sel] += valid[sel].astype(np.int32)
        batch.lengths[sel] = batch.fill_pos[sel]
        if self._monitor is not None:
            for b in sel:               # chunk progress is a liveness beat
                self._monitor.beat(int(b))
        for b in sel:
            pend = batch.pending[b]
            if not completes[b]:
                continue
            if not ok[b]:
                self._handle_fault(batch, queue, int(b), step, t1, t_ready,
                                   results, purge=True)
                continue
            self._register_prompt(batch, b)
            tf = pend.t_first if pend.t_first is not None else t1
            batch.assign(b, pend.request, int(tok[b]),
                         t_ready=pend.t_ready, t_first=tf,
                         step=pend.admitted_step,
                         prompt_len=len(pend.prompt),
                         prior_tokens=pend.prior_tokens)
            meta = self._req_meta.get(id(pend.request))
            if meta is not None and meta["t_first"] is None:
                meta["t_first"] = tf
                if self._degrade is not None:
                    self._degrade.observe(tf - pend.t_ready)
            self._maybe_retire(batch, int(b), t1, step, results)

    def _decode_paged(self, batch: BatchState, step: int,
                      results: Dict[int, EngineResult], queue: RequestQueue,
                      t_ready: Dict[int, float]):
        """One decode step: one call per active plan-variant group
        (exactly one when nothing is routed), the other groups' slots
        masked inactive -- their paged KV writes land in the trash page --
        and inactive slots draw no sample (a prefilling slot's generator
        does not advance).  Stuck slots (an injected liveness fault) are
        masked out entirely and commit nothing; slots whose logits are not
        finite commit nothing and go through fault containment."""
        B, W = self.max_batch, self.pages_per_slot
        stuck = np.zeros(B, bool)
        for b, until in self._stuck.items():
            if until > step and batch.active[b]:
                stuck[b] = True
        inject = None
        if self.injector is not None:
            inject = np.zeros(B, bool)
            inject[self._inject_slots] = True
            self._inject_slots = []
        t = time.monotonic()
        tok = batch.last_tok.astype(np.int64)
        ok = np.ones(B, np.int64)
        for var, group in self._variant_groups(
                batch, np.nonzero(batch.active & ~stuck)[0]):
            member = np.zeros(B, bool)
            member[group] = True
            gens = [g if m else None for g, m in zip(batch.gens, member)]
            x = self._upload(self.paged_decode_inputs(batch, member, inject))
            logits, batch.caches = T.decode_step(
                self.params, self.cfg, x[:, 0], batch.caches, x[:, 1],
                active=x[:, 2].bool(), pages=x[:, 3:3 + W], variant=var)
            if inject is not None:
                logits = logits + torch.where(
                    x[:, 3 + W] > 0, float("nan"), 0.0)[:, None]
            fin = torch.isfinite(logits).all(dim=-1)
            got, fin = self._download(torch.stack([self._pick(logits, gens),
                                                   fin.long()]))
            tok[group], ok[group] = got[group], fin[group]
        now = time.monotonic()
        self.stats["decode_s"] += now - t
        self.stats["decode_steps"] += 1
        faulted = batch.active & (ok == 0) & ~stuck
        self._postdecode(batch, tok, now, step, results,
                         exclude=stuck | faulted)
        for b in np.nonzero(faulted)[0]:
            if batch.active[b]:     # not retired by _postdecode
                self._handle_fault(batch, queue, int(b), step, now, t_ready,
                                   results, purge=True)

    # ---- self-speculative decoding ---------------------------------------

    def _draft(self, x: torch.Tensor, caches):
        """``k`` greedy paged decode steps under the draft variant from a
        round's inputs (`spec_inputs`); a slot at capacity stops advancing
        and repeats its token (verify's per-slot count ignores those
        rows).  Returns (the drafted tokens (B, k), caches)."""
        W = self.pages_per_slot
        tok, pos = x[:, 0], x[:, 1]
        active, pages = x[:, 2].bool(), x[:, 4:4 + W]
        drafted = []
        for _ in range(self.draft_k):
            live = active & (pos < self.slot_cap)
            logits, caches = T.decode_step(
                self.params, self.cfg, tok, caches, pos, active=live,
                pages=pages, variant=self._spec[0])
            tok = torch.where(live, torch.argmax(logits, dim=-1), tok)
            pos = pos + live.long()
            drafted.append(tok)
        return torch.stack(drafted, 1), caches

    def _verify(self, x: torch.Tensor, drafted: torch.Tensor, caches,
                snap):
        """One fixed-shape chunk of ``[t0, d1..dk]`` under the target
        variant: the full logits give the target's argmax after every
        drafted token, and the chunk's KV writes replace every
        draft-written position with target numerics.  The recurrent state
        the draft advanced is first put back to the round's snapshot
        ``snap`` (the JAX engine's ``restore_slots``).  Returns ((B, k + 1)
        tokens, caches)."""
        W = self.pages_per_slot
        for (leaf, _), saved in zip(self._slot_leaves(caches), snap):
            leaf.copy_(saved)
        tokens = torch.cat([x[:, :1], drafted], dim=1)
        logits, caches = T.prefill_chunk(
            self.params, self.cfg, tokens, caches, x[:, 1], x[:, 3],
            x[:, 4:4 + W], variant=self._spec[1], full_logits=True)
        return torch.argmax(logits, dim=-1), caches

    def _replay(self, x: torch.Tensor, drafted: torch.Tensor, caches, snap,
                valid: np.ndarray):
        """Partial accepts on a recurrent arch: verify left a slot's state
        advanced over all of ``[t0, d1..dk]``, past its committed tokens.
        Rewind the slots with ``valid > 0`` to the round's snapshot and
        run the target over exactly their ``valid`` committed tokens in
        one chunk (the JAX engine's ``replay_fn``); the KV it rewrites is
        the value verify wrote, and the state ends where sequential
        decoding would.  One upload (``valid``).  Returns caches."""
        W = self.pages_per_slot
        v = self._upload(valid.astype(np.int64))
        live = v > 0
        for (leaf, axis), saved in zip(self._slot_leaves(caches), snap):
            shape = [1] * leaf.dim()
            shape[axis] = -1
            leaf.copy_(torch.where(live.view(shape), saved, leaf))
        tokens = torch.cat([x[:, :1], drafted], dim=1)
        _, caches = T.prefill_chunk(
            self.params, self.cfg, tokens, caches, x[:, 1], v,
            x[:, 4:4 + W], variant=self._spec[1])
        return caches

    def _spec_round(self, batch: BatchState, step: int,
                    results: Dict[int, EngineResult]):
        """One speculative round: draft ``k`` tokens per active slot with
        the draft variant, verify all of them in one target-variant chunk,
        and commit the longest agreeing prefix plus the bonus target token,
        applying the per-token retire predicates exactly as sequential
        decoding would; then replay partially accepting slots' recurrent
        state when the arch has any (`_replay`).  One upload, one
        download, and the replay's one upload when it runs."""
        k = self.draft_k
        sel = np.nonzero(batch.active)[0]
        vcount = np.zeros(self.max_batch, np.int64)
        vcount[sel] = np.minimum(k + 1, self.slot_cap - batch.lengths[sel])
        t = time.monotonic()
        x = self._upload(self.spec_inputs(batch, vcount))
        # the caches are updated in place: the recurrent state is cloned
        # before the draft advances it (JAX keeps the immutable arrays)
        snap = [leaf.clone() for leaf, _ in self._slot_leaves(batch.caches)]
        drafted, batch.caches = self._draft(x, batch.caches)
        verified, batch.caches = self._verify(x, drafted, batch.caches,
                                              snap)
        out = self._download(torch.cat([drafted, verified], dim=1))
        d, v = out[:, :k], out[:, k:]
        now = time.monotonic()
        self.stats["decode_s"] += now - t
        self.stats["decode_steps"] += 1
        self.stats["spec_rounds"] += 1
        replay_valid = np.zeros(self.max_batch, np.int64)
        for b in sel:
            vc = int(vcount[b])
            # drafts that could actually commit: the slot's remaining token
            # budget caps the round, so over-drafting past it is not a
            # draft-quality failure and must not dilute the acceptance rate
            budget_left = int(batch.max_new[b] - batch.n_gen[b])
            m = 0                            # agreeing draft prefix
            while m < vc - 1 and d[b, m] == v[b, m]:
                m += 1
            st = batch.slots[b]
            committed = 0
            retired = False
            for j in range(m + 1):           # m matches + 1 bonus token
                tokj = int(v[b, j])
                st.tokens.append(tokj)
                batch.last_tok[b] = tokj
                batch.lengths[b] += 1
                batch.n_gen[b] += 1
                committed += 1
                reason = self._slot_reason(batch, int(b))
                if reason is not None:
                    self._retire_slot(batch, int(b), reason, now, step,
                                      results)
                    retired = True
                    break
            if self._monitor is not None and batch.active[b]:
                self._monitor.beat(int(b))  # a commit is a liveness beat
            self.stats["spec_drafted"] += min(vc - 1, budget_left)
            self.stats["spec_accepted"] += min(committed, m)
            self.stats["spec_committed"] += committed
            if not retired and committed < vc:
                replay_valid[b] = committed
        if self._has_recurrent and replay_valid.any():
            t = time.monotonic()
            batch.caches = self._replay(x, drafted, batch.caches, snap,
                                        replay_valid)
            self.stats["decode_s"] += time.monotonic() - t

    # ---- robustness: preemption, shedding, faults ------------------------

    def _free_slots(self, batch: BatchState, step: int) -> List[int]:
        """Free slots minus the quarantined ones."""
        return [b for b in batch.free_slots()
                if self._quarantine.get(b, 0) <= step]

    def _maybe_preempt(self, batch: BatchState, queue: RequestQueue,
                       t_ready: Dict[int, float], step: int, now: float):
        """Retire-and-requeue at most ONE active slot when a visible
        queued request is strictly more urgent than the least-urgent
        running one and cannot be served from free capacity.  The victim's
        committed tokens are recorded for resumption; with the prefix
        cache on, its filled pages are registered under the resume
        prompt's keys first, so they park in the LRU and resumption
        re-prefills only the unhashed tail."""
        waiting = [r for r in queue if r.arrival_step <= step]
        if not waiting:
            return
        front = min(waiting, key=lambda r: urgency(r, now,
                                                   t_ready.get(id(r))))
        if self._free_slots(batch, step) and \
                self._pages_needed(front) <= self.pool_mgr.available():
            return          # plain admission can serve it this step
        cands = [b for b in range(self.max_batch)
                 if batch.active[b] and not self._stuck.get(b, 0) > step
                 and self._req_meta[id(batch.slots[b].request)]
                 ["preemptions"] < self.max_preemptions]
        if not cands:
            return
        victim = max(cands, key=lambda b: urgency(
            batch.slots[b].request, now,
            t_ready.get(id(batch.slots[b].request))))
        vreq = batch.slots[victim].request
        if not urgency(front, now, t_ready.get(id(front))) < \
                urgency(vreq, now, t_ready.get(id(vreq))):
            return          # nobody waiting beats the least-urgent runner
        st = batch.retire(victim)
        meta = self._req_meta[id(vreq)]
        meta["tokens"] = list(st.tokens)
        meta["t_first"] = st.t_first
        meta["preemptions"] += 1
        if self.prefix_cache:
            # the cache holds resume_prompt[:filled] (the last committed
            # token is not in the cache yet) — publish exactly that
            pages = batch.slot_pages[victim]
            filled = int(batch.lengths[victim])
            resume = self._eff_prompt(vreq)
            for key, end in self.pool_mgr.prompt_keys(resume[:filled]):
                self.pool_mgr.register(pages[(end - 1) // self.page_size],
                                       key)
        self._release_pages(batch, victim)
        queue.push_front(vreq)
        self.stats["preemptions"] += 1

    def _shed(self, req: Request, reason: str, step: int, waited: float,
              results: Dict[int, EngineResult]):
        results[id(req)] = ShedResult(rid=req.rid, reason=reason,
                                      shed_step=step,
                                      waited_s=round(max(waited, 0.0), 6),
                                      slo=req.slo)
        self.stats["shed_requests"] += 1

    def _resumable(self, req: Request) -> bool:
        """Requests holding committed tokens (preempted/faulted, waiting
        to resume) are never backlog-shed — that would discard served
        work.  The wall-clock timeout still applies to them."""
        return bool(self._req_meta.get(id(req), {}).get("tokens"))

    def _timeout_queued(self, queue: RequestQueue,
                        t_ready: Dict[int, float], step: int, now: float,
                        results: Dict[int, EngineResult]):
        """Shed visible queued requests that outlived the wall-clock
        budget (run BEFORE admission: a timed-out request is dead even if
        a slot just freed — the client stopped waiting)."""
        if self.request_timeout_s is None:
            return
        for r in [r for r in queue if r.arrival_step <= step]:
            waited = now - t_ready.get(id(r), now)
            if waited > self.request_timeout_s:
                queue.remove(r)
                self.stats["timeouts"] += 1
                self._shed(r, "timeout", step, waited, results)

    def _shed_backlog(self, queue: RequestQueue,
                      t_ready: Dict[int, float], step: int, now: float,
                      results: Dict[int, EngineResult],
                      free_frac: Optional[float] = None):
        """Bound the POST-admission backlog (run after the step's
        admissions): overflow beyond ``max_queue_depth`` sheds newest
        visible first; below the free-page watermark everything behind
        the head of line sheds (the head keeps its place — head-of-line
        blocking already guarantees it admits as soon as pages free)."""
        if self.max_queue_depth is not None:
            visible = [r for r in queue if r.arrival_step <= step]
            excess = len(visible) - self.max_queue_depth
            for r in reversed(visible):
                if excess <= 0:
                    break
                if self._resumable(r):
                    continue
                queue.remove(r)
                excess -= 1
                self._shed(r, "queue_depth", step,
                           now - t_ready.get(id(r), now), results)
        if self.page_watermark is not None and free_frac is not None \
                and free_frac < self.page_watermark:
            for r in [r for r in queue if r.arrival_step <= step][1:]:
                if self._resumable(r):
                    continue
                queue.remove(r)
                self._shed(r, "page_watermark", step,
                           now - t_ready.get(id(r), now), results)

    def _timeout_running(self, batch: BatchState, step: int, now: float,
                         results: Dict[int, EngineResult]):
        """Retire ACTIVE slots whose request outlived the wall-clock
        budget — they keep their partial tokens, ``finish_reason=
        "timeout"``.  (Prefilling slots complete their bounded prefill
        first and time out on the next sweep.)"""
        if self.request_timeout_s is None:
            return
        for b in range(self.max_batch):
            if batch.active[b] and \
                    now - batch.slots[b].t_ready > self.request_timeout_s:
                self.stats["timeouts"] += 1
                self._retire_slot(batch, b, "timeout", now, step, results)

    def _apply_faults(self, batch: BatchState, step: int):
        """Draw this step's injected faults and arm them: NaN slots for
        the decode inject vector, NaN-stomped KV pages, stuck markers."""
        if self.injector is None:
            return
        occupied = [b for b in range(self.max_batch)
                    if batch.active[b] or batch.prefilling[b]]
        if not occupied:
            return
        for ev in self.injector.draw(step, occupied):
            self.stats["faults_injected"] += 1
            if ev.kind == "nonfinite_logits":
                self._inject_slots.append(ev.slot)
            elif ev.kind == "corrupt_page":
                # corrupt the page holding the slot's newest WRITTEN
                # position -- inside the attention window, so the next step
                # that attends over it detects it
                filled = max(int(batch.lengths[ev.slot]), 1)
                pages = batch.slot_pages[ev.slot]
                page = pages[min((filled - 1) // self.page_size,
                                 len(pages) - 1)]
                self._corrupt_pages(batch.caches, [page])
            elif ev.kind == "stuck":
                self._stuck[ev.slot] = step + ev.duration

    def _corrupt_pages(self, caches, pages: List[int]):
        """Fault injection: NaN over the floating-point KV rows of
        ``pages``, in place (integer KV leaves are left as they are)."""
        idx = torch.tensor(pages, dtype=torch.int64, device=self.device)
        for leaf, ax in zip(T.tree_leaves(caches),
                            T.tree_leaves(self._kv_axes)):
            if leaf.is_floating_point() and ax.startswith("page"):
                leaf.index_fill_(int(ax[4:]), idx, float("nan"))

    def _handle_fault(self, batch: BatchState, queue: RequestQueue,
                      slot: int, step: int, now: float,
                      t_ready: Dict[int, float],
                      results: Dict[int, EngineResult], *, purge: bool):
        """Contain a detected fault on ``slot``: release (and for numeric
        faults PURGE from the prefix cache -- corrupted content must never
        be matched) its pages, quarantine the slot, and requeue the
        request ONCE with its committed tokens; a second fault sheds it
        with ``ShedResult(reason="fault")``."""
        self.stats["faults_detected"] += 1
        if batch.active[slot]:
            st = batch.retire(slot)
            req, tokens, tf = st.request, list(st.tokens), st.t_first
        else:
            pend = batch.pending[slot]
            req, tokens, tf = (pend.request, list(pend.prior_tokens),
                               pend.t_first)
            batch.prefilling[slot] = False
            batch.pending[slot] = None
            batch.fill_pos[slot] = 0
            batch.gens[slot] = None
        if purge:
            self.pool_mgr.purge(batch.slot_pages[slot])
        self._release_pages(batch, slot)
        self._quarantine[slot] = step + self.quarantine_steps
        self._stuck.pop(slot, None)
        meta = self._req_meta[id(req)]
        if meta["requeues"] >= 1:       # requeue-once policy
            self._shed(req, "fault", step,
                       now - t_ready.get(id(req), now), results)
            return
        meta["requeues"] += 1
        meta["tokens"] = tokens         # committed tokens predate the
        meta["t_first"] = tf            # fault: clean, resume from them
        queue.push_front(req)

    # ---- main loops ------------------------------------------------------

    def run(self, requests: Sequence[Request]) -> List[EngineResult]:
        """Serve ``requests`` to completion; returns one result per
        request, in submission order — a `RequestResult` for requests that
        finished, a `ShedResult` for requests the overload/fault paths
        rejected.  Timing aggregates land in ``self.stats``."""
        self._validate(requests)
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0, "decode_steps": 0,
                      "prefill_calls": 0, "wall_s": 0.0,
                      "preemptions": 0, "resumes": 0, "shed_requests": 0,
                      "timeouts": 0, "faults_injected": 0,
                      "faults_detected": 0, "degrade_transitions": 0,
                      "straggler_events": 0, "heartbeat_trips": 0}
        if self._spec is not None:
            self.stats.update({"spec_rounds": 0, "spec_drafted": 0,
                               "spec_accepted": 0, "spec_committed": 0})
        self._req_counter = 0
        self._req_meta = {}
        self._quarantine = {}
        self._stuck = {}
        self._inject_slots = []
        if self._degrade is not None:
            self._degrade.reset()
        queue = RequestQueue()
        for r in requests:
            queue.push(r)
        results: Dict[int, EngineResult] = {}
        t0 = time.monotonic()
        with _backend.use(self.backend):
            if self.kv_layout == "paged":
                self._run_paged(queue, results)
            else:
                self._run_dense(queue, results)
        self.stats["wall_s"] = time.monotonic() - t0
        self.stats["kv_capacity_bytes"] = self._kv_capacity_bytes
        if self._spec is not None:
            drafted = self.stats["spec_drafted"]
            self.stats["spec_acceptance"] = (
                round(self.stats["spec_accepted"] / drafted, 4)
                if drafted else 0.0)
            rounds = self.stats["spec_rounds"]
            self.stats["spec_tokens_per_round"] = (
                round(self.stats["spec_committed"] / rounds, 4)
                if rounds else 0.0)
        if self.kv_layout == "paged":
            ps = self.pool_mgr.stats
            self.stats["kv_peak_pages"] = ps["peak_pages"]
            self.stats["kv_page_bytes"] = self._kv_page_bytes
            self.stats["kv_peak_bytes"] = ps["peak_pages"] * \
                self._kv_page_bytes
            self.stats["prefix_lookups"] = ps["lookups"]
            self.stats["prefix_hit_requests"] = ps["hit_requests"]
            self.stats["prefix_hit_tokens"] = ps["hit_tokens"]
            self.stats["cow_copies"] = ps["cow_copies"]
            self.stats["page_evictions"] = ps["evictions"]
        else:
            # dense pools are fully allocated up front: peak == capacity
            self.stats["kv_peak_bytes"] = self._kv_capacity_bytes
        if self._degrade is not None:
            self.stats["degrade_transitions"] = \
                len(self._degrade.transitions)
        return [results[id(r)] for r in requests]

    def _mark_ready(self, queue: RequestQueue, t_ready: Dict[int, float],
                    step: int, now: float):
        for r in queue:
            if r.arrival_step <= step and id(r) not in t_ready:
                t_ready[id(r)] = now

    def _run_dense(self, queue: RequestQueue,
                   results: Dict[int, EngineResult]):
        batch = BatchState(self.max_batch,
                           T.init_cache(self.cfg, self.max_batch,
                                        self.max_len, device=self.device))
        t_ready: Dict[int, float] = {}
        step = 0
        while len(queue) or batch.any_active():
            # idle + only future arrivals: fast-forward the step clock
            if not batch.any_active() and queue.ready(step) == 0:
                step = max(step, queue.next_arrival())
            now = time.monotonic()
            self._mark_ready(queue, t_ready, step, now)
            self._timeout_queued(queue, t_ready, step, now, results)
            self._timeout_running(batch, step, now, results)
            admits = self.scheduler.admissions(
                queue, batch.free_slots(), batch.n_active, step,
                now=now, t_ready=t_ready)
            for _, req in admits:
                self._meta(req)         # pin variant / degraded at admission
            self._shed_backlog(queue, t_ready, step, now, results)
            if admits:
                for slot in self._admit_dense(batch, admits, step, t_ready):
                    self._maybe_retire(batch, slot, time.monotonic(), step,
                                       results)
            if not batch.any_active():
                continue
            t = time.monotonic()
            x = self._upload(self.decode_inputs(batch))
            logits, batch.caches = T.decode_step(
                self.params, self.cfg, x[0], batch.caches, x[1],
                active=x[2].bool())
            tok = self._download(self._pick(logits, batch.gens))  # sync
            now = time.monotonic()
            self.stats["decode_s"] += now - t
            self.stats["decode_steps"] += 1
            self._postdecode(batch, tok, now, step, results)
            step += 1

    def _run_paged(self, queue: RequestQueue,
                   results: Dict[int, EngineResult]):
        if self._paged_caches is None:
            rows = self.num_pages + 1                  # + trash page 0
            self._paged_caches = T.init_paged_cache(
                self.cfg, self.max_batch, rows, self.page_size,
                device=self.device)
        batch = BatchState(self.max_batch, self._paged_caches,
                           pages_per_slot=self.pages_per_slot)
        self._fe_buf = None
        t_ready: Dict[int, float] = {}
        step = 0
        # the liveness monitor runs on the STEP clock (host keys are slot
        # ids): a slot that commits nothing and makes no prefill progress
        # for heartbeat_steps steps is declared stuck
        step_ref = [0]
        self._monitor = HeartbeatMonitor(
            hosts=list(range(self.max_batch)),
            deadline_s=float(self.heartbeat_steps),
            clock=lambda: float(step_ref[0]))
        straggler = StragglerPolicy()
        while len(queue) or batch.any_busy():
            if not batch.any_busy() and queue.ready(step) == 0:
                step = max(step, queue.next_arrival())
            step_ref[0] = step
            now = time.monotonic()
            self._mark_ready(queue, t_ready, step, now)
            self._timeout_queued(queue, t_ready, step, now, results)
            self._timeout_running(batch, step, now, results)
            if self.scheduler.preempts:
                self._maybe_preempt(batch, queue, t_ready, step, now)
            reserved = [0]

            def fits(req):
                # running reservation: one admission round may pop
                # several requests before any pages are allocated
                need = self._pages_needed(req)
                if reserved[0] + need <= self.pool_mgr.available():
                    reserved[0] += need
                    return True
                return False

            admits = self.scheduler.admissions(
                queue, self._free_slots(batch, step), batch.n_busy, step,
                fits=fits, now=now, t_ready=t_ready)
            for _, req in admits:
                self._meta(req)         # pin variant / degraded at admission
            if admits:
                self._admit_paged(batch, admits, step, t_ready)
            self._shed_backlog(queue, t_ready, step, now, results,
                               free_frac=(self.pool_mgr.available()
                                          / self.num_pages))
            self._apply_faults(batch, step)
            if batch.prefilling.any():
                self._chunk_step(batch, step, results, queue, t_ready)
            if batch.any_active():
                t_step = time.monotonic()
                if self._spec is not None:
                    self._spec_round(batch, step, results)
                else:
                    self._decode_paged(batch, step, results, queue, t_ready)
                if straggler.observe(step, time.monotonic() - t_step) \
                        != "ok":
                    self.stats["straggler_events"] += 1
            # idle slots are not stuck: keep their heartbeats fresh
            for b in range(self.max_batch):
                if not (batch.active[b] or batch.prefilling[b]):
                    self._monitor.beat(b)
            for b in self._monitor.dead_hosts():
                if batch.active[b] or batch.prefilling[b]:
                    self.stats["heartbeat_trips"] += 1
                    self._handle_fault(batch, queue, int(b), step,
                                       time.monotonic(), t_ready, results,
                                       purge=False)
                self._monitor.beat(b)
            if self._degrade is not None:
                self._degrade.update(step)   # _meta reads .active
            step += 1
        self._monitor = None
        self._paged_caches = batch.caches       # keep cached pages resident


class _DegradeController:
    """Hysteresis switch for precision degradation.

    Observes TTFTs as requests get their first token; `update` (once per
    engine step) flips ``active`` ON when the sliding-window p95 breaches
    the target, and OFF once p95 drops below ``recover_frac * target``.
    The window is cleared at each transition so pre-transition samples
    cannot immediately flip it back, and a minimum sample count must
    accumulate again before the next decision -- that is the hysteresis.
    Transitions are recorded as ``(step, "degrade"|"recover", p95_s)``."""

    def __init__(self, target_s: float, window: int = 8,
                 min_samples: int = 4, recover_frac: float = 0.7):
        if target_s <= 0:
            raise ValueError(f"ttft_target_s must be > 0, got {target_s}")
        if not 0.0 < recover_frac <= 1.0:
            raise ValueError(f"degrade_recover_frac must be in (0, 1], "
                             f"got {recover_frac}")
        self.target_s = float(target_s)
        self.min_samples = max(1, min(int(min_samples), int(window)))
        self.recover_frac = float(recover_frac)
        self.samples: deque = deque(maxlen=int(window))
        self.active = False
        self.transitions: List[Tuple[int, str, float]] = []

    def reset(self):
        self.samples.clear()
        self.active = False
        self.transitions.clear()    # in place: Engine.degrade_log aliases

    def observe(self, ttft_s: float):
        self.samples.append(float(ttft_s))

    def update(self, step: int) -> bool:
        if len(self.samples) < self.min_samples:
            return self.active
        p95 = percentile(list(self.samples), 95)
        if not self.active and p95 > self.target_s:
            self.active = True
            self.transitions.append((step, "degrade", round(p95, 6)))
            self.samples.clear()
        elif self.active and p95 < self.recover_frac * self.target_s:
            self.active = False
            self.transitions.append((step, "recover", round(p95, 6)))
            self.samples.clear()
        return self.active
