"""repro_torch.serving — the continuous-batching inference engine over
planned execution (``repro.serving`` counterpart).

The mapper (`repro_torch.runtime`) answers "which kernel executes each
layer"; this package answers "what latency do real requests see": it
drives the planned kernels under mixed-length traffic and reports
request-level TTFT and tokens/s.

Architecture
    `Engine` (engine.py)        the serving loop over B fixed slots:
                                paged KV (default: a shared page pool,
                                chunked prefill interleaved with decode,
                                prefix caching, deadline preemption, load
                                shedding, fault containment, and over a
                                `repro_torch.runtime.PlanSet` bank
                                self-speculative decoding, SLO routes and
                                precision degradation) or dense (ragged
                                prefill per admission group into ``B x
                                max_len`` slots); one per-slot decode step
                                per engine step; optional `repro_torch
                                .runtime.PlannedBackend` / `PlanSet` so
                                every covered projection runs its mapped
                                kernel.
    `PagePool` (paged.py)       the host-side page allocator: refcounts,
                                the LRU of cached pages, exact-token
                                prefix keys, copy-on-write sources.
    `Scheduler` / `RequestQueue` (scheduler.py)
                                FCFS admission into freed slots between
                                decode steps ("continuous", default),
                                gang-batched ("static", the baseline), or
                                by priority and deadline slack
                                ("deadline").
    `BatchState` (batch.py)     the B slots: per-slot sequence lengths
                                (= KV positions), active flags, last
                                tokens, retire predicate mirrors, sampling
                                generators, page tables and chunked-
                                prefill progress, and the device cache
                                pool.
    `RequestResult` / `summarize` (metrics.py)
                                per-request TTFT + decode tok/s, p50/p95
                                aggregation.
    `SamplingParams` (sampling.py)
                                temperature / top-p sampling with one
                                generator per request; OFF by default.
    traces (trace.py)           JSONL request traces + seeded synthetic
                                mixed-length traffic (the same requests as
                                the JAX package's for the same seed).
    `FaultInjector` (faults.py) seeded fault injection (non-finite logits,
                                corrupt KV pages, stuck slots) for the
                                containment layer; the same events as the
                                JAX package's for the same spec and seed.

Example::

    from repro_torch.serving import Engine, summarize, synthetic_trace
    eng = Engine(cfg, params, max_batch=4, max_len=64, backend=planned)
    results = eng.run(synthetic_trace(16, vocab=cfg.vocab))
    print(summarize(results, eng.stats["wall_s"]))

Exactness
    Per-slot masking is exact: the engine's greedy tokens are identical to
    serving each request alone, provided activation quantization is STATIC
    when a planned backend is bound — dynamic max-abs activation scales
    are computed over the pooled batch and depend on batch composition.
"""
from repro_torch.serving.batch import BatchState, SlotState
from repro_torch.serving.engine import KV_LAYOUTS, Engine, EngineResult
from repro_torch.serving.faults import FAULT_KINDS, FaultEvent, FaultInjector
from repro_torch.serving.metrics import (RequestResult, Result, ShedResult,
                                         percentile, summarize)
from repro_torch.serving.paged import PagePool
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import (POLICIES, Request, RequestQueue,
                                           Scheduler, urgency)
from repro_torch.serving.trace import (load_trace, poisson_arrivals,
                                       save_trace, synthetic_trace)

__all__ = [
    "BatchState", "Engine", "EngineResult", "FAULT_KINDS", "FaultEvent",
    "FaultInjector", "KV_LAYOUTS", "POLICIES", "PagePool", "Request",
    "RequestQueue", "RequestResult", "Result", "SamplingParams",
    "Scheduler", "ShedResult", "SlotState", "load_trace", "percentile",
    "poisson_arrivals", "save_trace", "summarize", "synthetic_trace",
    "urgency",
]
