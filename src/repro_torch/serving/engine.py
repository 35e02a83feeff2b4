"""`Engine`: continuous-batching inference over (optionally planned) LMs
(``repro.serving.engine`` counterpart for ``kv_layout="dense"``).

One engine owns a fixed pool of ``max_batch`` decode slots and runs the
standard continuous-batching loop (ADMIT -> PREFILL -> DECODE -> RETIRE)
over the DENSE KV layout: B slots of ``max_len`` positions each, one ragged
prefill per admission group (`transformer.prefill` with ``lengths=`` into a
fresh ``(kp, max_len)`` cache; the prompt length is bucketed to a
power-of-two multiple of ``prefill_bucket`` and the group size to a power
of two, exactly as in the JAX package), `transformer.scatter_cache`
admission of the group's real rows, and one decode step per engine step
over all B slots with the per-slot ``(B,)`` cache index.  With a
`repro_torch.runtime.PlannedBackend` passed as ``backend``, every forward
runs under `_backend.use(backend)`, so each covered projection executes
its planned kernel and engine latency IS mapped latency.

The port's default layout is ``"dense"``, the only one it has until the
paged engine lands (ROADMAP.md Queue 1 item 4); the JAX package defaults to
``"paged"``, and its tests show that both layouts give the same tokens.
Arguments that need layers the port does not have yet raise
NotImplementedError naming the roadmap item that brings them:
``kv_layout="paged"``, ``page_size``, ``num_pages``, ``prefill_chunk``,
``prefix_cache`` and ``page_watermark`` (item 4); ``speculate``,
``slo_routes``, ``degrade_to`` and ``injector`` (item 5).  Where the JAX
package raises ValueError for an argument the port takes, the port raises
the same error.  The JAX engine's ``trace_counts`` (jit retraces) has no
counterpart: torch runs eagerly and traces nothing.

One decode step makes one host-to-device upload (the per-slot last token,
write position and active flag, packed in one tensor) and one
device-to-host copy (the step's tokens, the JAX engine's
``np.asarray(tok)``): no ``.item()`` and no Python branch on a device
value, so the step keeps one fixed shape (B slots x ``max_len``) that a
CUDA graph can capture.  An inactive slot writes its (unread) KV at
position 0, never at its stale length: a slot retired at the length cap
keeps ``lengths == max_len``, a position the JAX package's scatter drops
silently and an in-place write would index out of range.

Exactness notes: outputs are token-identical to per-request serving
(padding and masking are exact), provided the bound plan uses STATIC
activation scales; dynamic max-abs activation quantization is computed
over the whole pooled batch and therefore depends on batch composition.
The stats carry the JAX dense run's keys; the counters of paged-only
features (preemptions, resumes, faults, degradation, stragglers,
heartbeats) stay 0.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.models import _backend
from repro_torch.models import transformer as T
from repro_torch.serving.batch import BatchState
from repro_torch.serving.metrics import RequestResult, ShedResult
from repro_torch.serving.sampling import (SamplingParams, request_generator,
                                          sample_tokens)
from repro_torch.serving.scheduler import Request, RequestQueue, Scheduler

EngineResult = Union[RequestResult, ShedResult]

KV_LAYOUTS = ("paged", "dense")

#: the roadmap items that bring the arguments the port does not take yet
PAGED_ITEM = "ROADMAP.md Queue 1 item 4 (the paged engine)"
PLANSET_ITEM = ("ROADMAP.md Queue 1 item 5 (PlanSet and the engine "
                "features on it)")


class Engine:
    """Continuous-batching serving engine, dense KV layout (see module
    docstring).

    Parameters:
      cfg, params   — the LM (`repro_torch.configs` ArchConfig + its
                      weights); the engine runs on the params' device.
      max_batch     — pool size B (concurrent requests).
      max_len       — per-slot sequence capacity (requests beyond it
                      retire as "length_cap").  A prompt group over 2048
                      tokens prefills through the chunked attention, which
                      needs ``max_len`` to be a multiple of 1024.
      backend       — optional matmul backend (`PlannedBackend`) installed
                      around every forward.
      scheduler     — a `Scheduler` (default: continuous policy).
      prefill_bucket— minimum prompt padding; group prompt lengths round up
                      to the next power-of-two multiple of it.
      kv_layout     — "dense" (default); "paged" raises
                      NotImplementedError.
      sampling      — optional `SamplingParams`; None = greedy (default).
      max_queue_depth  — shed (``ShedResult(reason="queue_depth")``) the
                         newest visible queued requests beyond this depth.
      request_timeout_s— wall-clock budget per request measured from when
                         it became schedulable: queued requests shed
                         (``reason="timeout"``), running requests retire
                         with partial tokens (``finish_reason="timeout"``).
      ttft_target_s    — only with ``degrade_to`` (not ported).
    The paged and PlanSet arguments are named in the module docstring.
    """

    def __init__(self, cfg, params, *, max_batch: int = 8, max_len: int = 64,
                 backend=None, scheduler: Optional[Scheduler] = None,
                 prefill_bucket: int = 8, kv_layout: str = "dense",
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 speculate=None, slo_routes=None,
                 sampling: Optional[SamplingParams] = None,
                 max_queue_depth: Optional[int] = None,
                 page_watermark: Optional[float] = None,
                 request_timeout_s: Optional[float] = None,
                 degrade_to: Optional[str] = None,
                 ttft_target_s: Optional[float] = None,
                 injector=None):
        if kv_layout not in KV_LAYOUTS:
            raise ValueError(f"kv_layout must be one of {KV_LAYOUTS}, "
                             f"got {kv_layout!r}")
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
        unported = (
            ("kv_layout='paged'", kv_layout == "paged", PAGED_ITEM),
            ("page_size", page_size is not None, PAGED_ITEM),
            ("num_pages", num_pages is not None, PAGED_ITEM),
            ("prefill_chunk", prefill_chunk is not None, PAGED_ITEM),
            ("prefix_cache", prefix_cache is not None, PAGED_ITEM),
            ("page_watermark", page_watermark is not None, PAGED_ITEM),
            ("speculate", speculate is not None, PLANSET_ITEM),
            ("slo_routes", bool(slo_routes), PLANSET_ITEM),
            ("degrade_to", degrade_to is not None, PLANSET_ITEM),
            ("injector", injector is not None, PLANSET_ITEM))
        for arg, given, item in unported:
            if given:
                raise NotImplementedError(
                    f"Engine({arg}): the port serves the dense KV layout "
                    f"only; this waits for {item}")
        self.cfg = cfg
        self.params = params
        self.max_batch = int(max_batch)
        self.max_len = int(max_len)
        self.slot_cap = self.max_len
        self.backend = backend
        self.scheduler = scheduler or Scheduler()
        self.prefill_bucket = max(1, int(prefill_bucket))
        self.kv_layout = kv_layout
        self.sampling = sampling
        self.max_queue_depth = max_queue_depth
        self.request_timeout_s = request_timeout_s
        self.device = params["emb"].device
        self.stats: Dict[str, float] = {}
        self._kv_capacity_bytes = self._kv_footprint()
        self._req_counter = 0

    # ---- helpers ---------------------------------------------------------

    def _kv_footprint(self) -> int:
        """Bytes of the pool's sequence KV (all of the dense cache)."""
        specs = T.cache_specs(self.cfg, self.max_batch, self.max_len)
        return sum(m.numel() * m.element_size()
                   for unit in specs["units"] for m in unit.values())

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

    def _validate(self, requests: Sequence[Request]):
        for r in requests:
            if r.prompt_len >= self.max_len:
                raise ValueError(
                    f"request {r.rid!r}: prompt_len {r.prompt_len} does "
                    f"not fit the engine's max_len {self.max_len} "
                    f"(needs prompt_len < max_len)")

    def decode_inputs(self, batch: BatchState) -> np.ndarray:
        """The decode step's one upload, (3, B) int64: each slot's last
        token, write position and active flag.  An inactive slot writes at
        position 0 (its KV is never read: admission overwrites the whole
        slot), never at its stale length, which may be ``max_len``."""
        index = np.where(batch.active, batch.lengths, 0)
        return np.stack([batch.last_tok, index,
                         batch.active]).astype(np.int64)

    # ---- retirement (host-side, vectorized) ------------------------------

    def _retire_slot(self, batch: BatchState, slot: int, reason: str,
                     now: float, step: int,
                     results: Dict[int, EngineResult]):
        st = batch.retire(slot)
        req = st.request
        results[id(req)] = RequestResult(
            rid=req.rid, prompt_len=req.prompt_len, tokens=st.tokens,
            finish_reason=reason, ttft_s=st.t_first - st.t_ready,
            finish_s=now - st.t_ready, admitted_step=st.admitted_step,
            finished_step=step, slo=req.slo)

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
                    step: int, results: Dict[int, EngineResult]):
        """Record one decode step's tokens and retire finished slots — the
        one host sync happened already (``tok``); every predicate below
        reads host-side numpy mirrors, no per-slot device pulls."""
        act = batch.active
        idx = np.nonzero(act)[0]
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

    # ---- admission -------------------------------------------------------

    def _admit_dense(self, batch: BatchState, admits, step: int,
                     t_ready: Dict[int, float]) -> List[int]:
        """One ragged prefill of the admission group into a fresh cache,
        whose real rows are scattered into their slots.  The group is
        padded to ``kp`` rows by repeating the last request, as in the JAX
        package (same shapes, so the same kernels); the padding rows are
        computed but neither scattered nor read."""
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
        t0 = time.monotonic()
        fresh = T.init_cache(self.cfg, kp, self.max_len, device=dev)
        logits, fresh = T.prefill(self.params, self.cfg,
                                  torch.from_numpy(prompts).to(dev), fresh,
                                  lengths=torch.from_numpy(lengths).to(dev))
        tok0 = self._pick(logits, gens)
        T.scatter_cache(batch.caches, fresh,
                        torch.tensor(slots, dtype=torch.int64, device=dev))
        del fresh
        tok0 = tok0.cpu().numpy()         # sync: first tokens materialized
        t1 = time.monotonic()
        self.stats["prefill_s"] += t1 - t0
        self.stats["prefill_calls"] += 1
        for i, (slot, req) in enumerate(admits):
            batch.assign(slot, req, int(tok0[i]),
                         t_ready=t_ready[id(req)], t_first=t1, step=step)
            batch.gens[slot] = gens[i]
        return slots

    # ---- overload (queue-level sheds and timeouts) -------------------------

    def _shed(self, req: Request, reason: str, step: int, waited: float,
              results: Dict[int, EngineResult]):
        results[id(req)] = ShedResult(rid=req.rid, reason=reason,
                                      shed_step=step,
                                      waited_s=round(max(waited, 0.0), 6),
                                      slo=req.slo)
        self.stats["shed_requests"] += 1

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
                      results: Dict[int, EngineResult]):
        """Bound the POST-admission backlog (run after the step's
        admissions): overflow beyond ``max_queue_depth`` sheds newest
        visible first."""
        if self.max_queue_depth is None:
            return
        visible = [r for r in queue if r.arrival_step <= step]
        for r in visible[self.max_queue_depth:][::-1]:
            queue.remove(r)
            self._shed(r, "queue_depth", step,
                       now - t_ready.get(id(r), now), results)

    def _timeout_running(self, batch: BatchState, step: int, now: float,
                         results: Dict[int, EngineResult]):
        """Retire ACTIVE slots whose request outlived the wall-clock
        budget — they keep their partial tokens, ``finish_reason=
        "timeout"``."""
        if self.request_timeout_s is None:
            return
        for b in range(self.max_batch):
            if batch.active[b] and \
                    now - batch.slots[b].t_ready > self.request_timeout_s:
                self.stats["timeouts"] += 1
                self._retire_slot(batch, b, "timeout", now, step, results)

    # ---- main loop -------------------------------------------------------

    def run(self, requests: Sequence[Request]) -> List[EngineResult]:
        """Serve ``requests`` to completion; returns one result per
        request, in submission order — a `RequestResult` for requests that
        finished, a `ShedResult` for requests the overload paths rejected.
        Timing aggregates land in ``self.stats``."""
        self._validate(requests)
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0, "decode_steps": 0,
                      "prefill_calls": 0, "wall_s": 0.0,
                      "preemptions": 0, "resumes": 0, "shed_requests": 0,
                      "timeouts": 0, "faults_injected": 0,
                      "faults_detected": 0, "degrade_transitions": 0,
                      "straggler_events": 0, "heartbeat_trips": 0}
        self._req_counter = 0
        queue = RequestQueue()
        for r in requests:
            queue.push(r)
        results: Dict[int, EngineResult] = {}
        t0 = time.monotonic()
        self._run_dense(queue, results)
        self.stats["wall_s"] = time.monotonic() - t0
        self.stats["kv_capacity_bytes"] = self._kv_capacity_bytes
        # dense pools are fully allocated up front: peak == capacity
        self.stats["kv_peak_bytes"] = self._kv_capacity_bytes
        return [results[id(r)] for r in requests]

    def _run_dense(self, queue: RequestQueue,
                   results: Dict[int, EngineResult]):
        dev = self.device
        batch = BatchState(self.max_batch,
                           T.init_cache(self.cfg, self.max_batch,
                                        self.max_len, device=dev))
        t_ready: Dict[int, float] = {}
        step = 0
        with _backend.use(self.backend):
            while len(queue) or batch.any_active():
                # idle + only future arrivals: fast-forward the step clock
                if not batch.any_active() and queue.ready(step) == 0:
                    step = max(step, queue.next_arrival())
                now = time.monotonic()
                for r in queue:
                    if r.arrival_step <= step and id(r) not in t_ready:
                        t_ready[id(r)] = now
                self._timeout_queued(queue, t_ready, step, now, results)
                self._timeout_running(batch, step, now, results)
                admits = self.scheduler.admissions(
                    queue, batch.free_slots(), batch.n_active, step,
                    now=now, t_ready=t_ready)
                self._shed_backlog(queue, t_ready, step, now, results)
                if admits:
                    for slot in self._admit_dense(batch, admits, step,
                                                  t_ready):
                        self._maybe_retire(batch, slot, time.monotonic(),
                                           step, results)
                if not batch.any_active():
                    continue
                t = time.monotonic()
                inputs = torch.from_numpy(self.decode_inputs(batch)).to(dev)
                logits, batch.caches = T.decode_step(
                    self.params, self.cfg, inputs[0], batch.caches,
                    inputs[1], active=inputs[2].bool())
                tok = self._pick(logits, batch.gens).cpu().numpy()  # sync
                now = time.monotonic()
                self.stats["decode_s"] += now - t
                self.stats["decode_steps"] += 1
                self._postdecode(batch, tok, now, step, results)
                step += 1
