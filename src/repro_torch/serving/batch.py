"""Slot-based batch state of the continuous-batching engine
(``repro.serving.batch`` counterpart).

`BatchState` owns the fixed pool of B decode slots: the per-slot sequence
lengths (each slot's KV-cache position), the per-slot last sampled token
and active flags — host-side numpy, handed to each engine step in one
upload — plus the device-side cache pool (the dense
`transformer.init_cache` or the paged `init_paged_cache` layout).

Under the PAGED layout it also carries the per-slot page tables
(``page_table`` (B, W) int32 rows of page-pool indices, 0 = unmapped /
trash) and the chunked-prefill progress: a slot being prefilled is BUSY
(``prefilling``, not eligible for admission) but not yet ACTIVE (not
decoding); ``fill_pos`` counts the prompt tokens already in its pages.
Retire-predicate inputs (``eos_id``/``max_new``/``n_gen``) are mirrored
into numpy arrays at assignment so the engine's post-decode retire sweep
is one vectorized pass over host data — no per-slot device sync.

Host-side per-slot bookkeeping (the request occupying the slot, its
generated tokens, timing marks) lives in `SlotState`.  Non-greedy sampling
keeps one ``torch.Generator`` per slot (``gens``), the request's own; a
multi-plan engine keeps each slot's plan variant (``variant``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.serving.scheduler import Request


@dataclasses.dataclass
class SlotState:
    """Host bookkeeping for one occupied slot."""
    request: Request
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_ready: float = 0.0          # wall time the request became schedulable
    t_first: float = 0.0          # wall time its first token materialized
    admitted_step: int = 0


@dataclasses.dataclass
class PendingPrefill:
    """A request whose prompt is still streaming into its pages.

    ``prompt`` is the EFFECTIVE prompt being prefilled — for a fresh
    request it is ``request.prompt``; for a request resuming after
    preemption/fault-requeue it is the original prompt plus every token
    already committed (``prior_tokens``), whose prefill reproduces the
    exact decode state the slot held when it was retired.  ``t_first``
    preserves the original first-token timestamp across a resume (TTFT is
    a property of the first admission, not the resume)."""
    request: Request
    t_ready: float = 0.0
    admitted_step: int = 0
    prompt: Optional[np.ndarray] = None
    prior_tokens: List[int] = dataclasses.field(default_factory=list)
    t_first: Optional[float] = None


class BatchState:
    """Fixed B slots of decode state (see module docstring).

    ``pages_per_slot`` (W) switches on the paged bookkeeping; dense-layout
    engines leave it None and never touch the page fields."""

    def __init__(self, max_batch: int, caches,
                 pages_per_slot: Optional[int] = None):
        self.max_batch = int(max_batch)
        self.caches = caches                       # device cache pool
        self.lengths = np.zeros(self.max_batch, np.int32)
        self.active = np.zeros(self.max_batch, bool)
        self.last_tok = np.zeros(self.max_batch, np.int32)
        self.slots: List[Optional[SlotState]] = [None] * self.max_batch
        # vectorized-retire inputs, mirrored from the request at assignment
        self.eos_id = np.full(self.max_batch, -1, np.int64)
        self.max_new = np.zeros(self.max_batch, np.int64)
        self.n_gen = np.zeros(self.max_batch, np.int64)
        # per-slot sampling generators (None: greedy engine or free slot)
        self.gens: List[Optional[object]] = [None] * self.max_batch
        # per-slot plan-variant key (SLO routing, degradation and
        # speculation over a PlanSet; None = the backend's default)
        self.variant: List[Optional[str]] = [None] * self.max_batch
        # paged layout: page tables + chunked-prefill progress
        self.pages_per_slot = pages_per_slot
        if pages_per_slot is not None:
            self.page_table = np.zeros((self.max_batch, int(pages_per_slot)),
                                       np.int32)
            self.slot_pages: List[List[int]] = [[] for _ in
                                                range(self.max_batch)]
        self.prefilling = np.zeros(self.max_batch, bool)
        self.fill_pos = np.zeros(self.max_batch, np.int32)
        self.pending: List[Optional[PendingPrefill]] = \
            [None] * self.max_batch

    # ---- queries ---------------------------------------------------------

    def free_slots(self) -> List[int]:
        """Slots holding neither a decoding nor a prefilling request."""
        return [b for b in range(self.max_batch)
                if not (self.active[b] or self.prefilling[b])]

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    @property
    def n_busy(self) -> int:
        """Active + prefilling (what gang scheduling must wait out)."""
        return int((self.active | self.prefilling).sum())

    def any_active(self) -> bool:
        return bool(self.active.any())

    def any_busy(self) -> bool:
        return bool((self.active | self.prefilling).any())

    # ---- transitions -----------------------------------------------------

    def start_prefill(self, slot: int, req: Request, pages: List[int],
                      hit_len: int, t_ready: float, step: int,
                      prompt: Optional[np.ndarray] = None,
                      prior_tokens: Optional[List[int]] = None,
                      t_first: Optional[float] = None) -> None:
        """Begin chunked prefill of ``req`` in ``slot``: map its ``pages``
        into the slot's page table and start streaming the prompt at
        position ``hit_len`` (>0 when a cached prefix was matched — those
        tokens' KV is already resident in the shared pages).  ``prompt``
        overrides the prefilled token stream for preemption/fault resumes
        (original prompt + committed ``prior_tokens``)."""
        if self.active[slot] or self.prefilling[slot]:
            raise RuntimeError(f"slot {slot} is busy")
        self.prefilling[slot] = True
        self.fill_pos[slot] = hit_len
        self.lengths[slot] = hit_len
        self.slot_pages[slot] = list(pages)
        self.page_table[slot, :] = 0
        self.page_table[slot, :len(pages)] = pages
        self.pending[slot] = PendingPrefill(
            request=req, t_ready=t_ready, admitted_step=step,
            prompt=req.prompt if prompt is None else prompt,
            prior_tokens=list(prior_tokens or []), t_first=t_first)

    def assign(self, slot: int, req: Request, first_token: int,
               t_ready: float, t_first: float, step: int,
               prompt_len: Optional[int] = None,
               prior_tokens: Optional[List[int]] = None) -> SlotState:
        """Occupy ``slot`` with ``req`` whose prefill produced
        ``first_token``; the slot's cache length is the prompt length (the
        first generated token is not in the cache yet).  Resumes pass the
        EFFECTIVE ``prompt_len`` (original + committed tokens already in
        the cache) and ``prior_tokens`` so the slot picks up mid-stream:
        the token count, cache position, eos/max-new accounting all
        continue exactly where the preempted slot left off."""
        if self.active[slot]:
            raise RuntimeError(f"slot {slot} is still active")
        toks = list(prior_tokens or []) + [int(first_token)]
        st = SlotState(request=req, tokens=toks,
                       t_ready=t_ready, t_first=t_first, admitted_step=step)
        self.slots[slot] = st
        self.lengths[slot] = (req.prompt_len if prompt_len is None
                              else int(prompt_len))
        self.active[slot] = True
        self.prefilling[slot] = False
        self.pending[slot] = None
        self.last_tok[slot] = int(first_token)
        self.eos_id[slot] = -1 if req.eos_id is None else int(req.eos_id)
        self.max_new[slot] = int(req.max_new_tokens)
        self.n_gen[slot] = len(toks)
        return st

    def retire(self, slot: int) -> SlotState:
        """Free ``slot`` and return its bookkeeping (the engine turns it
        into a `RequestResult`).  The cache pool is left as-is — admission
        overwrites (dense) or remaps (paged) the slot's cache wholesale.
        ``lengths`` keeps its value, as in the JAX package (up to the slot
        capacity after a length-cap retirement), so the dense engine never
        uses it as an inactive slot's write position."""
        st = self.slots[slot]
        if st is None:
            raise RuntimeError(f"slot {slot} is not occupied")
        self.active[slot] = False
        self.slots[slot] = None
        self.eos_id[slot] = -1
        self.n_gen[slot] = 0
        self.gens[slot] = None
        self.variant[slot] = None
        return st
