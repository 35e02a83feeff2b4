"""Slot-based batch state of the dense continuous-batching engine
(``repro.serving.batch`` counterpart for ``kv_layout="dense"``).

`BatchState` owns the fixed pool of B decode slots: the per-slot sequence
lengths (each slot's KV-cache position), the per-slot last sampled token
and active flags — host-side numpy, handed to the decode step in one
upload per step — plus the device-side cache pool (`transformer.init_cache`
layout).  Retire-predicate inputs (``eos_id``/``max_new``/``n_gen``) are
mirrored into numpy arrays at assignment so the engine's post-decode retire
sweep is one vectorized pass over host data — no per-slot device sync.

Host-side per-slot bookkeeping (the request occupying the slot, its
generated tokens, timing marks) lives in `SlotState`.  Non-greedy sampling
keeps one ``torch.Generator`` per slot (``gens``), the request's own.

The JAX package's paged fields (page tables, chunked-prefill progress,
``PendingPrefill``, ``start_prefill``) come with the paged engine.
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


class BatchState:
    """Fixed B slots of decode state (see module docstring)."""

    def __init__(self, max_batch: int, caches):
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

    # ---- queries ---------------------------------------------------------

    def free_slots(self) -> List[int]:
        """Slots holding no decoding request."""
        return [b for b in range(self.max_batch) if not self.active[b]]

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    def any_active(self) -> bool:
        return bool(self.active.any())

    # ---- transitions -----------------------------------------------------

    def assign(self, slot: int, req: Request, first_token: int,
               t_ready: float, t_first: float, step: int) -> SlotState:
        """Occupy ``slot`` with ``req`` whose prefill produced
        ``first_token``; the slot's cache length is the prompt length (the
        first generated token is not in the cache yet)."""
        if self.active[slot]:
            raise RuntimeError(f"slot {slot} is still active")
        st = SlotState(request=req, tokens=[int(first_token)],
                       t_ready=t_ready, t_first=t_first, admitted_step=step)
        self.slots[slot] = st
        self.lengths[slot] = req.prompt_len
        self.active[slot] = True
        self.last_tok[slot] = int(first_token)
        self.eos_id[slot] = -1 if req.eos_id is None else int(req.eos_id)
        self.max_new[slot] = int(req.max_new_tokens)
        self.n_gen[slot] = 1
        return st

    def retire(self, slot: int) -> SlotState:
        """Free ``slot`` and return its bookkeeping (the engine turns it
        into a `RequestResult`).  The cache pool is left as-is — admission
        overwrites the slot's cache wholesale.  ``lengths`` keeps its value,
        as in the JAX package (up to ``max_len`` after a length-cap
        retirement), so the engine never uses it as an inactive slot's
        write position."""
        st = self.slots[slot]
        if st is None:
            raise RuntimeError(f"slot {slot} is not occupied")
        self.active[slot] = False
        self.slots[slot] = None
        self.eos_id[slot] = -1
        self.n_gen[slot] = 0
        self.gens[slot] = None
        return st
