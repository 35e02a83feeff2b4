"""Request queue + slot scheduler of the continuous-batching engine
(``repro.serving.scheduler`` counterpart; numpy only, a copy kept by the
port so that it imports nothing of the JAX package).

`Request` is the unit of work (one prompt, one generation budget); the
`RequestQueue` holds submitted requests in arrival order, optionally gated
by an ``arrival_step`` (trace replay: a request only becomes visible once
the engine's decode-step clock reaches it).  The `Scheduler` decides which
queued requests enter which free slots between decode steps:

  * ``policy="continuous"`` (the engine default) admits ready requests into
    EVERY free slot, every step — slots freed by retired requests are
    refilled immediately while the rest of the batch keeps decoding.  This
    is what makes mixed-length traffic cheap: a short request never holds
    the batch hostage to the longest one.
  * ``policy="static"`` is the classic static-batching baseline: requests
    are admitted in gangs of up to ``max_batch`` and the next gang waits
    until EVERY slot has retired.
  * ``policy="deadline"`` orders admission by urgency instead of arrival:
    higher ``Request.priority`` first, then smallest deadline slack
    (``t_ready + deadline_ms - now``).  Requests without a deadline sort
    last within their priority band (infinite slack).  The paged engine
    may also PREEMPT a running slot under this policy (`Scheduler.preempts`;
    the victim is requeued at the head with `RequestQueue.push_front`); the
    dense engine never preempts, as in the JAX package, so there the policy
    decides the admission order only.

``continuous``/``static`` are FCFS.  The dense engine rejects ``prompt_len
>= max_len`` at submission time.  `admissions` takes an optional
``fits(request)`` callback (the paged engine's page-reservation check) and
blocks head-of-line when the oldest (or, under ``deadline``, the most
urgent) visible request does not fit, so ordering is preserved instead of
starving large requests.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

POLICIES = ("continuous", "static", "deadline")


def _int_like(x) -> bool:
    return isinstance(x, (int, np.integer)) and not isinstance(x, bool)


@dataclasses.dataclass
class Request:
    """One generation request.

    ``prompt`` is a 1-D int32 token array; ``max_new_tokens`` caps the
    generation (the first token — sampled from the prefill logits — counts);
    ``eos_id`` retires the request early when sampled.  ``arrival_step``
    hides the request from the scheduler until the engine's decode-step
    clock reaches it (trace replay).  ``frontend`` optionally carries a
    per-request cross-attention source row (vision/audio archs).  ``slo``
    optionally names the request's SLO class (routed to a plan variant by
    the JAX package's multi-plan engines; carried through to the results
    here).

    ``priority`` and ``deadline_ms`` feed the ``deadline`` scheduler
    policy: larger priority admits first; within a priority band the
    smallest slack (time until ``t_ready + deadline_ms``) wins.  Neither
    affects the FCFS policies."""
    rid: Any
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int] = None
    arrival_step: int = 0
    frontend: Optional[np.ndarray] = None
    slo: Optional[str] = None
    priority: int = 0
    deadline_ms: Optional[float] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, dtype=np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError(f"request {self.rid!r}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid!r}: max_new_tokens must be "
                             f">= 1, got {self.max_new_tokens}")
        if not _int_like(self.arrival_step) or self.arrival_step < 0:
            raise ValueError(f"request {self.rid!r}: arrival_step must be a "
                             f"non-negative int, got {self.arrival_step!r}")
        if self.eos_id is not None and not _int_like(self.eos_id):
            raise ValueError(f"request {self.rid!r}: eos_id must be an int "
                             f"or None, got {self.eos_id!r}")
        if not _int_like(self.priority):
            raise ValueError(f"request {self.rid!r}: priority must be an "
                             f"int, got {self.priority!r}")
        if self.deadline_ms is not None:
            try:
                self.deadline_ms = float(self.deadline_ms)
            except (TypeError, ValueError):
                raise ValueError(
                    f"request {self.rid!r}: deadline_ms must be a finite "
                    f"non-negative number, got {self.deadline_ms!r}") from None
            if math.isnan(self.deadline_ms) or self.deadline_ms < 0:
                raise ValueError(
                    f"request {self.rid!r}: deadline_ms must be a finite "
                    f"non-negative number, got {self.deadline_ms!r}")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)


def urgency(req: Request, now: float,
            t_ready: Optional[float] = None) -> Tuple[int, float]:
    """Sort key for the ``deadline`` policy — smaller = more urgent.

    ``(-priority, slack_s)`` where slack is the time remaining until the
    request's deadline (``t_ready + deadline_ms/1e3 - now``); no deadline
    means infinite slack.  ``t_ready`` is when the request became visible
    (defaults to ``now``, i.e. slack = full deadline)."""
    if req.deadline_ms is None:
        slack = math.inf
    else:
        ready = now if t_ready is None else t_ready
        slack = ready + req.deadline_ms / 1e3 - now
    return (-int(req.priority), slack)


class RequestQueue:
    """FCFS queue with arrival-step visibility."""

    def __init__(self):
        self._q: deque[Request] = deque()

    def push(self, req: Request) -> None:
        self._q.append(req)

    def push_front(self, req: Request) -> None:
        """Requeue at the head (preempted/faulted requests resume first
        among equally-urgent peers instead of going to the back)."""
        self._q.appendleft(req)

    def remove(self, req: Request) -> bool:
        """Drop ``req`` from the queue (identity match); True if found."""
        for i, r in enumerate(self._q):
            if r is req:
                del self._q[i]
                return True
        return False

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self):
        return iter(self._q)

    def ready(self, step: int) -> int:
        """How many queued requests are visible at decode step ``step``."""
        return sum(1 for r in self._q if r.arrival_step <= step)

    def next_arrival(self) -> Optional[int]:
        """Earliest arrival_step still queued (None when empty)."""
        return min((r.arrival_step for r in self._q), default=None)

    def pop_ready(self, step: int, k: int, fits=None,
                  order: Optional[Callable[[Request], Any]] = None,
                  ) -> List[Request]:
        """Up to ``k`` visible requests (non-visible ones keep their
        relative order).  ``fits(request) -> bool`` gates admission on
        resources (free KV pages); the first candidate that does NOT fit
        blocks everything behind it — head-of-line blocking keeps the
        admission order fair instead of starving large requests.

        Without ``order`` candidates are considered FCFS.  With ``order``
        (a sort key: smaller = sooner) visible requests are considered in
        key order (stable, so FCFS breaks ties) — the ``deadline`` policy
        passes `urgency`."""
        if order is None:
            out: List[Request] = []
            rest: deque[Request] = deque()
            blocked = False
            while self._q and len(out) < k:
                r = self._q.popleft()
                if r.arrival_step <= step and not blocked:
                    if fits is None or fits(r):
                        out.append(r)
                        continue
                    blocked = True
                rest.append(r)
            rest.extend(self._q)
            self._q = rest
            return out
        visible = [r for r in self._q if r.arrival_step <= step]
        out = []
        taken: set = set()
        for r in sorted(visible, key=order):  # stable: FCFS breaks ties
            if len(out) >= k:
                break
            if fits is not None and not fits(r):
                break  # most-urgent blocks: don't starve it with cheap work
            out.append(r)
            taken.add(id(r))
        if taken:
            self._q = deque(r for r in self._q if id(r) not in taken)
        return out


class Scheduler:
    """Slot-admission policy over a `RequestQueue` (see module docstring)."""

    def __init__(self, policy: str = "continuous"):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {policy!r}")
        self.policy = policy

    @property
    def preempts(self) -> bool:
        """Whether the engine should consider preemption under this policy."""
        return self.policy == "deadline"

    def admissions(self, queue: RequestQueue, free_slots: List[int],
                   n_active: int, step: int, fits=None,
                   now: float = 0.0,
                   t_ready: Optional[Dict[int, float]] = None,
                   ) -> List[Tuple[int, Request]]:
        """``[(slot, request), ...]`` to admit before the next decode step.
        ``fits`` is forwarded to `RequestQueue.pop_ready` (page-aware
        admission, head-of-line blocking).  ``now``/``t_ready`` (a map of
        ``id(request) -> became-visible time``) only matter under the
        ``deadline`` policy, which sorts candidates by `urgency`."""
        if not free_slots:
            return []
        if self.policy == "static" and n_active > 0:
            return []  # gang scheduling: wait for the whole batch to drain
        order = None
        if self.policy == "deadline":
            tr = t_ready or {}
            order = lambda r: urgency(r, now, tr.get(id(r)))
        reqs = queue.pop_ready(step, len(free_slots), fits=fits, order=order)
        return list(zip(free_slots, reqs))
