"""Seeded fault injection for the serving engine's containment layer
(``repro.serving.faults`` counterpart; numpy only, the same events for the
same spec and seed).

`FaultInjector` reproduces three kinds of fault inside the engine's step
loop, so that detection and containment can be tested and measured:

  * ``"nonfinite_logits"`` -- a NaN is added to the target slot's decode
    logits on the device, inside the step (the engine's inject vector).
    Models a corrupted matmul.
  * ``"corrupt_page"``     -- NaN is written into the floating-point KV
    leaves of one of the slot's resident pages; the damage surfaces on the
    NEXT step through attention.  Models bad memory.  Because pages are
    shared (prefix cache), the corruption may hit OTHER slots too -- each
    sees non-finite logits and is contained the same way.
  * ``"stuck"``            -- the slot is silently excluded from decode for
    ``duration`` steps: it commits nothing, which only the
    `repro_torch.distributed.HeartbeatMonitor` wired into the step loop
    can notice.  Models a wedged slot.

Faults come from an explicit event plan and/or seeded per-step Bernoulli
rates; both are deterministic given the seed.  Detection and recovery
live in `repro_torch.serving.engine`: an isfinite screen over committed
logits, slot quarantine, page purge, and requeue-once (a second fault on
the same request sheds it with ``ShedResult(reason="fault")``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

FAULT_KINDS = ("nonfinite_logits", "corrupt_page", "stuck")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One planned fault: ``kind`` fires at engine ``step`` on ``slot``.

    ``duration`` only matters for ``"stuck"`` (how many steps the slot
    stays silent; detection usually ends it earlier by requeueing the
    request)."""
    kind: str
    step: int
    slot: int
    duration: int = 1_000_000

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"fault kind must be one of {FAULT_KINDS}, "
                             f"got {self.kind!r}")
        if self.step < 0 or self.slot < 0 or self.duration < 1:
            raise ValueError(f"bad fault event: {self!r}")


class FaultInjector:
    """Deterministic fault source for the engine step loop.

    ``events`` is an explicit plan; ``rates`` maps a fault kind to a
    per-step, per-active-slot Bernoulli probability drawn from a seeded
    generator.  ``draw(step, slots)`` returns the faults firing this step
    on currently-occupied slots and logs them in ``fired``."""

    def __init__(self, events: Iterable[FaultEvent] = (),
                 rates: Optional[Dict[str, float]] = None, seed: int = 0):
        self.events: List[FaultEvent] = list(events)
        self.rates = {k: float(v) for k, v in (rates or {}).items()}
        for kind in self.rates:
            if kind not in FAULT_KINDS:
                raise ValueError(f"fault kind must be one of {FAULT_KINDS}, "
                                 f"got {kind!r}")
        self._rng = np.random.default_rng(seed)
        self.fired: List[Tuple[int, int, str]] = []   # (step, slot, kind)

    @staticmethod
    def parse(spec: str, seed: int = 0) -> "FaultInjector":
        """Build an injector from a CLI spec: comma-separated
        ``kind@step:slot[xduration]`` events and/or ``kind~rate`` rates,
        e.g. ``"nonfinite_logits@3:0,stuck@5:1x20,corrupt_page~0.01"``."""
        events, rates = [], {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            if "~" in part:
                kind, rate = part.split("~", 1)
                rates[kind.strip()] = float(rate)
                continue
            try:
                kind, where = part.split("@", 1)
                step_s, slot_s = where.split(":", 1)
                dur = 1_000_000
                if "x" in slot_s:
                    slot_s, dur_s = slot_s.split("x", 1)
                    dur = int(dur_s)
                events.append(FaultEvent(kind.strip(), int(step_s),
                                         int(slot_s), duration=dur))
            except ValueError as e:
                raise ValueError(
                    f"bad fault spec {part!r} (want kind@step:slot[xN] "
                    f"or kind~rate): {e}") from None
        return FaultInjector(events=events, rates=rates, seed=seed)

    def draw(self, step: int, slots: Sequence[int]) -> List[FaultEvent]:
        """Faults firing at ``step`` on any of the occupied ``slots``."""
        slots = list(slots)
        out = [e for e in self.events
               if e.step == step and e.slot in slots]
        for kind in sorted(self.rates):
            rate = self.rates[kind]
            if rate <= 0:
                continue
            for s in slots:
                if self._rng.random() < rate:
                    out.append(FaultEvent(kind, step, s))
        self.fired.extend((e.step, e.slot, e.kind) for e in out)
        return out
