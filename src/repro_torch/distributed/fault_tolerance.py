"""Liveness and straggler policies (``repro.distributed.fault_tolerance``
counterpart; pure Python, the same logic).

  HeartbeatMonitor   per-host liveness with a deadline; flags dead hosts
  StragglerPolicy    EMA of step times; flags outlier steps and recommends
                     escalation after repeated outliers

The serving engine (`repro_torch.serving.engine`) runs both at inference
time: each decode slot is a "host" beating on every committed token, with
the monitor's clock bound to the engine's step counter -- a slot silent for
``heartbeat_steps`` steps (a stuck fault) is quarantined and its request
requeued; StragglerPolicy flags outlier decode steps into
``engine.stats["straggler_events"]``.  Both take an injectable clock,
which is what lets the same logic run on wall-clock or step-clock time.
The JAX module's ``ElasticPlan`` and ``TrainSupervisor`` (training-time
elasticity) wait for the port of the training loop.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Hashable, List, Optional


class HeartbeatMonitor:
    def __init__(self, hosts: List[Hashable], deadline_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.deadline = deadline_s
        self.clock = clock
        self.last_seen: Dict[Hashable, float] = {h: clock() for h in hosts}

    def beat(self, host: Hashable):
        self.last_seen[host] = self.clock()

    def dead_hosts(self) -> List[Hashable]:
        now = self.clock()
        return [h for h, t in self.last_seen.items()
                if now - t > self.deadline]

    def all_alive(self) -> bool:
        return not self.dead_hosts()


class StragglerPolicy:
    """EMA-based step-time outlier detection.

    A step slower than ``threshold`` x the EMA is a straggler event; after
    ``tolerance`` consecutive events the policy recommends escalation."""

    def __init__(self, threshold: float = 2.0, ema_alpha: float = 0.1,
                 tolerance: int = 3):
        self.threshold = threshold
        self.alpha = ema_alpha
        self.tolerance = tolerance
        self.ema: Optional[float] = None
        self.consecutive = 0
        self.events: List[dict] = []

    def observe(self, step: int, dt: float) -> str:
        """-> 'ok' | 'straggler' | 'escalate'."""
        if self.ema is None:
            self.ema = dt
            return "ok"
        verdict = "ok"
        if dt > self.threshold * self.ema:
            self.consecutive += 1
            verdict = ("escalate" if self.consecutive >= self.tolerance
                       else "straggler")
            self.events.append({"step": step, "dt": dt, "ema": self.ema,
                                "verdict": verdict})
        else:
            self.consecutive = 0
        # stragglers do not poison the EMA
        if verdict == "ok":
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
        return verdict
