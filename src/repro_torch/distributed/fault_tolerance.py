"""Fault-tolerance and elasticity logic (``repro.distributed.fault_tolerance``
counterpart; pure Python, the same logic).

  HeartbeatMonitor   per-host liveness with a deadline; flags dead hosts
  StragglerPolicy    EMA of step times; flags outlier steps and recommends
                     escalation after repeated outliers
  ElasticPlan        given the surviving host count, proposes the new mesh
                     shape and whether the checkpoint must be resharded
  TrainSupervisor    around a training loop: checkpoints, restarts from
                     the latest committed step after a (simulated) crash,
                     skips steps with a non-finite gradient norm, and
                     records every event

The serving engine (`repro_torch.serving.engine`) runs both at inference
time: each decode slot is a "host" beating on every committed token, with
the monitor's clock bound to the engine's step counter -- a slot silent for
``heartbeat_steps`` steps (a stuck fault) is quarantined and its request
requeued; StragglerPolicy flags outlier decode steps into
``engine.stats["straggler_events"]``.  Both take an injectable clock,
which is what lets the same logic run on wall-clock or step-clock time.
"""
from __future__ import annotations

import dataclasses
import math
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


@dataclasses.dataclass
class ElasticPlan:
    """Mesh proposal after a membership change: the model axis stays (a
    tensor-parallel re-layout moves weights); the data axis shrinks or
    grows, which only reshards the data-parallel dimension."""
    old_shape: tuple
    new_hosts: int
    chips_per_host: int = 4

    def propose(self) -> tuple:
        chips = self.new_hosts * self.chips_per_host
        model = self.old_shape[-1]
        return (max(1, chips // model), model)

    @property
    def needs_reshard(self) -> bool:
        return self.propose() != tuple(self.old_shape)


class TrainSupervisor:
    """Checkpoint / restart and bad-step skipping around a step function.

    ``step_fn(state, step) -> (state, metrics)``, metrics holding
    ``"grad_norm"``; ``save_fn(step, state)`` and ``restore_fn() -> (step,
    state)`` bind to `repro_torch.checkpoint`.  ``inject_crash_at``
    simulates a node failure (tests)."""

    def __init__(self, step_fn, save_fn, restore_fn, ckpt_every: int = 50,
                 max_bad_steps: int = 5, inject_crash_at: Optional[int] = None):
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.ckpt_every = ckpt_every
        self.max_bad = max_bad_steps
        self.inject_crash_at = inject_crash_at
        self.log: List[dict] = []
        self.straggler = StragglerPolicy()

    def run(self, total_steps: int):
        step, state = self.restore_fn()
        bad = 0
        crashed = False
        while step < total_steps:
            t0 = time.monotonic()
            if self.inject_crash_at is not None and \
                    step == self.inject_crash_at and not crashed:
                crashed = True
                self.log.append({"event": "crash", "step": step})
                step, state = self.restore_fn()   # restart from checkpoint
                continue
            new_state, metrics = self.step_fn(state, step)
            gn = float(metrics.get("grad_norm", 0.0))
            if not math.isfinite(gn):
                bad += 1
                self.log.append({"event": "skip_nonfinite", "step": step})
                if bad > self.max_bad:
                    raise RuntimeError("too many non-finite steps")
                step += 1          # skip the update, keep the old state
                continue
            bad = 0
            state = new_state
            verdict = self.straggler.observe(step, time.monotonic() - t0)
            if verdict != "ok":
                self.log.append({"event": verdict, "step": step})
            step += 1
            if step % self.ckpt_every == 0:
                self.save_fn(step, state)
        self.save_fn(step, state)
        return step, state
