"""Per-request latency/throughput metrics for the serving engine
(``repro.serving.metrics`` counterpart, pure Python).

`RequestResult` is what the engine hands back per finished request: the
generated tokens plus the request-level latency numbers the repo's
"latency" story was missing — TTFT (submission-to-first-token, queueing
included: that is exactly what static batching inflates) and the steady
decode rate.  `ShedResult` is the structured rejection the overload paths
return instead of a result (queue-depth / page-watermark shedding, queued
or running timeouts, double faults) — a run's result list may mix both.
`summarize` aggregates a run into the p50/p95/p99 TTFT + total-throughput
+ shed/degradation-rate record, with the JAX package's keys."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Union


@dataclasses.dataclass
class RequestResult:
    """One finished request."""
    rid: Any
    prompt_len: int
    tokens: List[int]                 # all generated tokens, first included
    finish_reason: str                # "eos" | "max_new_tokens" | "length_cap"
                                      # | "timeout"
    ttft_s: float                     # became-schedulable -> first token
    finish_s: float                   # became-schedulable -> last token
    admitted_step: int
    finished_step: int
    slo: Any = None                   # SLO class tag (None = unrouted)
    variant: Any = None               # PlanSet variant that served the request
    degraded: bool = False            # served by the degrade_to variant
    preemptions: int = 0              # retire-and-requeue round-trips
    requeues: int = 0                 # fault-recovery requeues

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    @property
    def decode_tok_s(self) -> float:
        """Steady decode rate: tokens after the first over post-TTFT time."""
        dt = self.finish_s - self.ttft_s
        return (self.n_tokens - 1) / dt if dt > 0 else 0.0


@dataclasses.dataclass
class ShedResult:
    """One request the engine rejected instead of finishing.

    ``reason`` says which overload/fault path fired:

      * ``"queue_depth"``  — admission queue exceeded ``max_queue_depth``
      * ``"page_watermark"`` — free-page fraction below ``page_watermark``
        with the queue backed up
      * ``"timeout"``      — waited longer than ``request_timeout_s``
        without being admitted (a RUNNING request that times out instead
        retires with partial tokens and ``finish_reason="timeout"``)
      * ``"fault"``        — hit an injected/detected fault more than once
        (requeue-once policy)
    """
    rid: Any
    reason: str
    shed_step: int
    waited_s: float
    slo: Any = None

    @property
    def n_tokens(self) -> int:
        return 0


Result = Union[RequestResult, ShedResult]


def percentile(xs: Sequence[float], p: float) -> float:
    """Nearest-rank percentile (p in [0, 100]); 0.0 on empty input.
    Non-finite samples are dropped (a NaN TTFT must not poison the tail)."""
    xs = [x for x in xs if math.isfinite(x)]
    if not xs:
        return 0.0
    xs = sorted(xs)
    k = min(len(xs) - 1, max(0, int(round(p / 100.0 * (len(xs) - 1)))))
    return float(xs[k])


def summarize(results: List[Result], wall_s: float) -> Dict[str, Any]:
    """Aggregate a run: total token throughput + TTFT/decode-rate tails.

    ``results`` may mix `RequestResult` and `ShedResult`; sheds contribute
    to ``requests``/``shed``/``shed_rate`` but not to the latency tails.
    All aggregates guard empty inputs and zero-duration windows (an
    all-shed run, or a decode window of zero wall time, yields zeros —
    never a ZeroDivisionError or NaN percentile).

    When any result carries an SLO class tag, a ``by_slo`` breakdown is
    added: per-class request count, TTFT p50/p95 and decode-rate p50 — the
    per-class latency record SLO routing is judged by."""
    done = [r for r in results if isinstance(r, RequestResult)]
    shed = [r for r in results if isinstance(r, ShedResult)]
    ttfts = [r.ttft_s for r in done]
    toks = sum(r.n_tokens for r in done)
    n = len(results)
    out = {
        "requests": n,
        "completed": len(done),
        "total_tokens": toks,
        "wall_s": round(wall_s, 4),
        "total_tok_s": round(toks / wall_s, 2) if wall_s > 0 else 0.0,
        "ttft_p50_s": round(percentile(ttfts, 50), 4),
        "ttft_p95_s": round(percentile(ttfts, 95), 4),
        "ttft_p99_s": round(percentile(ttfts, 99), 4),
        "decode_tok_s_p50": round(
            percentile([r.decode_tok_s for r in done], 50), 2),
        "finish_reasons": {
            reason: sum(1 for r in done if r.finish_reason == reason)
            for reason in sorted({r.finish_reason for r in done})},
        "shed": len(shed),
        "shed_rate": round(len(shed) / n, 4) if n else 0.0,
        "preemptions": sum(r.preemptions for r in done),
        "degraded": sum(1 for r in done if r.degraded),
        "degrade_rate": (round(sum(1 for r in done if r.degraded) / len(done),
                               4) if done else 0.0),
    }
    if shed:
        out["shed_reasons"] = {
            reason: sum(1 for r in shed if r.reason == reason)
            for reason in sorted({r.reason for r in shed})}
    classes = sorted(
        {r.slo for r in results if r.slo is not None}, key=str)
    if classes:
        out["by_slo"] = {}
        for cls in classes:
            rs = [r for r in done if r.slo == cls]
            cls_ttfts = [r.ttft_s for r in rs]
            out["by_slo"][cls] = {
                "requests": len(rs),
                "shed": sum(1 for r in shed if r.slo == cls),
                "total_tokens": sum(r.n_tokens for r in rs),
                "ttft_p50_s": round(percentile(cls_ttfts, 50), 4),
                "ttft_p95_s": round(percentile(cls_ttfts, 95), 4),
                "decode_tok_s_p50": round(
                    percentile([r.decode_tok_s for r in rs], 50), 2),
            }
    return out
