"""Request traces: JSONL load/save + seeded synthetic mixed-length traffic
(``repro.serving.trace`` counterpart, numpy only: the same seed gives the
same requests in both packages).

Trace format (one JSON object per line)::

    {"id": "r0", "prompt": [3, 17, ...], "max_new_tokens": 12,
     "arrival_step": 0, "eos_id": null}

``prompt`` may be replaced by ``"prompt_len": N`` — the loader then draws N
tokens deterministically from the request id (useful for shipping
shape-only traces); that requires a ``vocab``.  Optional per-request fields
``priority`` (int, higher = more urgent) and ``deadline_ms`` (float) feed
the deadline scheduler and round-trip through `save_trace`/`load_trace`.
`synthetic_trace` builds the mixed-length trace the serve CLI replays
when no file is given; `poisson_arrivals` restamps a trace with
seeded open-loop arrival steps at a given offered load.
"""
from __future__ import annotations

import json
import zlib
from pathlib import Path
from typing import List, Optional

import numpy as np

from repro_torch.serving.scheduler import Request


def synthetic_trace(n: int, *, vocab: int, min_prompt: int = 4,
                    max_prompt: int = 32, min_new: int = 4,
                    max_new: int = 16, seed: int = 0,
                    arrival_every: int = 0, shared_prefix: int = 0,
                    long_every: int = 0,
                    long_prompt: Optional[int] = None,
                    slo_classes: Optional[List[str]] = None,
                    priorities: Optional[List[int]] = None,
                    deadlines_ms: Optional[List[Optional[float]]] = None
                    ) -> List[Request]:
    """``n`` mixed-length requests with deterministic prompts.  With
    ``arrival_every`` > 0, request i only becomes visible at decode step
    ``i * arrival_every`` (a paced open-loop trace); 0 means everything is
    queued up front (closed-loop, the worst case for static batching).

    ``shared_prefix`` > 0 prepends the SAME deterministic
    ``shared_prefix``-token system prefix to every prompt (the prefix-cache
    workload).  ``long_every`` k > 0 makes every k-th request draw a
    ``long_prompt``-token prompt (default ``4 * max_prompt``) — the
    skewed-length workload where a dense B x max_len pool pays the long
    tail for every slot.  ``slo_classes`` tags request i with class
    ``slo_classes[i % len(slo_classes)]`` (round-robin — the SLO-routing
    workload; tags don't consume rng draws).  ``priorities`` /
    ``deadlines_ms`` assign scheduling urgency the same round-robin way
    (the deadline-policy workload).  Defaults leave the token stream
    byte-identical to traces generated before these knobs existed."""
    rng = np.random.default_rng(seed)
    prefix = None
    if shared_prefix > 0:
        # separate stream: the main rng draws are unchanged by the prefix
        prefix = np.random.default_rng(seed + 1_000_003).integers(
            0, vocab, size=shared_prefix).astype(np.int32)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(min_prompt, max_prompt + 1))
        gen = int(rng.integers(min_new, max_new + 1))
        prompt = rng.integers(0, vocab, size=plen).astype(np.int32)
        if long_every and i % long_every == 0:
            lp = long_prompt if long_prompt is not None else 4 * max_prompt
            prompt = np.random.default_rng(seed + 7 * i + 13).integers(
                0, vocab, size=int(lp)).astype(np.int32)
        if prefix is not None:
            prompt = np.concatenate([prefix, prompt])
        reqs.append(Request(
            rid=f"r{i}",
            prompt=prompt,
            max_new_tokens=gen,
            arrival_step=i * arrival_every,
            slo=(slo_classes[i % len(slo_classes)] if slo_classes
                 else None),
            priority=(priorities[i % len(priorities)] if priorities else 0),
            deadline_ms=(deadlines_ms[i % len(deadlines_ms)]
                         if deadlines_ms else None)))
    return reqs


def poisson_arrivals(requests: List[Request], rate: float, *,
                     seed: int = 0) -> List[Request]:
    """Restamp ``requests`` with Poisson-process arrival steps at ``rate``
    requests per engine step (exponential inter-arrival gaps drawn from a
    seeded stream, cumulated and floored to integer steps).  This is the
    open-loop load generator: the offered load is fixed by ``rate``
    regardless of how fast the engine drains, so overload shows up as
    queue growth rather than back-pressured arrivals.  Returns new
    `Request` objects; the inputs are not mutated."""
    if rate <= 0:
        raise ValueError(f"offered load must be > 0 req/step, got {rate}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(scale=1.0 / rate, size=len(requests))
    t = 0.0
    out = []
    for req, gap in zip(requests, gaps):
        t += gap
        out.append(Request(
            rid=req.rid, prompt=req.prompt,
            max_new_tokens=req.max_new_tokens, eos_id=req.eos_id,
            arrival_step=int(t), slo=req.slo, priority=req.priority,
            deadline_ms=req.deadline_ms))
    return out


def load_trace(path, vocab: Optional[int] = None) -> List[Request]:
    """Parse a JSONL trace file (see module docstring).

    Raises ValueError naming ``path:line`` for malformed JSON, non-object
    lines, or entries missing both ``prompt`` and ``prompt_len`` — callers
    (the serve CLI) turn that into a clean exit instead of a traceback."""
    reqs = []
    for ln, line in enumerate(Path(path).read_text().splitlines()):
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"{path}:{ln + 1}: malformed trace line ({e})") from None
        if not isinstance(doc, dict):
            raise ValueError(f"{path}:{ln + 1}: trace line must be a JSON "
                             f"object, got {type(doc).__name__}")
        rid = doc.get("id", f"r{ln}")
        if "prompt" in doc:
            prompt = np.asarray(doc["prompt"], dtype=np.int32)
        elif "prompt_len" in doc:
            if vocab is None:
                raise ValueError(f"{path}:{ln + 1}: shape-only trace entry "
                                 f"(prompt_len) needs a vocab to draw tokens")
            # crc32, not hash(): str hashes are salted per process, which
            # would make "deterministic" prompts differ run to run
            rng = np.random.default_rng(zlib.crc32(str(rid).encode()))
            prompt = rng.integers(0, vocab,
                                  size=int(doc["prompt_len"])).astype(np.int32)
        else:
            raise ValueError(f"{path}:{ln + 1}: trace entry needs 'prompt' "
                             f"or 'prompt_len'")
        try:
            reqs.append(Request(
                rid=rid, prompt=prompt,
                max_new_tokens=int(doc.get("max_new_tokens", 16)),
                eos_id=doc.get("eos_id"),
                arrival_step=int(doc.get("arrival_step", 0)),
                slo=doc.get("slo"),
                priority=int(doc.get("priority", 0)),
                deadline_ms=doc.get("deadline_ms")))
        except (TypeError, ValueError) as e:
            raise ValueError(f"{path}:{ln + 1}: bad trace entry: {e}") \
                from None
    return reqs


def save_trace(path, requests: List[Request]) -> Path:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    lines = []
    for r in requests:
        doc = {"id": r.rid, "prompt": [int(t) for t in r.prompt],
               "max_new_tokens": r.max_new_tokens, "eos_id": r.eos_id,
               "arrival_step": r.arrival_step}
        if r.slo is not None:
            doc["slo"] = r.slo
        if r.priority:
            doc["priority"] = r.priority
        if r.deadline_ms is not None:
            doc["deadline_ms"] = r.deadline_ms
        lines.append(json.dumps(doc))
    p.write_text("\n".join(lines) + "\n")
    return p
