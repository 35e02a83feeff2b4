"""Serving entry point of the port: fixed-batch prefill + greedy decode
(``repro.launch.serve`` counterpart, without the engine).

With ``--mapping`` serve lowers the mapping artifact onto the model's
weights (`repro_torch.runtime.lower`) and executes every projection the
plan covers through its planned CUDA kernel via the name-keyed matmul
backend (`repro_torch.runtime.PlannedBackend`).  An artifact that fails to
lower or bind exits 2 -- there is no majority-dtype fall-back -- and
``--require-full-coverage`` also exits 2 when any planned layer is left
unbound.  The artifact's activation majority decides the KV-cache dtype
(int8 when the majority domain's activations have at most 8 bits).

Every plan kernel executes on dense layers, so yi-9b serves with full
coverage from an artifact of ``diana`` (quant_matmul + split_ternary),
``gpu_tc_like`` (quant_matmul + split_precision) and ``diana`` emitted with
``bias=("aimc", 1.0)`` (quant_matmul + ternary_matmul); all three ask for
the int8 KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \\
        --requests 4 --prompt-len 128 --gen-len 16 --mapping m.json \\
        --require-full-coverage

``--engine`` replays a mixed-length request trace (``--trace`` JSONL, or a
seeded synthetic trace sized by ``--requests/--prompt-len/--gen-len``)
through the continuous-batching engine (`repro_torch.serving.Engine`,
dense KV layout) and prints one line per request (TTFT, decode tok/s) and
the run summary, as the JAX package's CLI does:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
        --engine --requests 8 --max-batch 4 --poisson 0.5 --mapping m.json

The engine flags of the paged layout and of the multi-plan features raise
NotImplementedError naming the roadmap item that brings them
(`UNPORTED_FLAGS`).  ``serve_batch`` stays the fixed-batch loop until the
paged engine lands.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.configs import base as cfgbase
from repro_torch.models import _backend
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.serving.engine import PAGED_ITEM, PLANSET_ITEM

#: flags of the JAX serve CLI the port does not take yet -> the roadmap
#: item that brings them
UNPORTED_FLAGS = {
    "--page-size": PAGED_ITEM, "--num-pages": PAGED_ITEM,
    "--prefill-chunk": PAGED_ITEM, "--shared-prefix": PAGED_ITEM,
    "--page-watermark": PAGED_ITEM,
    "--speculate": PLANSET_ITEM, "--draft-k": PLANSET_ITEM,
    "--check-spec-parity": PLANSET_ITEM, "--slo-variant": PLANSET_ITEM,
    "--fault-spec": PLANSET_ITEM, "--degrade-to": PLANSET_ITEM,
    "--ttft-target-s": PLANSET_ITEM, "--check-preempt-parity": PLANSET_ITEM,
    "--mapping-fallback": ("ROADMAP.md Queue 3 (no majority-dtype "
                           "fall-back, by choice)"),
}


def plan_mapping_execution(params, artifact):
    """Lower ``artifact`` against ``params`` and bind a planned backend.
    Returns (plan, backend); raises `LoweringError` / `ExecutionError`."""
    from repro_torch.runtime import PlannedBackend, lower
    plan = lower(artifact, params=params)
    return plan, PlannedBackend(plan, params)


def print_plan_coverage(tag, plan, backend):
    """Per-kernel histogram, fall-back reasons and per-layer coverage."""
    hist = " ".join(f"{k}:{v}" for k, v in
                    sorted(plan.kernel_histogram().items()))
    for line in plan.histogram_lines():
        print(f"[{tag}] {line}")
    print(f"[{tag}] per-layer planned execution ({hist}; "
          f"{backend.coverage()})")
    bound = set(backend.bound)
    for lp in plan.layers:
        mark = "*" if lp.name in bound else " "
        note = f"  ({lp.note})" if lp.note else ""
        print(f"[{tag}]  {mark} {lp.name}: {lp.kernel} "
              f"counts={lp.counts}{note}")


def check_coverage(tag, backend, require_full: bool):
    """Exit 2 when ``require_full`` and any planned layer is unbound."""
    if require_full and backend.unbound:
        print(f"[{tag}] ERROR: --require-full-coverage but "
              f"{len(backend.unbound)} planned layers did not bind: "
              f"{backend.unbound}", file=sys.stderr)
        sys.exit(2)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def serve_batch(cfg, params, prompts, gen_len: int, backend=None,
                max_len=None):
    """Greedy generation for same-length ``prompts (B, P)``: one prefill,
    then ``gen_len - 1`` decode steps, in a KV cache of ``max_len`` slots
    (the JAX engine's ``max_len``; default ``P + gen_len``).  Returns
    (tokens (B, gen_len), stats) with ``prefill_s``, ``decode_s``,
    ``tok_per_s`` and the prefill logits (``prefill_logits``, (B, vocab)
    f32).

    A prompt longer than 2048 tokens prefills through the chunked
    attention, which takes prompts of a multiple of 512 tokens in a cache
    of a multiple of 1024 slots.  Any other long prompt is right-padded to
    the next multiple of 512 and prefilled with ``lengths=P``: the padded
    slots are masked by every read and overwritten by the decode steps
    (with dynamic activation scales, the padded rows take part in the
    per-tensor max).  The default cache length of a long prompt is rounded
    up to a multiple of 1024; an explicit ``max_len`` must be one.

    This is the fixed-shape loop that the JAX package's engine-backed
    ``serve_batch`` is token-identical to on a same-length batch."""
    B, P = prompts.shape
    dev = prompts.device
    long = P > T.CHUNKED_ABOVE
    padded = _round_up(P, A.Q_CHUNK) if long else P
    need = max(padded, P + gen_len)
    if max_len is None:
        max_len = _round_up(need, A.K_CHUNK) if long else need
    max_len = int(max_len)
    if max_len < need:
        raise ValueError(f"max_len {max_len} < prompt {P} (padded to "
                         f"{padded}) + gen_len {gen_len}")
    lengths = None
    if padded > P:
        prompts = torch.nn.functional.pad(prompts, (0, padded - P))
        lengths = torch.full((B,), P, dtype=torch.long, device=dev)
    caches = T.init_cache(cfg, B, max_len, device=dev)
    with _backend.use(backend):
        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = T.prefill(params, cfg, prompts, caches,
                                   lengths=lengths)
        tok = torch.argmax(logits, -1)
        _sync(dev)
        t1 = time.perf_counter()
        out = [tok]
        for i in range(gen_len - 1):
            step_logits, caches = T.decode_step(params, cfg, tok, caches,
                                                P + i)
            tok = torch.argmax(step_logits, -1)
            out.append(tok)
        _sync(dev)
        t2 = time.perf_counter()
    decode_s = t2 - t1
    return torch.stack(out, dim=1), {
        "prefill_s": t1 - t0, "decode_s": decode_s,
        "tok_per_s": B * (gen_len - 1) / max(decode_s, 1e-9),
        "prefill_logits": logits}


def kv_cache_for(cfg, art):
    """The KV-cache dtype the artifact's activation majority asks for."""
    fractions = art.domain_channel_fractions(searchable_only=True)
    dom = art.domains[int(np.argmax(fractions))]
    if dom.get("act_bits", 16) <= 8:
        return dataclasses.replace(cfg, kv_cache_dtype="int8")
    return cfg


def serve_engine(args, cfg, params, backend=None):
    """``--engine``: replay a mixed-length request trace through the
    continuous-batching engine and report per-request latency (TTFT,
    decode tok/s) + the run summary.  The trace comes from ``--trace``
    (JSONL, see `repro_torch.serving.trace`) or a seeded synthetic trace
    sized by ``--requests/--prompt-len/--gen-len`` (the JAX package's
    trace for the same seed).  Returns (results, summary)."""
    from repro_torch.serving import (Engine, SamplingParams, Scheduler,
                                     ShedResult, load_trace,
                                     poisson_arrivals, summarize,
                                     synthetic_trace)
    sampling = None
    if args.temperature is not None or args.top_p < 1.0:
        sampling = SamplingParams(
            temperature=(args.temperature if args.temperature is not None
                         else 1.0),
            top_p=args.top_p, seed=args.seed)
    if args.trace:
        try:
            trace = load_trace(args.trace, vocab=cfg.vocab)
        except FileNotFoundError:
            print(f"[serve] ERROR: trace file not found: {args.trace}",
                  file=sys.stderr)
            sys.exit(2)
        except (ValueError, OSError) as e:
            print(f"[serve] ERROR: bad trace: {e}", file=sys.stderr)
            sys.exit(2)
        print(f"[serve] trace {args.trace}: {len(trace)} requests")
    else:
        priorities = ([int(p) for p in args.priorities.split(",")]
                      if args.priorities else None)
        deadlines = ([None if d in ("", "none") else float(d)
                      for d in args.deadlines_ms.split(",")]
                     if args.deadlines_ms else None)
        trace = synthetic_trace(
            args.requests, vocab=cfg.vocab,
            min_prompt=max(2, args.prompt_len // 4),
            max_prompt=args.prompt_len,
            min_new=max(2, args.gen_len // 4), max_new=args.gen_len,
            seed=args.seed, priorities=priorities, deadlines_ms=deadlines)
        print(f"[serve] synthetic trace: {len(trace)} mixed-length requests "
              f"(prompts <= {args.prompt_len}, gen <= {args.gen_len})")
    if args.poisson:
        trace = poisson_arrivals(trace, args.poisson, seed=args.seed)
        print(f"[serve] open-loop arrivals: Poisson at {args.poisson} "
              f"req/step (last arrival step "
              f"{max(r.arrival_step for r in trace)})")
    max_len = args.max_len or max(r.prompt_len + r.max_new_tokens
                                  for r in trace)
    engine = Engine(cfg, params, max_batch=args.max_batch, max_len=max_len,
                    backend=backend, scheduler=Scheduler(args.policy),
                    kv_layout=args.kv_layout, sampling=sampling,
                    max_queue_depth=args.max_queue_depth,
                    request_timeout_s=args.request_timeout)
    results = engine.run(trace)
    for r in results:
        if isinstance(r, ShedResult):
            print(f"[serve]  {r.rid}: SHED ({r.reason}) at step "
                  f"{r.shed_step} after {r.waited_s * 1e3:.0f}ms")
            continue
        print(f"[serve]  {r.rid}: prompt={r.prompt_len} "
              f"gen={r.n_tokens} ({r.finish_reason}) "
              f"ttft={r.ttft_s * 1e3:.0f}ms "
              f"decode={r.decode_tok_s:.1f} tok/s")
    summ = summarize(results, engine.stats["wall_s"])
    st = engine.stats
    print(f"[serve] engine[{args.policy}] B={args.max_batch} "
          f"max_len={max_len}: {summ['total_tokens']} tokens in "
          f"{summ['wall_s'] * 1e3:.0f}ms ({summ['total_tok_s']} tok/s, "
          f"ttft p50 {summ['ttft_p50_s'] * 1e3:.0f}ms / "
          f"p95 {summ['ttft_p95_s'] * 1e3:.0f}ms, "
          f"{st['decode_steps']} decode steps)")
    if (st["shed_requests"] or st["timeouts"] or args.policy == "deadline"
            or args.max_queue_depth or args.request_timeout):
        print(f"[serve] robustness: sheds={st['shed_requests']} "
              f"shed_rate={summ['shed_rate']} timeouts={st['timeouts']}")
        if "shed_reasons" in summ:
            print(f"[serve] shed reasons: "
                  + " ".join(f"{k}:{v}" for k, v in
                             sorted(summ["shed_reasons"].items())))
    return results, summ


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--mapping", default=None,
                    help="mapping artifact JSON; lowered to an execution "
                         "plan and run through the planned kernels")
    ap.add_argument("--require-full-coverage", action="store_true",
                    help="exit 2 unless every planned layer binds")
    ap.add_argument("--engine", action="store_true",
                    help="serve through the continuous-batching engine "
                         "(repro_torch.serving): mixed-length trace replay "
                         "with slot admission/retirement + per-request "
                         "TTFT")
    ap.add_argument("--trace", default=None,
                    help="JSONL request trace for --engine "
                         "(repro_torch.serving.trace format); default: a "
                         "seeded synthetic mixed-length trace")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="engine slot-pool size (concurrent requests)")
    ap.add_argument("--max-len", type=int, default=None,
                    help="engine per-slot sequence capacity (default: "
                         "longest prompt+gen in the trace)")
    ap.add_argument("--policy", default="continuous",
                    choices=["continuous", "static", "deadline"],
                    help="engine admission policy (static = gang batching "
                         "baseline; deadline = priority/slack ordering)")
    ap.add_argument("--priorities", default=None,
                    help="synthetic trace: comma-separated ints assigned "
                         "round-robin as request priorities (higher = more "
                         "urgent, used by --policy deadline)")
    ap.add_argument("--deadlines-ms", default=None,
                    help="synthetic trace: comma-separated per-request "
                         "deadlines in ms assigned round-robin ('none' "
                         "for no deadline)")
    ap.add_argument("--poisson", type=float, default=None, metavar="RATE",
                    help="restamp arrivals as a seeded open-loop Poisson "
                         "process at RATE requests per engine step")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="shed the newest waiting requests once the "
                         "admission queue exceeds this depth")
    ap.add_argument("--request-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="per-request wall-clock budget: queued requests "
                         "shed, running requests retire with their partial "
                         "tokens (finish_reason='timeout')")
    ap.add_argument("--temperature", type=float, default=None,
                    help="enable non-greedy sampling at this temperature "
                         "(default: greedy argmax)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (enables sampling when "
                         "< 1.0)")
    ap.add_argument("--kv-layout", default="dense",
                    choices=["paged", "dense"],
                    help="engine KV-cache layout: dense (B x max_len "
                         "slots); paged waits for the paged engine")
    for flag, item in UNPORTED_FLAGS.items():
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help=f"not ported yet ({item})")
    args = ap.parse_args(argv)

    for flag, item in UNPORTED_FLAGS.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            raise NotImplementedError(f"{flag}: waits for {item}")
    if args.kv_layout == "paged":
        raise NotImplementedError(f"--kv-layout paged: waits for "
                                  f"{PAGED_ITEM}")
    robust_flags = (args.policy == "deadline" or args.poisson
                    or args.max_queue_depth or args.request_timeout
                    or args.priorities or args.deadlines_ms)
    if robust_flags and not args.engine:
        ap.error("robustness flags (--policy deadline / --poisson / "
                 "--max-queue-depth / --request-timeout / --priorities / "
                 "--deadlines-ms) need --engine")
    if args.require_full_coverage and not args.mapping:
        ap.error("--require-full-coverage needs --mapping")

    cfgbase.load_all()
    cfg = cfgbase.get(args.arch)
    if args.reduce:
        cfg = cfgbase.reduce_for_smoke(cfg)
    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_lm(gen, cfg)

    from repro_torch.runtime import ExecutionError, LoweringError
    backend = None
    if args.mapping:
        from repro_torch.api import MappingArtifact
        art = MappingArtifact.load(args.mapping)
        try:
            plan, backend = plan_mapping_execution(params, art)
        except (LoweringError, ExecutionError) as e:
            print(f"[serve] ERROR: mapping {args.mapping} failed to "
                  f"lower/bind: {e}", file=sys.stderr)
            sys.exit(2)
        cfg = kv_cache_for(cfg, art)
        print(f"[serve] mapping {args.mapping}: model={art.model} "
              f"platform={art.platform} kv={cfg.kv_cache_dtype}")
        print_plan_coverage("serve", plan, backend)
        check_coverage("serve", backend, args.require_full_coverage)

    if args.engine:
        try:
            return serve_engine(args, cfg, params, backend=backend)
        except ExecutionError as e:
            print(f"[serve] ERROR: {e}", file=sys.stderr)
            sys.exit(2)

    prompts = torch.randint(0, cfg.vocab, (args.requests, args.prompt_len),
                            generator=gen, device=dev)
    try:
        tokens, stats = serve_batch(cfg, params, prompts, args.gen_len,
                                    backend=backend)
    except ExecutionError as e:
        print(f"[serve] ERROR: {e}", file=sys.stderr)
        sys.exit(2)
    print(f"[serve] {cfg.name} on {dev}: {args.requests} reqs, prefill "
          f"{stats['prefill_s'] * 1e3:.1f}ms, decode "
          f"{stats['decode_s'] * 1e3:.1f}ms ({stats['tok_per_s']:.1f} tok/s)")
    print("[serve] sample generations:", tokens[:2, :8].tolist())
    return tokens, stats


if __name__ == "__main__":
    main()
