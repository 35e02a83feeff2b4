"""Serving entry point of the port (``repro.launch.serve`` counterpart):
``serve_batch`` and ``--engine`` both serve through the continuous-batching
engine (`repro_torch.serving.Engine`, paged KV layout by default).

With ``--mapping`` serve lowers the mapping artifact onto the model's
weights (`repro_torch.runtime.lower`) and executes every projection the
plan covers through its planned CUDA kernel via the name-keyed matmul
backend (`repro_torch.runtime.PlannedBackend`).  An artifact that fails to
lower or bind falls back to majority-dtype serving
(`apply_mapping_artifact`: the searchable layers' majority domain picks
the global weight and KV-cache dtypes), as ``--mapping-fallback`` does
without trying; ``--require-full-coverage`` exits 2 instead, and also when
any planned layer is left unbound or declined.  The artifact's activation
majority decides the KV-cache dtype (int8 when the majority domain's
activations have at most 8 bits).

Every plan kernel executes on dense layers, so yi-9b serves with full
coverage from an artifact of ``diana`` (quant_matmul + split_ternary),
``gpu_tc_like`` (quant_matmul + split_precision) and ``diana`` emitted with
``bias=("aimc", 1.0)`` (quant_matmul + ternary_matmul); all three ask for
the int8 KV cache.  The hybrid ``--arch zamba2-1.2b`` serves the same way
(its Mamba2 blocks' recurrent state held per slot in both KV layouts, the
prefix cache off); at full width every projection is wider than the
emission's default ``max_cout=512``, so an artifact emitted with
``max_cout=8384`` searches all but the head (106 split_ternary + 1
quant_matmul launches per forward on diana).  The rest of the dense family
serves the same way: ``--arch h2o-danube-3-4b`` (sliding window 4096, head
dim 120; a prompt over 2048 tokens in a dense prefill runs the windowed
flash kernel), ``nemotron-4-15b`` (LayerNorm, squared-ReLU ungated FFN)
and ``command-r-35b`` (LayerNorm, attention and FFN in parallel, the head
tied to the embedding and computed as ``h @ emb.T``, never planned); emit
their artifacts with ``max_cout`` at the widest non-head projection
(10240, 24576 and 22528) to search every layer but the head.
``--arch deepseek-v2-lite-16b`` (MLA with the latent cache, MoE with
capacity dispatch, layer 0 a dense FFN) serves the same way on both
engines, the prefix cache off and speculation refused under MoE as in
the JAX package; ``max_cout=10944`` searches all but the head (215
split_ternary + 1 quant_matmul per prefill or chunk forward, 188 + 1 per
decode forward: the absorbed decode folds ``kv_b``'s weight).
``--arch arctic-480b`` (a MoE of 128 experts top-2 beside a dense
residual FFN in every attention block) serves the same way, speculation
refused under MoE; ``max_cout=7168`` searches all but the head (8
split_ternary per layer + 1 quant_matmul).  ``--arch xlstm-1.3b`` (seven
mLSTM blocks, then one sLSTM block, per repeat; per-slot recurrent state
in both KV layouts, the prefix cache off, speculation with the replay of
partial accepts) serves the same way; ``max_cout=16384`` searches all but
the head (138 split_ternary + 1 quant_matmul per forward).  The frontend
archs serve the same way, each request carrying a stub frontend row of
``frontend_tokens`` x d_model drawn from ``--seed`` (the JAX package's
frontends are stubs too): ``--arch llama-3.2-vision-11b`` (a gated
cross-attention block every fifth layer over the request's row) and
``--arch seamless-m4t-large-v2`` (a 24-layer encoder over the row, whose
memory every decoder layer cross-attends; the paged engine reruns the
encoder over all slots' rows at every chunk, as in the JAX package); the
prefix cache is off and speculation refused on both, as in the JAX
package.  ``max_cout=14336`` (llama) and ``8192`` (seamless) search all
but the head.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \\
        --requests 4 --prompt-len 128 --gen-len 16 --mapping m.json \\
        --require-full-coverage

``--engine`` replays a mixed-length request trace (``--trace`` JSONL, or a
seeded synthetic trace sized by ``--requests/--prompt-len/--gen-len``,
``--shared-prefix`` prepending one system prompt to every request)
through the engine and prints one line per request (TTFT, decode tok/s),
the run summary and, on the paged layout, the ``[serve] paged kv:`` line
(pages, peak KV bytes, prefix hits, copy-on-write copies, evictions), as
the JAX package's CLI does:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
        --engine --requests 8 --max-batch 4 --poisson 0.5 --mapping m.json

``--kv-layout dense`` selects the dense layout; ``--page-size``,
``--num-pages``, ``--prefill-chunk`` and ``--page-watermark`` size the
paged one; ``--policy deadline --check-preempt-parity`` replays the trace
FCFS and exits 2 unless every completed request's tokens match.

Multi-plan serving binds several artifacts of the same weights as one
`repro_torch.runtime.PlanSet` bank (`build_planset`; its per-variant
coverage and dedup bytes are printed by `print_planset_report`):
``--speculate draft.json [--draft-k 4] [--check-spec-parity]`` drafts
with the second artifact and verifies with ``--mapping`` (the parity check
replays the trace target-only and exits 2 unless the tokens are
identical); ``--slo-variant CLASS=MAPPING`` (repeatable) routes a class of
the trace to its own variant; ``--degrade-to CLASS --ttft-target-s S``
routes new requests to that ``--slo-variant`` class while the p95 TTFT
exceeds S; ``--fault-spec kind@step:slot[xN],kind~rate`` injects seeded
faults (`repro_torch.serving.FaultInjector`).  A bank that fails to lower
or bind exits 2 (no majority-dtype fall-back):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
        --engine --requests 8 --mapping m.json --speculate draft.json \
        --draft-k 4 --check-spec-parity

CNNs serve with the ``cnn:<config>`` arch (`repro_torch.models.cnn`):
``--requests`` random images of the config's size go through one forward,
every conv and dense layer the plan binds on its planned kernel (conv
layers through im2col, grouped ones zero-embedded); ``--engine`` is
refused, and an artifact that fails to lower or bind exits 2, as in the
JAX package:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch cnn:resnet20 \
        --requests 256 --mapping m.json --require-full-coverage
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.configs import base as cfgbase
from repro_torch.models import transformer as T


def majority_domain(artifact) -> dict:
    """The domain holding most channels of the artifact's searchable layers
    (pinned layers never had a choice; all layers vote when none is
    searchable)."""
    fractions = artifact.domain_channel_fractions(searchable_only=True)
    return artifact.domains[int(np.argmax(fractions))]


def apply_mapping_artifact(cfg, artifact):
    """The fall-back consumer: GLOBAL serving dtypes from the artifact's
    `majority_domain`.  A <= 8-bit majority serves int8 projections
    (``serve_weight_dtype``), an <= 8-bit activation majority also an int8
    KV cache.  Returns (cfg, majority domain dict)."""
    dom = majority_domain(artifact)
    updates = {}
    if dom["weight_bits"] <= 8:
        updates["serve_weight_dtype"] = "int8"
    if dom.get("act_bits", 16) <= 8:
        updates["kv_cache_dtype"] = "int8"
    if updates:
        cfg = dataclasses.replace(cfg, **updates)
    return cfg, dom


def plan_mapping_execution(params, artifact):
    """Lower ``artifact`` against ``params`` and bind a planned backend.
    Returns (plan, backend); raises `LoweringError` / `ExecutionError`."""
    from repro_torch.runtime import PlannedBackend, lower
    plan = lower(artifact, params=params)
    return plan, PlannedBackend(plan, params)


def build_planset(params, artifacts, default):
    """Lower several mapping artifacts of the SAME weights and bind them as
    one `repro_torch.runtime.PlanSet` precision bank.  ``artifacts``:
    {variant_name: MappingArtifact}.  Returns (plans, planset), ``plans``
    the per-variant `ExecutionPlan`s; raises `LoweringError` /
    `ExecutionError` -- a bank that cannot bind is an error, not a
    degraded mode."""
    from repro_torch.runtime import PlanSet, lower
    plans = {v: lower(art, params=params) for v, art in artifacts.items()}
    return plans, PlanSet(plans, params, default=default)


def print_planset_report(tag, plans, planset):
    """Per-variant coverage + the dedup memory accounting of the bank."""
    for v in planset.variant_names:
        hist = " ".join(f"{k}:{n}" for k, n in
                        sorted(plans[v].kernel_histogram().items()))
        bp = planset.variant(v)
        print(f"[{tag}] variant {v!r}: {hist}; {len(bp.bound)}/"
              f"{len(bp.plan.layers)} planned layers bound to weights, "
              f"{len(bp.unbound)} unbound")
    rep = planset.memory_report()
    print(f"[{tag}] planset memory: prepared_bytes={rep['prepared_bytes']} "
          f"sum_variant_bytes={rep['sum_variant_bytes']} "
          f"dedup_saved_bytes={rep['dedup_saved_bytes']} "
          f"shared_layers={len(rep['shared_layers'])}")
    for v, missing in sorted(planset.coverage_diff().items()):
        print(f"[{tag}] coverage diff: variant {v!r} leaves unbound: "
              f"{missing}")


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
    """Print the call sites the backend declined; exit 2 when
    ``require_full`` and any planned layer is unbound or declined.  A
    multi-variant `PlanSet` is checked variant by variant: the exit names
    the offending variant and its layer names."""
    declines = backend.runtime_declines
    for name, reason in sorted(declines.items()):
        print(f"[{tag}] declined at run time: {name}: {reason}")
    if not require_full:
        return
    if len(backend.variant_names) > 1:
        diff = backend.coverage_diff()
        for v in backend.variant_names:
            problems = list(diff.get(v, [])) + \
                [k.split(":", 1)[1] for k in sorted(declines)
                 if k.startswith(f"{v}:")]
            if problems:
                print(f"[{tag}] ERROR: --require-full-coverage but variant "
                      f"{v!r}: {len(problems)} planned layers did not "
                      f"execute as mapped: {problems}", file=sys.stderr)
                sys.exit(2)
        return
    problems = list(backend.unbound) + sorted(declines)
    if problems:
        print(f"[{tag}] ERROR: --require-full-coverage but "
              f"{len(problems)} planned layers did not execute as mapped: "
              f"{problems}", file=sys.stderr)
        sys.exit(2)


def serve_batch(cfg, params, prompts, gen_len: int, frontend=None,
                backend=None):
    """Greedy generation for same-length ``prompts (B, P)``: the B prompts
    are submitted as B requests with a shared generation budget to an
    `Engine` of B slots and ``max_len = P + gen_len`` (paged KV, as the
    JAX package's ``serve_batch``).  ``frontend`` (B, frontend_tokens,
    d_model): each request's frontend row on a frontend arch.  Returns
    (tokens (B, gen_len) on the prompts' device, stats with
    ``prefill_s``, ``decode_s`` and ``tok_per_s``)."""
    from repro_torch.serving import Engine, Request
    B, P = prompts.shape
    prompts_np = prompts.cpu().numpy()
    reqs = [Request(rid=b, prompt=prompts_np[b], max_new_tokens=gen_len,
                    frontend=None if frontend is None else frontend[b])
            for b in range(B)]
    engine = Engine(cfg, params, max_batch=B, max_len=P + gen_len,
                    backend=backend, prefill_bucket=P)
    results = engine.run(reqs)
    tokens = torch.tensor([r.tokens for r in results], device=prompts.device)
    st = engine.stats
    return tokens, {"prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
                    "tok_per_s": B * (gen_len - 1) / max(st["decode_s"],
                                                         1e-9)}


def frontend_rows(cfg, n, gen):
    """``n`` stub frontend rows (n, frontend_tokens, d_model) drawn from
    ``gen`` on its device, rounded to bfloat16 (the JAX package's CLI
    draws them in bfloat16)."""
    return torch.randn((n, cfg.frontend_tokens, cfg.d_model), generator=gen,
                       device=gen.device).to(torch.bfloat16)


def kv_cache_for(cfg, art):
    """The KV-cache dtype the artifact's activation majority asks for."""
    if majority_domain(art).get("act_bits", 16) <= 8:
        return dataclasses.replace(cfg, kv_cache_dtype="int8")
    return cfg


def serve_engine(args, cfg, params, backend=None):
    """``--engine``: replay a mixed-length request trace through the
    continuous-batching engine and report per-request latency (TTFT,
    decode tok/s) + the run summary.  The trace comes from ``--trace``
    (JSONL, see `repro_torch.serving.trace`) or a seeded synthetic trace
    sized by ``--requests/--prompt-len/--gen-len`` (the JAX package's
    trace for the same seed).  With ``--speculate`` the run is
    self-speculative (``--check-spec-parity`` replays it target-only and
    asserts token identity); ``--slo-variant`` routes each request's SLO
    class to its plan variant; ``--degrade-to`` and ``--fault-spec`` drive
    the robustness layer.  Returns (results, summary)."""
    from repro_torch.serving import (Engine, FaultInjector, SamplingParams,
                                     Scheduler, ShedResult, load_trace,
                                     poisson_arrivals, summarize,
                                     synthetic_trace)
    speculate = ("draft", "target") if args.speculate else None
    # the --degrade-to class is bound in the bank but is NOT an SLO route:
    # requests reach it only while the engine is degraded, never by tag
    route_classes = [c for c in getattr(args, "slo_classes", [])
                     if c != args.degrade_to]
    slo_routes = ({cls: cls for cls in route_classes}
                  if route_classes else None)
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
            seed=args.seed, shared_prefix=args.shared_prefix,
            slo_classes=(sorted(slo_routes) if slo_routes else None),
            priorities=priorities, deadlines_ms=deadlines)
        print(f"[serve] synthetic trace: {len(trace)} mixed-length requests "
              f"(prompts <= {args.prompt_len}, gen <= {args.gen_len}, "
              f"shared prefix {args.shared_prefix})")
    if args.poisson:
        trace = poisson_arrivals(trace, args.poisson, seed=args.seed)
        print(f"[serve] open-loop arrivals: Poisson at {args.poisson} "
              f"req/step (last arrival step "
              f"{max(r.arrival_step for r in trace)})")
    if cfg.frontend:
        gen = torch.Generator().manual_seed(args.seed)
        for r in trace:
            r.frontend = frontend_rows(cfg, 1, gen)[0]
    max_len = args.max_len or max(r.prompt_len + r.max_new_tokens
                                  for r in trace)
    injector = (FaultInjector.parse(args.fault_spec, seed=args.seed)
                if args.fault_spec else None)
    engine = Engine(cfg, params, max_batch=args.max_batch, max_len=max_len,
                    backend=backend, scheduler=Scheduler(args.policy),
                    kv_layout=args.kv_layout, page_size=args.page_size,
                    num_pages=args.num_pages,
                    prefill_chunk=args.prefill_chunk,
                    speculate=speculate, draft_k=args.draft_k,
                    slo_routes=slo_routes, sampling=sampling,
                    max_queue_depth=args.max_queue_depth,
                    page_watermark=args.page_watermark,
                    request_timeout_s=args.request_timeout,
                    degrade_to=args.degrade_to,
                    ttft_target_s=args.ttft_target_s,
                    injector=injector)
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
    if (st["preemptions"] or st["shed_requests"] or st["timeouts"]
            or st["faults_injected"] or st["degrade_transitions"]
            or args.policy == "deadline" or injector is not None
            or args.max_queue_depth or args.page_watermark
            or args.request_timeout):
        print(f"[serve] robustness: preemptions={st['preemptions']} "
              f"resumes={st['resumes']} sheds={st['shed_requests']} "
              f"shed_rate={summ['shed_rate']} timeouts={st['timeouts']} "
              f"faults_injected={st['faults_injected']} "
              f"faults_detected={st['faults_detected']} "
              f"heartbeat_trips={st['heartbeat_trips']} "
              f"degrade_transitions={st['degrade_transitions']} "
              f"degrade_rate={summ['degrade_rate']}")
        if "shed_reasons" in summ:
            print(f"[serve] shed reasons: "
                  + " ".join(f"{k}:{v}" for k, v in
                             sorted(summ["shed_reasons"].items())))
        for step_t, kind, p95 in engine.degrade_log:
            print(f"[serve] degrade transition @step {step_t}: {kind} "
                  f"(window p95 ttft {p95 * 1e3:.0f}ms)")
    if args.check_preempt_parity:
        # replay the SAME trace FCFS without preemption or sheds and
        # compare every COMPLETED request's token stream — preemption must
        # be a pure scheduling decision, invisible in the tokens
        ref_engine = Engine(
            cfg, params, max_batch=args.max_batch, max_len=max_len,
            backend=backend, scheduler=Scheduler("continuous"),
            kv_layout=args.kv_layout, page_size=args.page_size,
            num_pages=args.num_pages, prefill_chunk=args.prefill_chunk,
            slo_routes=slo_routes, sampling=sampling)
        ref = {r.rid: r for r in ref_engine.run(trace)}
        # timed-out requests carry a clean PREFIX of the full stream, so
        # every non-shed result must prefix-match its FCFS replay
        done = [r for r in results if not isinstance(r, ShedResult)]
        bad = [r.rid for r in done
               if isinstance(ref.get(r.rid), ShedResult)
               or r.tokens != ref[r.rid].tokens[:len(r.tokens)]]
        print(f"[serve] preemption token parity "
              f"({len(done)} completed requests): {not bad}")
        if bad:
            print(f"[serve] ERROR: preempted serving diverged from FCFS "
                  f"replay on requests {bad}", file=sys.stderr)
            sys.exit(2)
    if args.kv_layout == "paged":
        print(f"[serve] paged kv: page_size={engine.page_size} "
              f"pool={engine.num_pages} pages "
              f"kv_peak_pages={st['kv_peak_pages']} "
              f"kv_peak_bytes={st['kv_peak_bytes']} "
              f"(capacity {st['kv_capacity_bytes']}) "
              f"prefix_hit_tokens={st['prefix_hit_tokens']} "
              f"prefix_hit_requests={st['prefix_hit_requests']} "
              f"(lookups {st['prefix_lookups']}) "
              f"cow_copies={st['cow_copies']} "
              f"evictions={st['page_evictions']}")
    if "by_slo" in summ:
        for cls, rec in sorted(summ["by_slo"].items()):
            variant = (slo_routes or {}).get(cls, "default")
            print(f"[serve] slo {cls!r} -> variant {variant!r}: "
                  f"{rec['requests']} requests "
                  f"ttft p50 {rec['ttft_p50_s'] * 1e3:.0f}ms / "
                  f"p95 {rec['ttft_p95_s'] * 1e3:.0f}ms, "
                  f"decode p50 {rec['decode_tok_s_p50']} tok/s")
    if speculate is not None:
        print(f"[serve] speculative(draft_k={args.draft_k}): "
              f"rounds={st['spec_rounds']} drafted={st['spec_drafted']} "
              f"accepted={st['spec_accepted']} "
              f"acceptance={st['spec_acceptance']} "
              f"tokens_per_round={st['spec_tokens_per_round']}")
        if args.check_spec_parity:
            # replay the SAME trace target-only (the PlanSet default is the
            # target variant) and compare every request's token stream
            ref_engine = Engine(
                cfg, params, max_batch=args.max_batch, max_len=max_len,
                backend=backend, scheduler=Scheduler(args.policy),
                kv_layout=args.kv_layout, page_size=args.page_size,
                num_pages=args.num_pages, prefill_chunk=args.prefill_chunk)
            ref = ref_engine.run(trace)
            identical = all(a.tokens == b.tokens
                            for a, b in zip(results, ref))
            print(f"[serve] spec tokens identical to target-only: "
                  f"{identical}")
            if not identical:
                bad = [a.rid for a, b in zip(results, ref)
                       if a.tokens != b.tokens]
                print(f"[serve] ERROR: speculative decode diverged from "
                      f"target-only on requests {bad}", file=sys.stderr)
                sys.exit(2)
    return results, summ


def serve_cnn(args, cnn_name: str):
    """Batch inference of a CNN (``--arch cnn:<config>``): ``--requests``
    images of the config's size through one forward, with ``--mapping``
    every bound conv / dense layer on its planned kernel.  Returns (logits,
    {"forward_s"})."""
    from repro_torch.models import cnn as C
    from repro_torch.models import managed as mg
    cfg = C.get_config(cnn_name)
    init_fn, apply_fn, _ = C.get_model(cfg)
    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_fn(gen, cfg)

    backend = None
    if args.mapping:
        from repro_torch.api import MappingArtifact
        from repro_torch.runtime import ExecutionError, LoweringError
        art = MappingArtifact.load(args.mapping)
        try:
            plan, backend = plan_mapping_execution(params, art)
        except (LoweringError, ExecutionError) as e:
            print(f"[serve] ERROR: mapping {args.mapping} failed to "
                  f"lower/bind: {e}", file=sys.stderr)
            sys.exit(2)
        print(f"[serve] mapping {args.mapping}: model={art.model} "
              f"platform={art.platform}")
        print_plan_coverage("serve", plan, backend)

    x = torch.randn((args.requests, *cfg.img_hw, cfg.in_ch), generator=gen,
                    device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with mg.matmul_backend(backend):
        sync()
        t0 = time.perf_counter()
        logits = apply_fn(params, x, cfg)
        sync()
        dt = time.perf_counter() - t0
    if tuple(logits.shape) != (args.requests, cfg.n_classes) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name}: logits of shape "
                             f"{tuple(logits.shape)} or not finite")
    if backend is not None:
        check_coverage("serve", backend, args.require_full_coverage)
    print(f"[serve] {cfg.name} on {dev}: {args.requests} images in "
          f"{dt * 1e3:.1f} ms ({args.requests / max(dt, 1e-9):.1f} img/s)")
    return logits, {"forward_s": dt}


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
    ap.add_argument("--mapping-fallback", action="store_true",
                    help="skip plan lowering and serve with the "
                         "artifact's majority-domain dtypes")
    ap.add_argument("--require-full-coverage", action="store_true",
                    help="exit 2 unless every planned layer binds and "
                         "executes as mapped")
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
    ap.add_argument("--page-watermark", type=float, default=None,
                    help="paged layout: shed waiting requests when the "
                         "free-page fraction drops below this watermark")
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
    ap.add_argument("--check-preempt-parity", action="store_true",
                    help="after a --policy deadline run, replay the trace "
                         "FCFS without preemption and exit nonzero unless "
                         "every completed request's tokens prefix-match")
    ap.add_argument("--kv-layout", default="paged",
                    choices=["paged", "dense"],
                    help="KV-cache layout: paged (block-table pool with "
                         "chunked prefill + prefix caching) or dense "
                         "(B x max_len slots)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="paged layout: tokens per KV page")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="paged layout: pool capacity in pages (default "
                         "max_batch * ceil(max_len / page_size))")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="paged layout: prompt tokens prefilled per engine "
                         "step (default 2 * page_size)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="synthetic --engine trace: prepend the same "
                         "N-token system prefix to every prompt (exercises "
                         "prefix caching)")
    ap.add_argument("--fault-spec", default=None,
                    help="inject seeded faults: comma-separated "
                         "kind@step:slot[xN] events and/or kind~rate "
                         "Bernoulli rates (kinds: nonfinite_logits, "
                         "corrupt_page, stuck)")
    ap.add_argument("--degrade-to", default=None, metavar="CLASS",
                    help="precision degradation: route NEW requests to "
                         "this --slo-variant class while the sliding p95 "
                         "TTFT exceeds --ttft-target-s")
    ap.add_argument("--ttft-target-s", type=float, default=None,
                    help="p95 TTFT target (seconds) driving --degrade-to")
    ap.add_argument("--speculate", default=None, metavar="DRAFT_MAPPING",
                    help="second mapping artifact of the SAME weights bound "
                         "as the 'draft' variant of a PlanSet bank "
                         "(--mapping is the 'target'): self-speculative "
                         "decoding, token-identical to target-only greedy")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="tokens drafted per speculative round")
    ap.add_argument("--check-spec-parity", action="store_true",
                    help="after the speculative run, replay the trace "
                         "target-only and exit nonzero unless every "
                         "request's tokens are identical")
    ap.add_argument("--slo-variant", action="append", default=[],
                    metavar="CLASS=MAPPING",
                    help="route SLO class CLASS to a variant bound from "
                         "this mapping artifact (repeatable; --mapping is "
                         "the default variant for unrouted requests)")
    args = ap.parse_args(argv)

    if args.require_full_coverage and not args.mapping:
        ap.error("--require-full-coverage needs --mapping")
    robust_flags = (args.policy == "deadline" or args.poisson
                    or args.max_queue_depth or args.page_watermark
                    or args.request_timeout or args.fault_spec
                    or args.degrade_to or args.check_preempt_parity
                    or args.priorities or args.deadlines_ms)
    if robust_flags and not args.engine:
        ap.error("robustness flags (--policy deadline / --poisson / "
                 "--max-queue-depth / --page-watermark / --request-timeout "
                 "/ --fault-spec / --degrade-to / --check-preempt-parity / "
                 "--priorities / --deadlines-ms) need --engine")
    if args.degrade_to:
        if args.ttft_target_s is None:
            ap.error("--degrade-to needs --ttft-target-s")
        if not any(s.startswith(f"{args.degrade_to}=")
                   for s in args.slo_variant):
            ap.error(f"--degrade-to {args.degrade_to!r} must name a "
                     f"--slo-variant class of the bank")
    elif args.ttft_target_s is not None:
        ap.error("--ttft-target-s needs --degrade-to")
    if args.check_preempt_parity and args.policy != "deadline":
        ap.error("--check-preempt-parity needs --policy deadline")
    args.slo_classes = []
    if args.speculate or args.slo_variant:
        if not args.engine:
            ap.error("--speculate/--slo-variant need --engine")
        if not args.mapping:
            ap.error("--speculate/--slo-variant need --mapping (the "
                     "target/default plan of the bank)")
        if args.mapping_fallback:
            ap.error("--mapping-fallback cannot serve a multi-plan bank")
        if args.speculate and args.slo_variant:
            ap.error("--speculate and --slo-variant are mutually exclusive")
    for spec_arg in args.slo_variant:
        cls, sep, path = spec_arg.partition("=")
        if not cls or not sep or not path:
            ap.error(f"--slo-variant wants CLASS=MAPPING, got {spec_arg!r}")
        args.slo_classes.append(cls)
    if args.arch.startswith("cnn:"):
        if args.engine:
            ap.error("--engine is a decode-loop mode; CNNs have no KV cache "
                     "to batch continuously")
        return serve_cnn(args, args.arch.split(":", 1)[1])

    cfgbase.load_all()
    try:
        cfg = cfgbase.get(args.arch)
    except KeyError as e:
        ap.error(f"--arch: {e.args[0]}")
    if args.reduce:
        cfg = cfgbase.reduce_for_smoke(cfg)
    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_lm(gen, cfg)

    from repro_torch.runtime import ExecutionError, LoweringError
    backend = None
    if args.mapping and (args.speculate or args.slo_variant):
        from repro_torch.api import MappingArtifact
        art = MappingArtifact.load(args.mapping)
        if args.speculate:
            arts = {"target": art,
                    "draft": MappingArtifact.load(args.speculate)}
            default = "target"
        else:
            arts = {"default": art}
            for spec_arg in args.slo_variant:
                cls, _, path = spec_arg.partition("=")
                arts[cls] = MappingArtifact.load(path)
            default = "default"
        try:
            plans, backend = build_planset(params, arts, default)
        except (LoweringError, ExecutionError) as e:
            print(f"[serve] multi-plan bank failed to lower/bind ({e})",
                  file=sys.stderr)
            sys.exit(2)
        # the KV-cache precision follows the default / target artifact's
        # activation majority, as on the single-plan path
        cfg = kv_cache_for(cfg, art)
        print(f"[serve] planset bank: model={art.model} "
              f"platform={art.platform} "
              f"variants={list(backend.variant_names)} default={default!r} "
              f"kv={cfg.kv_cache_dtype}")
        print_planset_report("serve", plans, backend)
        check_coverage("serve", backend, args.require_full_coverage)
    elif args.mapping:
        from repro_torch.api import MappingArtifact
        art = MappingArtifact.load(args.mapping)
        if not args.mapping_fallback:
            try:
                plan, backend = plan_mapping_execution(params, art)
            except (LoweringError, ExecutionError) as e:
                print(f"[serve] mapping {args.mapping} failed to lower/bind "
                      f"({e}); falling back to majority-dtype serving")
        if backend is not None:
            cfg = kv_cache_for(cfg, art)
            print(f"[serve] mapping {args.mapping}: model={art.model} "
                  f"platform={art.platform} kv={cfg.kv_cache_dtype}")
            print_plan_coverage("serve", plan, backend)
            check_coverage("serve", backend, args.require_full_coverage)
        else:
            cfg, dom = apply_mapping_artifact(cfg, art)
            print(f"[serve] mapping {args.mapping}: model={art.model} "
                  f"platform={art.platform} FALLBACK majority domain="
                  f"{dom['name']} -> weights={cfg.serve_weight_dtype} "
                  f"kv={cfg.kv_cache_dtype}")
            if args.require_full_coverage:
                print("[serve] ERROR: --require-full-coverage but no "
                      "execution plan could be bound", file=sys.stderr)
                sys.exit(2)

    if args.engine:
        try:
            return serve_engine(args, cfg, params, backend=backend)
        except ExecutionError as e:
            print(f"[serve] ERROR: {e}", file=sys.stderr)
            sys.exit(2)

    prompts = torch.randint(0, cfg.vocab, (args.requests, args.prompt_len),
                            generator=gen, device=dev)
    frontend = (frontend_rows(cfg, args.requests, gen) if cfg.frontend
                else None)
    try:
        tokens, stats = serve_batch(cfg, params, prompts, args.gen_len,
                                    frontend=frontend, backend=backend)
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
