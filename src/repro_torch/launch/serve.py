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

The continuous-batching engine (``--engine`` and its flags) waits for the
next slice of the port and raises NotImplementedError.
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

#: flags of the JAX serve CLI that only the serving engine reads
ENGINE_FLAGS = (
    "--trace", "--max-batch", "--max-len", "--policy", "--kv-layout",
    "--page-size", "--num-pages", "--prefill-chunk", "--shared-prefix",
    "--speculate", "--draft-k", "--check-spec-parity", "--slo-variant",
    "--temperature", "--top-p", "--priorities", "--deadlines-ms",
    "--poisson", "--max-queue-depth", "--page-watermark",
    "--request-timeout", "--fault-spec", "--degrade-to", "--ttft-target-s",
    "--check-preempt-parity", "--mapping-fallback")


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
                    help="continuous-batching engine (next slice)")
    for flag in ENGINE_FLAGS:
        ap.add_argument(flag, nargs="?", const=True, default=None,
                        help="engine-only (next slice)")
    args = ap.parse_args(argv)

    used = [f for f in ENGINE_FLAGS
            if getattr(args, f[2:].replace("-", "_")) is not None]
    if args.engine or used:
        raise NotImplementedError(
            f"{'--engine' if args.engine else used[0]}: the serving engine "
            f"(repro.serving.Engine) waits for slice 2 of the port")
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
