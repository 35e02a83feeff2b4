#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py [--seed 0]

Phases, each printing its own lines; any failure raises and exits nonzero:

1. device: the card's name and power limit (nvidia-smi) and the torch
   version; no CUDA device is a failure, never a CPU run.
2. build: both CUDA kernels from ``src/repro_torch/csrc`` (one nvcc each,
   in parallel).
3. kernels vs their plain versions on the card, bit for bit, at the main
   path's shapes: M in {4, 512} x (K, N) in {(4096, 4096), (4096, 512),
   (4096, 11008), (11008, 4096), (4096, 64000)}; split_ternary at
   boundaries {0, 7, 128, 300, N}, with the int8 codes at and above the
   aligned boundary overwritten by garbage (the split probe: the kernel
   must read the packed stream there).
4. times (CUDA events, after warm-up) of each kernel, its plain version and
   torch._int_mm with the same epilogue, beside the bound
   max(bytes / 3.35 TB/s, int8 ops / 1979 TOP/s) of the H100 SXM data
   sheet, at the M each layer has on the path (the head projects only the
   last position: M = B at prefill as at decode).
5. serving: full-width 48-layer yi-9b with random weights from --seed,
   mapped by the static min-cost DIANA emission, lowered and bound with
   full coverage (quant_matmul:241 split_ternary:96), served with the
   fixed-batch greedy loop (4 requests x 128 prompt + 16 generated
   tokens); then served again with the plain versions
   (``reference=True``): tokens and prefill logits must be identical.
6. one JSON line of kernel records, the nvidia-smi line, and the contract
   line ``{"ok": true, "device": {...}}`` last.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

# cuBLAS picks deterministic algorithms only with a fixed workspace; set
# before torch initialises CUDA so both serving runs execute identically
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12           # H100 SXM data sheet, dense
L2_BYTES = 50 * 2**20              # H100 L2 cache
KN_SHAPES = [(4096, 4096), (4096, 512), (4096, 11008), (11008, 4096),
             (4096, 64000)]
REQUESTS, PROMPT_LEN, GEN_LEN = 4, 128, 16   # the served traffic
DECODE_M, PREFILL_M = REQUESTS, REQUESTS * PROMPT_LEN
M_SHAPES = [DECODE_M, PREFILL_M]
BOUNDARIES = [0, 7, 128, 300, None]   # None = N
# yi-9b layers per forward: (K, N) -> (kernel, count, rows at prefill);
# every layer has M = B rows at decode
PATH_LAYERS = {(4096, 4096): ("quant_matmul", 96, PREFILL_M),    # wq, wo
               (4096, 512): ("split_ternary", 96, PREFILL_M),    # wk, wv
               (4096, 11008): ("quant_matmul", 96, PREFILL_M),   # gate, up
               (11008, 4096): ("quant_matmul", 48, PREFILL_M),   # down
               # the head projects only each row's last position
               (4096, 64000): ("quant_matmul", 1, DECODE_M)}
MAIN_BOUNDARY = 7                     # raw DIANA split of wk / wv


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters):
    """Mean ms of ``fn()`` over ``iters`` launches, after 3 warm-up calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def operands(m, k, n, raw_boundary, gen):
    """int8 activations, per-domain weight codes (int8 below the raw
    boundary, ternary at and above it), the packed ternary stream and
    positive steps, as `runtime.execute.prepare_layer` lays them out."""
    import torch
    from repro_torch.kernels.ternary_packed import pack_ternary
    dev = gen.device
    x = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    w8 = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                       dtype=torch.int8)
    wt = torch.randint(-1, 2, (k, n), generator=gen, device=dev,
                       dtype=torch.int8)
    cols = torch.arange(n, device=dev)[None, :]
    w_q = torch.where(cols < raw_boundary, w8, wt)
    w_p = pack_ternary(torch.where(cols >= raw_boundary, wt, 0))
    sx = torch.rand((), generator=gen, device=dev) * 0.1 + 0.01
    sw = torch.rand((n,), generator=gen, device=dev) * 0.5 + 1e-3
    return x, w_q, w_p, sx.to(torch.float32), sw.to(torch.float32)


def bound_ms(m, k, n, weight_bytes):
    """Least time of the H100 SXM for the call, and what bounds it: each
    input read once (x, weights, sw, sx), the output written once, against
    2*M*N*K int8 operations."""
    nbytes = m * k + weight_bytes + 4 * n + 4 + 4 * m * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * m * n * k / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch, gen):
    """Bit-exact checks at every listed shape; returns the max |error|."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.quant_matmul import quant_matmul_plain
    from repro_torch.kernels.split_ternary import split_ternary_plain
    worst = 0.0
    for m in M_SHAPES:
        for k, n in KN_SHAPES:
            x, w_q, w_p, sx, sw = operands(m, k, n, n, gen)
            got = ops.quant_matmul_op(x, w_q, sx, sw)
            want = quant_matmul_plain(x, w_q, sx, sw)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            if not torch.equal(got, want):
                raise AssertionError(f"quant_matmul M={m} K={k} N={n}: "
                                     f"max |err| {err}")
            print(f"[kernels] quant_matmul  M={m:<4d} K={k:<6d} N={n:<6d} "
                  f"bit-identical")
            for b in BOUNDARIES:
                raw = n if b is None else min(b, n)
                x, w_q, w_p, sx, sw = operands(m, k, n, raw, gen)
                b_al = min(ops.align_boundary(raw, ops.block_n(128, n)), n)
                cols = torch.arange(n, device=x.device)[None, :]
                garbage = torch.full_like(w_q, 99)
                probe = torch.where(cols < b_al, w_q, garbage)
                got = ops.split_ternary_op(x, probe, w_p, sx, sw, raw)
                want = split_ternary_plain(x, w_q, w_p, sx, sw, b_al)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                worst = max(worst, err)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"split_ternary M={m} K={k} N={n} boundary={raw}: "
                        f"max |err| {err}")
                print(f"[kernels] split_ternary M={m:<4d} K={k:<6d} "
                      f"N={n:<6d} boundary={raw:<5d} (aligned {b_al}) "
                      f"bit-identical, w_q garbage at cols >= {b_al}")
    return worst


def phase_times(torch, gen):
    """Times of every (M, K, N) call the path makes; returns {kernel:
    {(m, k, n): record}}.  Each timed call reads the next of several copies
    of the weights, whose total exceeds twice the 50 MB L2 cache, so every
    call streams its weights from device memory as in a forward pass."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.quant_matmul import quant_matmul_plain
    from repro_torch.kernels.split_ternary import split_ternary_plain
    times = {"quant_matmul": {}, "split_ternary": {}}
    calls = dict.fromkeys((kernel, m if m == DECODE_M else pm, k, n)
                          for m in M_SHAPES
                          for (k, n), (kernel, _, pm) in PATH_LAYERS.items())
    for kernel, m, k, n in calls:
        raw = MAIN_BOUNDARY if kernel == "split_ternary" else n
        x, w_q, w_p, sx, sw = operands(m, k, n, raw, gen)
        copies = -(-2 * L2_BYTES // (k * n))
        wqs = [w_q] + [w_q.clone() for _ in range(copies - 1)]
        wps = [w_p] + [w_p.clone() for _ in range(copies - 1)]
        turn = itertools.cycle(range(copies))
        iters = 20 if n * k >= 4096 * 11008 else 50
        if kernel == "quant_matmul":
            def run():
                return ops.quant_matmul_op(x, wqs[next(turn)], sx, sw)

            def plain():
                return quant_matmul_plain(x, wqs[next(turn)], sx, sw)
            wbytes = k * n
        else:
            b_al = ops.align_boundary(raw, ops.block_n(128, n))

            def run():
                i = next(turn)
                return ops.split_ternary_op(x, wqs[i], wps[i], sx, sw,
                                            raw)

            def plain():
                i = next(turn)
                return split_ternary_plain(x, wqs[i], wps[i], sx, sw,
                                           b_al)
            wbytes = k * b_al + (k // 4) * (n - b_al)

        # torch._int_mm takes M > 16 only: fewer rows are zero-padded to 32
        x_lib = torch.cat([x, x.new_zeros(32 - m, k)]) if m <= 16 else x

        def lib():
            return (torch._int_mm(x_lib, wqs[next(turn)])[:m].to(
                torch.float32) * sx * sw[None, :])
        rec = {"ms": cuda_ms(run, iters),
               "plain_ms": cuda_ms(plain, max(3, iters // 5)),
               "library_ms": cuda_ms(lib, iters)}
        rec["bound_ms"], rec["bound_by"] = bound_ms(m, k, n, wbytes)
        times[kernel][(m, k, n)] = rec
        del wqs, wps
        print(f"[times] {kernel:<13s} M={m:<4d} K={k:<6d} N={n:<6d} "
              f"kernel {rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} "
              f"ms  _int_mm {rec['library_ms']:.4f} ms  bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']})  share "
              f"{rec['bound_ms'] / rec['ms']:.3f}")
    return times


def forward_mix(times, kernel, phase):
    """Sum of per-layer records over one ``"prefill"`` or ``"decode"``
    forward pass of yi-9b, each layer at the M the path gives it."""
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "bytes_ms": 0.0}
    for (k, n), (kern, count, prefill_m) in PATH_LAYERS.items():
        if kern != kernel:
            continue
        m = prefill_m if phase == "prefill" else DECODE_M
        rec = times[kernel][(m, k, n)]
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            tot[key] += count * rec[key]
        if rec["bound_by"] == "bytes":
            tot["bytes_ms"] += count * rec["bound_ms"]
    tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["bound_ms"] / 2
                       else "operations")
    del tot["bytes_ms"]
    return tot


def phase_serving(torch, seed, cfg, expected, dev):
    """Serve ``cfg`` planned on diana, then with the plain versions;
    ``expected`` is the plan's kernel histogram."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import (check_coverage, kv_cache_for,
                                          plan_mapping_execution,
                                          serve_batch)
    from repro_torch.launch.train import emit_static_mapping
    from repro_torch.models import transformer as T
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    params = T.init_lm(gen, cfg)
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, "
          f"head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"params {sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B "
          f"(init {time.perf_counter() - t0:.1f} s)")
    out = ROOT / "build" / "chip_smoke" / f"{cfg.name}_diana.json"
    art = emit_static_mapping(params, cfg, "diana", out, act_log_scale=2.0)
    plan, backend = plan_mapping_execution(params, art)
    check_coverage("serve", backend, require_full=True)
    hist = plan.kernel_histogram()
    for line in plan.histogram_lines():
        print(f"[serve] {line}")
    print(f"[serve] {backend.coverage()}")
    if hist != expected:
        raise AssertionError(f"kernel histogram {hist}, expected "
                             f"{expected}")
    wk = plan["units/0/attn/wk@0"]
    print(f"[serve] wk/wv split: counts {wk.counts}, raw boundary "
          f"{wk.boundaries[0]}, aligned {wk.aligned_boundaries[0]}")
    cfg = kv_cache_for(cfg, art)
    prompts = torch.randint(0, cfg.vocab, (REQUESTS, PROMPT_LEN),
                            generator=gen, device=dev)

    forwards = GEN_LEN
    ops.quant_matmul.launches = ops.split_ternary.launches = 0
    tokens, stats = serve_batch(cfg, params, prompts, GEN_LEN,
                                backend=backend)
    launches = {"quant_matmul": ops.quant_matmul.launches,
                "split_ternary": ops.split_ternary.launches}
    want = {k: expected.get(k, 0) * forwards
            for k in ("quant_matmul", "split_ternary")}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want} "
                             f"({forwards} forwards)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    logits = stats["prefill_logits"]
    if tuple(tokens.shape) != (REQUESTS, GEN_LEN) or \
            tuple(logits.shape) != (REQUESTS, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("serving output has the wrong shape or is "
                             "not finite")
    print(f"[serve] {REQUESTS} requests x prompt {PROMPT_LEN} + "
          f"gen {GEN_LEN}, kv {cfg.kv_cache_dtype}: prefill "
          f"{stats['prefill_s'] * 1e3:.3f} ms, decode "
          f"{stats['decode_s'] * 1e3:.3f} ms "
          f"({stats['tok_per_s']:.2f} tok/s, "
          f"{stats['decode_s'] * 1e3 / (GEN_LEN - 1):.3f} ms/step), "
          f"peak memory {peak:.2f} GiB")
    print(f"[serve] launches: quant_matmul {launches['quant_matmul']} "
          f"split_ternary {launches['split_ternary']} over {forwards} "
          f"forwards = {launches['quant_matmul'] // forwards} + "
          f"{launches['split_ternary'] // forwards} per forward")
    print(f"[serve] sample tokens: {tokens[:2, :8].tolist()}")

    backend.reference = True
    ref_tokens, ref_stats = serve_batch(cfg, params, prompts, GEN_LEN,
                                        backend=backend)
    backend.reference = False
    if ops.quant_matmul.launches != want["quant_matmul"] or \
            ops.split_ternary.launches != want["split_ternary"]:
        raise AssertionError("the plain-version run launched a kernel")
    same_tokens = torch.equal(tokens, ref_tokens)
    same_logits = torch.equal(logits, ref_stats["prefill_logits"])
    print(f"[serve] plain-version run: prefill "
          f"{ref_stats['prefill_s'] * 1e3:.3f} ms, decode "
          f"{ref_stats['decode_s'] * 1e3:.3f} ms; tokens identical "
          f"{same_tokens}, prefill logits bit-identical {same_logits}")
    if not (same_tokens and same_logits):
        raise AssertionError("kernel and plain-version serving disagree")

    _, warm = serve_batch(cfg, params, prompts, GEN_LEN, backend=backend)
    warm_ms = (warm["prefill_s"] + warm["decode_s"]) * 1e3
    print(f"[serve] warm run: prefill {warm['prefill_s'] * 1e3:.3f} ms, "
          f"decode {warm['decode_s'] * 1e3:.3f} ms "
          f"({warm['tok_per_s']:.2f} tok/s, "
          f"{warm['decode_s'] * 1e3 / (GEN_LEN - 1):.3f} ms/step)")
    busy_ms = phase_profile(torch, serve_batch, cfg, params, prompts,
                            GEN_LEN, backend)
    print(f"[profile] device busy {busy_ms:.3f} ms of the warm run's "
          f"{warm_ms:.3f} ms wall: idle share "
          f"{1.0 - busy_ms / warm_ms:.3f}")
    return launches, {"prefill_ms": stats["prefill_s"] * 1e3,
                      "decode_tok_per_s": stats["tok_per_s"],
                      "warm_prefill_ms": warm["prefill_s"] * 1e3,
                      "warm_decode_tok_per_s": warm["tok_per_s"],
                      "device_busy_ms": busy_ms, "warm_wall_ms": warm_ms,
                      "peak_gib": peak}


def phase_profile(torch, serve_batch, cfg, params, prompts, gen_len,
                  backend):
    """Device time by kernel over one more serving run, from
    torch.profiler; returns the summed device time in ms."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, st = serve_batch(cfg, params, prompts, gen_len, backend=backend)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    wall_ms = (st["prefill_s"] + st["decode_s"]) * 1e3
    print(f"[profile] profiled run: wall {wall_ms:.3f} ms, device kernels "
          f"{busy_ms:.3f} ms in {sum(e.count for e in rows)} launches")
    for e in rows[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3:10.3f} ms "
              f"{e.count:7d}x  {e.key[:90]}")
    return busy_ms


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="chip smoke test of the port")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's chip check needs one",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()

    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    for kname, log in sorted(_build.PTXAS_REPORT.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {kname}: {line.strip()}")
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    print("kernels: quant_matmul split_ternary")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    worst = phase_kernels(torch, gen)
    print(f"[times] bounds from the H100 SXM data sheet (3.35 TB/s, 1979 "
          f"int8 TOP/s dense, at 700 W); this card: {smi}")
    times = phase_times(torch, gen)
    for kernel in ("quant_matmul", "split_ternary"):
        for phase in ("decode", "prefill"):
            mix = forward_mix(times, kernel, phase)
            print(f"[times] per {phase} forward: {kernel} kernel "
                  f"{mix['ms']:.4f} ms  plain {mix['plain_ms']:.4f} ms  "
                  f"_int_mm {mix['library_ms']:.4f} ms  bound {mix['bound_ms']:.4f} ms "
                  f"({mix['bound_by']})")
    from repro_torch.configs import base as cfgbase
    launches, serving = phase_serving(
        torch, args.seed, cfgbase.get("yi-9b"),
        {"quant_matmul": 241, "split_ternary": 96}, torch.device("cuda"))

    sources = {"quant_matmul": ("src/repro_torch/csrc/quant_matmul.cu",
                                "src/repro/kernels/quant_matmul.py:49"),
               "split_ternary": ("src/repro_torch/csrc/split_ternary.cu",
                                 "src/repro/kernels/split_ternary.py:91")}
    records = []
    for kernel, (source, replaces) in sources.items():
        mix = forward_mix(times, kernel, "prefill")
        records.append({"name": kernel, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[kernel],
                        "max_abs_err": worst, "ms": mix["ms"],
                        "plain_ms": mix["plain_ms"],
                        "bound_ms": mix["bound_ms"],
                        "bound_by": mix["bound_by"],
                        "library_ms": mix["library_ms"]})
    result = {"kernels": records, "serving": serving,
              "seconds": time.perf_counter() - t_start}
    out = ROOT / "build" / "chip_smoke" / "result.json"
    out.write_text(json.dumps(result, indent=1))
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
