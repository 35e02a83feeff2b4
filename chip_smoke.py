#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py [--seed 0]

Phases, each printing its own lines; any failure raises and exits nonzero:

1. device: the card's name and power limit (nvidia-smi) and the torch
   version; no CUDA device is a failure, never a CPU run.
2. build: the six CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   each, in parallel), ptxas's registers and spills of each kernel, a
   ``[ptxas]`` line per instantiation of the decode GEMM, and the
   ``[sass]`` line: the count of Hopper's wgmma instructions in the SASS
   of the six wgmma kernels (cuobjdump -sass of ``build/torch_ext/``:
   HGMMA in flash_attention, IGMMA in quant_matmul, ternary_matmul,
   split_ternary and ternary_packed, both in split_precision); a count of
   0 or a spill in any kernel fails.
3. kernels vs their plain versions on the card at the serving paths'
   shapes: M in {4, 512} x (K, N) in {(4096, 4096), (4096, 512),
   (4096, 11008), (11008, 4096), (4096, 64000)}.  quant_matmul,
   ternary_matmul and ternary_packed bit for bit, quant_matmul on both
   weight layouts (row-major, and the K-major view the serving paths
   hold) and also at M {17, 100, 300} off its 128-row tile and at N 1000
   off its column tiles; split_ternary bit for bit at boundaries {0, 7,
   128, 300, N} through the op (aligned to the N-block) and at 7 and 300
   through the kernel itself (a column tile that reads both streams);
   ternary_matmul, split_ternary and ternary_packed also on their wgmma
   GEMM at M {17, 100, 300, 512} x the five (K, N) and (11008, 1000), with
   the K-major codes (ternary_matmul at the K split its plan gives), and
   at the long prefill's M 12288 x (4096, 512); split_precision
   at raw boundaries {0, 7, 128, 342, N}, its int8 columns bit for bit and
   its bf16 columns within the float32 summation bound ``K * 2**-24 *
   sum_k |x w| + 2**-24 * |y|``, also at M {16, 17, 100, 300} on the
   K-major codes.  The decode GEMM (M <= 16) of all five int8 kernels at M
   {1, 2, 4, 8, 16} x the five (K, N) and (11008, 1000) on the layouts the
   serving paths hold (split_ternary at every boundary above,
   split_precision at every one of its own), and at K 1000, where the
   K-major codes take the counted pad route.  Split probes: the split
   kernels get garbage in the int8 codes at and above the boundary
   (split_ternary also 0xFF in its packed bytes below it, split_precision
   NaN in its bf16 weights below it), which must not reach the output.
   flash_attention at yi-9b's head shapes (B 4, H 32, KVH 4, D 128): Sq =
   Sk in {128, 3072}, Sq 3072 against Sk 4096 with kv_len 3072, a ragged
   Sq 3000, and one non-causal case whose keys the op pads (Sk 1000 to
   1024), each within `flash_error_bound` (the bf16 rounding of p and of
   the output, and the float32 sums; stated in its docstring).  Then the
   entry point of ternary_packed, which no serving path calls, is driven
   once at each of the ten (M, K, N) with the launch counts read around
   that run.
4. times of each kernel and its library yardstick in ROUNDS = 5
   interleaved rounds (kernel, library, kernel, library, ...; the median
   and the range of each printed, share and the factor kernel / library
   from the medians), each round the replay of a CUDA graph of the calls
   between two CUDA events (device time without the host's time between
   launches, which at decode shapes exceeds the kernels'; the eager,
   host-paced time per call is printed beside it), and of its plain
   version once (eager): the
   yardstick is torch._int_mm with the same epilogue, timed on the
   row-major and on the column-major (K-major) int8 weight, the faster
   median taken; on the unpacked codes for ternary_packed; the int8
   kernels read the K-major codes of the serving paths; for
   split_precision "two calls": _int_mm on the int8 columns and a bf16
   torch.matmul on the rest; for flash_attention
   scaled_dot_product_attention with is_causal and enable_gqa.  Beside
   the bound max(bytes / 3.35 TB/s, int8 ops / 1979 TOP/s + bf16 flops /
   989 TFLOP/s) of the H100 SXM data sheet, at the M each layer has on
   the path (the head projects only the last position: M = B at prefill
   as at decode), the diana layers also at the long prefill's M = 4 x
   3072 = 12288, and, for flash_attention, at the long prefill's call (q
   (4, 3072, 32, 128), k / v (4, 4096, 4, 128), causal, kv_len 3072).
   Then the split sweep: the wgmma GEMM of split_precision and of
   ternary_matmul at M 512 x (4096, 512) at each K split of SWEEP_SPLITS,
   each checked against the plain version and timed as above.
5. serving: full-width 48-layer yi-9b with random weights from --seed
   (one set of params), mapped three ways and served with the fixed-batch
   greedy loop (4 requests x 128 prompt + 16 generated tokens), one bound
   backend at a time:
     diana          static min-cost DIANA split: quant_matmul:241
                    split_ternary:96
     gpu_tc_like    static min-cost int8 + fp16 split: quant_matmul:241
                    split_precision:96
     diana_ternary  diana biased ("aimc", 1.0), the all-ternary baseline
                    on the searchable layers: quant_matmul:241
                    ternary_matmul:96
   each at full coverage with launch counts = histogram x 16 forwards,
   and no per-call copy of a weight (the ``transposed_copies`` of
   quant_matmul, split_ternary, ternary_matmul and split_precision and
   ``ternary_packed_matmul.padded_copies`` stay 0 on every serving path
   and in ternary_packed's entry-point run);
   then served again with the plain versions (``reference=True``, no
   launch): tokens and prefill logits identical on the integer paths.  On
   gpu_tc_like, whose bf16 columns sum in another order than the plain
   version, every split_precision call of the kernel run's prefill is
   checked against the plain version on its own inputs (int8 columns bit
   for bit, bf16 columns within the summation bound), and a third run,
   plain with the bf16 columns summed in float32, measures how far another
   valid summation order moves the prefill logits: the kernel run must lie
   within SENSITIVITY_FACTOR times that of the float64 plain run (tokens
   compared per row up to the first step whose plain top-2 margin is
   below that tolerance).  Then a warm run, and a profiled one: the
   device busy time and idle share of each path.
   diana_long: the same params and diana artifact, 4 requests x 3072
   prompt + 16 generated tokens in a 4096-slot int8 cache
   (``serve_batch(..., max_len=4096)``), so the prefill (Sq > 2048) takes
   the chunked path: launch counts flash_attention 48 (all in prefill),
   quant_matmul 241 x 16, split_ternary 96 x 16.  Every quant_matmul and
   split_ternary call of the prefill (M 12288) is held bit for bit against
   its plain version on its own inputs as it is made, and each of the 48
   flash calls against the plain version on its own q / k / v within
   `flash_error_bound`.  The matmul kernels being bit-exact, the kernel
   run differs from the plain run (``reference=True``, which also selects
   the flash kernel's plain version) only in flash's summation order; a
   second plain run evaluates attention in float64, another valid
   summation: the kernel run's prefill logits must lie within
   SENSITIVITY_FACTOR times the two plain runs' distance, in max |diff| and
   in RMS, and tokens are compared under the margin rule above (printed
   beside the distance of another request's logits, what an unrelated
   output would show).  Then a warm run (prefill ms, decode ms/step, peak
   GiB).
6. one JSON line of kernel records, the nvidia-smi line, and the contract
   line ``{"ok": true, "device": {...}}`` last.
"""
from __future__ import annotations

import argparse
import gc
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
BF16_FLOPS_PER_S = 989e12          # H100 SXM data sheet, dense
L2_BYTES = 50 * 2**20              # H100 L2 cache
KN_SHAPES = [(4096, 4096), (4096, 512), (4096, 11008), (11008, 4096),
             (4096, 64000)]
REQUESTS, PROMPT_LEN, GEN_LEN = 4, 128, 16   # the served traffic
DECODE_M, PREFILL_M = REQUESTS, REQUESTS * PROMPT_LEN
M_SHAPES = [DECODE_M, PREFILL_M]
# the long-prompt traffic (diana_long): yi-9b's whole 4K context; the
# chunked prefill needs a cache length that is a multiple of 1024
LONG_PROMPT, LONG_CACHE = 3072, 4096
LONG_M = REQUESTS * LONG_PROMPT          # rows of its prefill's projections
#: quant_matmul checks off its wgmma tiles (128 rows, 128 or 256 columns)
RAGGED_M = (17, 100, 300)
RAGGED_KN = [(4096, 4096), (11008, 1000)]
#: ternary_matmul / split_ternary / ternary_packed checks on their wgmma
#: GEMM (M > 16): every served (K, N) and N 1000 (padded to 1008 for the
#: packed ones), at these M beside PREFILL_M; and the long prefill's (M, K,
#: N)
PACKED_M = RAGGED_M
PACKED_KN = KN_SHAPES + [(11008, 1000)]
PACKED_LONG = (LONG_M, 4096, 512)
#: raw boundaries the split_ternary kernel also takes unaligned (a column
#: tile the boundary falls in reads both streams)
RAW_BOUNDARIES = (7, 300)
BOUNDARIES = [0, 7, 128, 300, None]      # split_ternary; None = N
SP_BOUNDARIES = [0, 7, 128, 342, None]   # split_precision; None = N
#: the decode GEMM (M <= 16) of the five int8 kernels, checked bit for bit
#: at these M on the layouts the serving paths hold, at every served (K, N)
#: and N 1000 off its column tiles; and its K-padding route at K 1000
DECODE_MS = (1, 2, 4, 8, 16)
DECODE_KN = KN_SHAPES + [(11008, 1000)]
PAD_KN = (1000, 1000)
#: split_precision also at these M (its decode GEMM at 16, its wgmma GEMM
#: above), on the K-major codes, beside M_SHAPES
SP_MS = (16, 17, 100, 300)
# flash_attention checks at yi-9b's heads (B, H, KVH, D) = (4, 32, 4,
# 128): (Sq, Sk, causal, kv_len); the last one runs through the op, which
# pads Sk to its 512-key block and masks the padded keys
FLASH_HEADS = (REQUESTS, 32, 4, 128)
FLASH_CASES = [(128, 128, True, None), (3072, 3072, True, None),
               (LONG_PROMPT, LONG_CACHE, True, LONG_PROMPT),
               (3000, 3000, True, None), (1000, 1000, False, None)]
KERNELS = {  # name -> (source, the TPU kernel it replaces, ops attribute)
    "quant_matmul": ("src/repro_torch/csrc/quant_matmul.cu",
                     "src/repro/kernels/quant_matmul.py:49",
                     "quant_matmul"),
    "split_ternary": ("src/repro_torch/csrc/split_ternary.cu",
                      "src/repro/kernels/split_ternary.py:91",
                      "split_ternary"),
    "ternary_matmul": ("src/repro_torch/csrc/ternary_matmul.cu",
                       "src/repro/kernels/ternary_matmul.py:44",
                       "ternary_matmul"),
    "split_precision": ("src/repro_torch/csrc/split_precision.cu",
                        "src/repro/kernels/split_precision.py:71",
                        "split_precision"),
    "ternary_packed": ("src/repro_torch/csrc/ternary_packed.cu",
                       "src/repro/kernels/ternary_packed.py:66",
                       "ternary_packed_matmul"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:81",
                        "flash_attention"),
}
#: the wgmma instructions each wgmma kernel's SASS must hold
SASS_OPS = {"flash_attention": ("HGMMA",), "quant_matmul": ("IGMMA",),
            "ternary_matmul": ("IGMMA",), "split_ternary": ("IGMMA",),
            "ternary_packed": ("IGMMA",),
            "split_precision": ("IGMMA", "HGMMA")}
# serving paths: platform, emission bias, kernel of wk / wv, raw boundary
# of wk / wv (None: one domain)
PATHS = {
    "diana": ("diana", None, "split_ternary", 7),
    "gpu_tc_like": ("gpu_tc_like", None, "split_precision", 342),
    "diana_ternary": ("diana", ("aimc", 1.0), "ternary_matmul", None),
}
#: kernel -> the run its record in the JSON line takes its launches from
LAUNCH_PATH = {"quant_matmul": "diana", "split_ternary": "diana",
               "split_precision": "gpu_tc_like",
               "ternary_matmul": "diana_ternary",
               "ternary_packed": "entry point",
               "flash_attention": "diana_long"}
# Kernel vs plain prefill logits on gpu_tc_like.  A bf16 column of
# split_precision differs from the plain value by ~1e-6 relative, which
# moves a bf16-rounded wk / wv output by one bf16 step now and then; every
# layer requantizes its activations and the KV cache to int8, where such a
# step can move a code, so the difference cascades through the 48 layers.
# Its size is the model's, not the kernel's: another valid summation order
# (float32 instead of float64, in the plain version) moves the logits as
# far.  The kernel run must stay within this factor of that distance.
SENSITIVITY_FACTOR = 4.0


def path_layers(path, prefill_m=PREFILL_M):
    """yi-9b layers per forward on ``path``: (K, N) -> (kernel, count, rows
    at a prefill of ``prefill_m`` tokens); every layer has M = B rows at
    decode."""
    kv = PATHS[path][2]
    return {(4096, 4096): ("quant_matmul", 96, prefill_m),    # wq, wo
            (4096, 512): (kv, 96, prefill_m),                 # wk, wv
            (4096, 11008): ("quant_matmul", 96, prefill_m),   # gate, up
            (11008, 4096): ("quant_matmul", 48, prefill_m),   # down
            # the head projects only each row's last position
            (4096, 64000): ("quant_matmul", 1, DECODE_M)}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_entries(log):
    """[(entry function, registers, spill bytes)] of one ``nvcc -Xptxas -v``
    report, in the order ptxas compiled them."""
    import re
    out, fn, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, int(m.group(1)), spill))
            fn = None
    return out


def entry_name(mangled):
    """A short name of a kernel entry: ``gemv<MT, Src>`` for the decode
    GEMM's instantiations, else the mangled name's first 48 characters."""
    import re
    if "i8gemv4gemv" in mangled:
        mt = re.search(r"gemvILi(\d+)E", mangled)
        src = re.search(r"(KMajorCodes|PackedStream|SplitTernary|"
                        r"SplitPrecision)", mangled)
        return (f"gemv<{mt.group(1) if mt else '?'}, "
                f"{src.group(1) if src else '?'}>")
    return mangled[:48]


def phase_sass(torch):
    """The ``[sass]`` line: Hopper's wgmma instructions in the SASS of the
    wgmma kernels' libraries as built (HGMMA in flash_attention, IGMMA in
    quant_matmul, ternary_matmul, split_ternary and ternary_packed, both in
    split_precision), with ptxas's registers and spills of their kernels,
    and a ``[ptxas]`` line per decode GEMM instantiation (registers,
    spills); fails if an instruction count is 0 or any kernel of any
    library spills."""
    import shutil
    from repro_torch.kernels import _build
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    paths = _build.build_all(tuple(KERNELS))
    parts, counts, spilled = [], {}, []
    for kernel in KERNELS:
        entries = ptxas_entries(_build.PTXAS_REPORT.get(kernel, ""))
        spilled += [(kernel, entry_name(f), b) for f, _, b in entries if b]
        for fn, regs, spill in entries:
            if "i8gemv4gemv" in fn:
                print(f"[ptxas] {kernel:<15s} {entry_name(fn):<28s} "
                      f"registers {regs}, spill bytes {spill}")
        if kernel not in SASS_OPS:
            continue
        sass = subprocess.run([cuobjdump, "-sass", str(paths[kernel])],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        counts[kernel] = {op: sass.count(op + ".") for op in SASS_OPS[kernel]}
        parts.append(f"{kernel} " + " ".join(
            f"{op} {n}" for op, n in counts[kernel].items()) +
            f" (ptxas: registers "
            f"{'/'.join(str(r) for _, r, _ in entries) or 'not rebuilt'} "
            f"per kernel, spill bytes {sum(b for _, _, b in entries)})")
        if not all(counts[kernel].values()):
            raise AssertionError(f"{kernel}: {counts[kernel]} in the SASS")
    print("[sass] " + "; ".join(parts))
    if spilled:
        raise AssertionError(f"kernels spill: {spilled}")
    return counts


#: phase 4 times each kernel and its yardstick in this many interleaved
#: rounds (kernel, library, kernel, library, ...) and keeps the medians
ROUNDS = 5


def cuda_ms(fn, iters):
    """Mean ms of ``fn()`` over ``iters`` launches, after 3 warm-up calls
    (eager: the host's time between launches included)."""
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


def graph_timer(fn, calls):
    """``(timer, graph)``: ``calls`` calls of ``fn`` captured as one CUDA
    graph (after two warm-up calls); ``timer()`` replays it between two
    CUDA events and returns the ms per call -- the device time of the
    calls' launches back to back, without the host's time between them,
    which at small shapes exceeds the kernels' (the eager times).  The
    warm-up runs on the current stream: PyTorch keeps a cuBLAS workspace
    for every stream that runs a matmul, so a side stream per timer would
    hold memory through the serving phases (their peak)."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()

    def timer():
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / calls
    timer()
    return timer, graph


def graph_rounds(fns, calls):
    """``{name: [ms per call of each round]}``: each ``fns[name]`` captured
    once (`graph_timer`), then ROUNDS rounds replaying every graph in turn
    (kernel, library, kernel, library, ...)."""
    timers = {name: graph_timer(fn, calls) for name, fn in fns.items()}
    out = {name: [] for name in fns}
    for _ in range(ROUNDS):
        for name, (timer, _) in timers.items():
            out[name].append(timer())
    del timers
    return out


def median(xs):
    ys = sorted(xs)
    return ys[len(ys) // 2] if len(ys) % 2 else \
        (ys[len(ys) // 2 - 1] + ys[len(ys) // 2]) / 2


def spread(rec, key, xs):
    """rec[key] = the median of ``xs``; its range under the key with "ms"
    replaced by "min_ms" / "max_ms"."""
    pre = key[:-len("ms")]
    rec[key] = median(xs)
    rec[pre + "min_ms"], rec[pre + "max_ms"] = min(xs), max(xs)


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


def bound_ms(m, k, n, weight_bytes, int8_cols=None, bf16_cols=0):
    """Least time of the H100 SXM for the call, and what bounds it: each
    input read once (the int8 activations if any column is int8, the bf16
    ones if any is bf16, the weights, sw, sx), the output written once,
    against 2*M*K int8 operations per int8 column plus 2*M*K bf16
    operations per bf16 column."""
    int8_cols = n if int8_cols is None else int8_cols
    act = (m * k if int8_cols else 0) + (2 * m * k if bf16_cols else 0)
    nbytes = act + weight_bytes + 4 * n + 4 + 4 * m * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (2.0 * m * k * int8_cols / INT8_OPS_PER_S +
             2.0 * m * k * bf16_cols / BF16_FLOPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bound_ms(B, H, KVH, Sq, kv_end, D, causal=True):
    """Least time of the H100 SXM for one flash_attention call, and what
    bounds it: 4 * D bf16 flops per attended (query, key) pair (``sum_i
    min(i + 1, kv_end)`` per head when causal) against q read and o written
    once plus the k / v rows some query reads (``min(kv_end, Sq)`` when
    causal), all bf16."""
    if causal:
        full = min(Sq, kv_end)
        pairs = full * (full + 1) // 2 + (Sq - full) * kv_end
        rows = full
    else:
        pairs, rows = Sq * kv_end, kv_end
    t_ops = 4.0 * D * B * H * pairs / BF16_FLOPS_PER_S * 1e3
    nbytes = 2 * (2 * B * H * Sq * D + 2 * B * KVH * rows * D)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_operands(torch, B, H, KVH, Sq, Sk, D, gen, layout="bhsd"):
    """bf16 q, k, v with q ~ N(0, 9) (so that each softmax row is peaked,
    as a trained model's are, and a wrong key or mask moves the output by
    far more than the bound), k, v ~ N(0, 1); ``layout`` "bhsd": q (B, H,
    Sq, D), k / v (B, KVH, Sk, D); "model": q (B, Sq, KVH, G, D), k / v
    (B, Sk, KVH, D)."""
    dev = gen.device
    shapes = ((B, H, Sq, D), (B, KVH, Sk, D)) if layout == "bhsd" else \
        ((B, Sq, KVH, H // KVH, D), (B, Sk, KVH, D))
    q = torch.randn(shapes[0], generator=gen, device=dev) * 3.0
    k = torch.randn(shapes[1], generator=gen, device=dev)
    v = torch.randn(shapes[1], generator=gen, device=dev)
    return q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16)


def check_flash(torch, q, k, v, got, causal, kv_len, what):
    """One flash_attention output against the plain version on the same
    (B, H, S, D) operands within `flash_error_bound`; returns (max |err|,
    max err / bound)."""
    from repro_torch.kernels.flash_attention import (flash_attention_plain,
                                                     flash_error_bound)
    want = flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    err = (got.double() - want.double()).abs()
    bound = flash_error_bound(q, k, v, want, kv_len=kv_len)
    ratio = float((err / bound).max())
    if not bool(torch.isfinite(got).all()) or not bool((err <= bound).all()):
        raise AssertionError(f"flash_attention {what}: max error / bound "
                             f"{ratio:.4g} (max |err| {float(err.max())})")
    return float(err.max()), ratio


def aligned(raw, n):
    """The boundary the ops split at: rounded up to the N-block, clamped."""
    from repro_torch.kernels import ops
    return min(ops.align_boundary(raw, ops.block_n(128, n)), n)


def split_precision_case(torch, m, k, n, raw, gen):
    """Operands of one split_precision check or timing: the clean ones and
    the split probe (w_q 99 at and above the aligned boundary, w_bf16 NaN
    below it); returns (args before the weights, clean w, probe w, sw,
    aligned boundary).  The bf16 operands have yi-9b's magnitudes
    (unit-scale activations, 0.02-scale weights)."""
    x_q, w_q, _, sx, sw = operands(m, k, n, n, gen)
    x = torch.randn((m, k), generator=gen, device=gen.device)
    w_b = torch.randn((k, n), generator=gen, device=gen.device) * 0.02
    x, w_b = x.to(torch.bfloat16), w_b.to(torch.bfloat16)
    b_al = aligned(raw, n)
    cols = torch.arange(n, device=x.device)[None, :]
    probe_q = torch.where(cols < b_al, w_q, 99).to(torch.int8)
    probe_b = torch.where(cols >= b_al, w_b,
                          float("nan")).to(torch.bfloat16)
    return (x, x_q, sx), (w_b, w_q), (probe_b, probe_q), sw, b_al


def phase_kernels(torch, gen):
    """Checks at every listed shape; returns {kernel: max |error|}."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.quant_matmul import quant_matmul_plain
    from repro_torch.kernels.split_precision import (bf16_error_bound,
                                                     split_precision_plain)
    from repro_torch.kernels.split_ternary import (split_ternary,
                                                   split_ternary_plain)
    from repro_torch.kernels.ternary_matmul import ternary_matmul_plain
    from repro_torch.kernels.ternary_packed import ternary_packed_plain
    worst = dict.fromkeys(KERNELS, 0.0)

    def exact(kernel, got, want, what, quiet=False):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst[kernel] = max(worst[kernel], err)
        if not torch.equal(got, want):
            raise AssertionError(f"{kernel} {what}: max |err| {err}")
        if not quiet:
            print(f"[kernels] {kernel:<15s} {what} bit-identical")

    def split_probes(m, k, n, raw, layout, quiet=False):
        """split_ternary through the op (boundary aligned to the N-block)
        and, at a raw boundary of RAW_BOUNDARIES, the kernel itself at that
        column; w_q holds 99 at and above the boundary, the packed stream
        0xFF (a 2 in every 2-bit field) below it: neither may reach the
        output."""
        shape = f"M={m:<5d} K={k:<6d} N={n:<6d}"
        x, w_q, w_p, sx, sw = operands(m, k, n, raw, gen)
        cols = torch.arange(n, device=x.device)[None, :]
        calls = [(aligned(raw, n), ops.split_ternary_op, raw, "aligned")]
        if raw in RAW_BOUNDARIES:
            calls.append((raw, split_ternary, raw, "raw"))
        for b, fn, arg, what in calls:
            probe = torch.where(cols < b, w_q, 99).to(torch.int8)
            if layout == "K-major":
                probe = probe.t().contiguous().t()
            probe_p = torch.where(cols < b, 0xFF, w_p).to(torch.uint8)
            exact("split_ternary", fn(x, probe, probe_p, sx, sw, arg),
                  split_ternary_plain(x, w_q, w_p, sx, sw, b),
                  f"{shape} {layout} boundary={raw:<5d} ({what} {b}), w_q "
                  f"garbage at cols >= {b}, packed garbage below:",
                  quiet)

    def packed_case(m, k, n, quiet=False):
        x, w_t, w_p, sx, sw = operands(m, k, n, 0, gen)
        exact("ternary_packed", ops.ternary_packed_matmul_op(x, w_p, sx, sw),
              ternary_packed_plain(x, w_p, sx, sw),
              f"M={m:<5d} K={k:<6d} N={n:<6d}", quiet)

    def split_precision_check(m, k, n, raw, layout, quiet=False):
        """split_precision through the op (boundary aligned to the N-block)
        with the split probe (w_q 99 at and above the aligned boundary,
        w_bf16 NaN below it): int8 columns bit for bit, bf16 columns within
        the summation bound."""
        shape = f"M={m:<4d} K={k:<6d} N={n:<6d}"
        acts, (w_b, w_q), (p_b, p_q), sw, b_al = \
            split_precision_case(torch, m, k, n, raw, gen)
        if layout == "K-major":
            p_q = p_q.t().contiguous().t()
        got = ops.split_precision_op(*acts, p_b, p_q, sw, raw)
        want = split_precision_plain(*acts, w_b, w_q, sw, b_al)
        torch.cuda.synchronize()
        if not torch.equal(got[:, :b_al], want[:, :b_al]):
            raise AssertionError(
                f"split_precision {shape} {layout} boundary={raw}: int8 "
                f"columns differ")
        err = (got[:, b_al:].double() - want[:, b_al:].double()).abs()
        bound = bf16_error_bound(acts[0], w_b[:, b_al:], want[:, b_al:])
        ratio = (float((err / bound.clamp_min(1e-300)).max())
                 if err.numel() else 0.0)
        worst["split_precision"] = max(
            worst["split_precision"],
            float(err.max()) if err.numel() else 0.0)
        if not bool((err <= bound).all()):
            raise AssertionError(
                f"split_precision {shape} {layout} boundary={raw}: bf16 "
                f"columns outside the summation bound (worst error / bound "
                f"{ratio:.3g})")
        if not quiet:
            print(f"[kernels] split_precision {shape} boundary="
                  f"{raw:<5d} (aligned {b_al}) int8 columns "
                  f"bit-identical, bf16 columns max |err| "
                  f"{float(err.max()) if err.numel() else 0.0:.3g} = "
                  f"{ratio:.3g} of the bound; w_q garbage at cols >= "
                  f"{b_al}, w_bf16 NaN below")
        return ratio

    def ternary_split(m, k, n):
        from repro_torch.kernels.ternary_matmul import launch_args
        return launch_args(m, -(-k // 16) * 16, n, gen.device)[1]

    def ternary_k_major(m, k, n, quiet=True):
        x, w_t, _, sx, sw = operands(m, k, n, 0, gen)
        exact("ternary_matmul", ops.ternary_matmul_op(
            x, w_t.t().contiguous().t(), sx, sw),
            ternary_matmul_plain(x, w_t, sx, sw),
            f"M={m:<5d} K={k:<6d} N={n:<6d} K-major, K split "
            f"{ternary_split(m, k, n)}", quiet)

    def quant_both_layouts(m, k, n):
        shape = f"M={m:<4d} K={k:<6d} N={n:<6d}"
        x, w_q, _, sx, sw = operands(m, k, n, n, gen)
        for layout, w in (("row-major", w_q),
                          ("K-major", w_q.t().contiguous().t())):
            exact("quant_matmul", ops.quant_matmul_op(x, w, sx, sw),
                  quant_matmul_plain(x, w, sx, sw), f"{shape} {layout:9s}")

    for m in M_SHAPES:
        for k, n in KN_SHAPES:
            shape = f"M={m:<4d} K={k:<6d} N={n:<6d}"
            quant_both_layouts(m, k, n)
            x, w_t, w_p, sx, sw = operands(m, k, n, 0, gen)
            exact("ternary_matmul", ops.ternary_matmul_op(x, w_t, sx, sw),
                  ternary_matmul_plain(x, w_t, sx, sw), shape)
            exact("ternary_packed",
                  ops.ternary_packed_matmul_op(x, w_p, sx, sw),
                  ternary_packed_plain(x, w_p, sx, sw), shape)
            for b in BOUNDARIES:
                split_probes(m, k, n, n if b is None else min(b, n),
                             "row-major")
            for b in SP_BOUNDARIES:
                split_precision_check(m, k, n, n if b is None else min(b, n),
                                      "row-major")
    for m in RAGGED_M:
        for k, n in RAGGED_KN:
            quant_both_layouts(m, k, n)
    # the wgmma GEMM of ternary_matmul, split_ternary and ternary_packed (M
    # > 16) on the K-major codes the serving paths hold (ternary_matmul at
    # the split its plan gives), one line per (M, K, N)
    for m in PACKED_M + (PREFILL_M,):
        for k, n in PACKED_KN:
            ternary_k_major(m, k, n)
            if m == PREFILL_M and (k, n) in KN_SHAPES:
                print(f"[kernels] wgmma M={m:<5d} K={k:<6d} N={n:<6d}: "
                      f"ternary_matmul (K split {ternary_split(m, k, n)}) "
                      f"bit-identical")
                continue          # the others checked above
            packed_case(m, k, n, quiet=True)
            raws = [n if b is None else min(b, n) for b in BOUNDARIES]
            for raw in raws:
                split_probes(m, k, n, raw, "K-major", quiet=True)
            print(f"[kernels] wgmma M={m:<5d} K={k:<6d} N={n:<6d}: "
                  f"ternary_matmul (K split {ternary_split(m, k, n)}), "
                  f"ternary_packed and split_ternary (boundaries {raws}, "
                  f"aligned and raw {list(RAW_BOUNDARIES)}, both garbage "
                  f"probes) bit-identical")
    # the decode GEMM of the five int8 kernels on the layouts the serving
    # paths hold (K-major codes, the packed stream as stored)
    for m in DECODE_MS:
        for k, n in DECODE_KN:
            shape = f"M={m} K={k} N={n} K-major"
            x, w_q, w_p, sx, sw = operands(m, k, n, n, gen)
            exact("quant_matmul", ops.quant_matmul_op(
                x, w_q.t().contiguous().t(), sx, sw),
                quant_matmul_plain(x, w_q, sx, sw), shape, quiet=True)
            x, w_t, w_p, sx, sw = operands(m, k, n, 0, gen)
            exact("ternary_matmul", ops.ternary_matmul_op(
                x, w_t.t().contiguous().t(), sx, sw),
                ternary_matmul_plain(x, w_t, sx, sw), shape, quiet=True)
            packed_case(m, k, n, quiet=True)
            raws = [n if b is None else min(b, n) for b in BOUNDARIES]
            for raw in raws:
                split_probes(m, k, n, raw, "K-major", quiet=True)
            ratio = max(split_precision_check(
                m, k, n, n if b is None else min(b, n), "K-major", quiet=True)
                for b in SP_BOUNDARIES)
            print(f"[kernels] decode M={m:<3d} K={k:<6d} N={n:<6d}: "
                  f"quant_matmul, ternary_matmul, ternary_packed, "
                  f"split_ternary (boundaries {raws}, aligned and raw "
                  f"{list(RAW_BOUNDARIES)}, both garbage probes) "
                  f"bit-identical; split_precision int8 columns "
                  f"bit-identical, bf16 columns at most {ratio:.3g} of the "
                  f"bound (both probes)")
    # K off 16: the K-major codes take the counted pad route (one copy)
    m, (k, n) = DECODE_M, PAD_KN
    reset_launches()
    shape = f"M={m} K={k} N={n} K-major"
    x, w_q, w_p, sx, sw = operands(m, k, n, 7, gen)
    exact("quant_matmul", ops.quant_matmul_op(
        x, w_q.t().contiguous().t(), sx, sw),
        quant_matmul_plain(x, w_q, sx, sw), shape, quiet=True)
    x, w_t, w_p, sx, sw = operands(m, k, n, 0, gen)
    exact("ternary_matmul", ops.ternary_matmul_op(
        x, w_t.t().contiguous().t(), sx, sw),
        ternary_matmul_plain(x, w_t, sx, sw), shape, quiet=True)
    packed_case(m, k, n, quiet=True)
    split_probes(m, k, n, 7, "K-major", quiet=True)
    split_precision_check(m, k, n, 7, "K-major", quiet=True)
    copies = weight_copies()
    want = {"quant_matmul.transposed_copies": 1,
            "split_ternary.transposed_copies": 2,   # aligned and raw calls
            "ternary_packed_matmul.padded_copies": 0,
            "ternary_matmul.transposed_copies": 1,
            "split_precision.transposed_copies": 2}  # w_q and w_bf16
    if copies != want:
        raise AssertionError(f"K {k}: weight copies {copies}, expected "
                             f"{want}")
    print(f"[kernels] decode M={m} K={k} N={n} (K off 16): the five kernels "
          f"bit-identical (split_precision's bf16 columns within the "
          f"bound), weight copies {copies}")
    # split_precision at more M (16: decode GEMM; above: wgmma GEMM)
    for m in SP_MS:
        for k, n in KN_SHAPES:
            raws = [n if b is None else min(b, n) for b in SP_BOUNDARIES]
            ratio = max(split_precision_check(m, k, n, raw, "K-major",
                                              quiet=True) for raw in raws)
            print(f"[kernels] split_precision M={m:<4d} K={k:<6d} "
                  f"N={n:<6d} K-major, boundaries {raws}: int8 columns "
                  f"bit-identical, bf16 columns at most {ratio:.3g} of the "
                  f"bound (both probes)")
    m, k, n = PACKED_LONG
    ternary_k_major(m, k, n, quiet=False)
    packed_case(m, k, n)
    for raw in (PATHS["diana"][3], 300):
        split_probes(m, k, n, raw, "K-major")
    B, H, KVH, D = FLASH_HEADS
    for Sq, Sk, causal, kv_len in FLASH_CASES:
        q, k, v = flash_operands(torch, B, H, KVH, Sq, Sk, D, gen)
        if causal:
            got = ops.flash_attention(q, k, v, causal=True, kv_len=kv_len)
        else:   # through the op, which pads the keys and masks them
            got = ops.flash_attention_op(q, k, v, causal=False)
        what = (f"B={B} H={H} KVH={KVH} D={D} Sq={Sq} Sk={Sk} "
                f"causal={causal} kv_len={kv_len}")
        err, ratio = check_flash(torch, q, k, v, got, causal, kv_len, what)
        worst["flash_attention"] = max(worst["flash_attention"], err)
        print(f"[kernels] flash_attention {what}: max |err| {err:.4g} = "
              f"{ratio:.4g} of the bound")
        del q, k, v, got
    return worst


def phase_packed_entry(torch, gen):
    """ternary_packed's own run: its entry point (no serving path calls
    it) once at each (M, K, N) of the serving paths, launch counts read
    around the run; returns the launches."""
    from repro_torch.kernels import ops
    reset_launches()
    for m in M_SHAPES:
        for k, n in KN_SHAPES:
            x, _, w_p, sx, sw = operands(m, k, n, 0, gen)
            y = ops.ternary_packed_matmul_op(x, w_p, sx, sw)
            if tuple(y.shape) != (m, n) or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"ternary_packed entry point M={m} "
                                     f"K={k} N={n}: wrong shape or not "
                                     f"finite")
    launches = kernel_launches()
    want = dict.fromkeys(KERNELS, 0)
    want["ternary_packed"] = len(M_SHAPES) * len(KN_SHAPES)
    if launches != want:
        raise AssertionError(f"ternary_packed entry point: launches "
                             f"{launches}, expected {want}")
    check_no_weight_copies("ternary_packed entry point")
    print(f"[entry] ternary_packed_matmul_op at {want['ternary_packed']} "
          f"(M, K, N): {launches['ternary_packed']} launches")
    return launches


def phase_times(torch, gen):
    """Times of every (M, K, N) call the serving paths make; returns
    {kernel: {(m, k, n): record}}.  Each timed call reads the next of
    several copies of the weights, whose total exceeds twice the 50 MB L2
    cache, so every call streams its weights from device memory as in a
    forward pass.  quant_matmul and split_ternary read the K-major codes
    the serving paths hold; the library yardstick runs torch._int_mm on the
    row-major and on the K-major (column-major) int8 weight, and the faster
    is the record's ``library_ms``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.quant_matmul import quant_matmul_plain
    from repro_torch.kernels.split_precision import split_precision_plain
    from repro_torch.kernels.split_ternary import split_ternary_plain
    from repro_torch.kernels.ternary_matmul import ternary_matmul_plain
    from repro_torch.kernels.ternary_packed import ternary_packed_plain
    times = {kernel: {} for kernel in KERNELS}
    calls = {}
    for path, (_, _, _, raw) in PATHS.items():
        for (k, n), (kernel, _, pm) in path_layers(path).items():
            for m in M_SHAPES:
                key = (kernel, m if m == DECODE_M else pm, k, n)
                calls[key] = raw if kernel == PATHS[path][2] else None
    # the long prefill's calls (diana_long: the diana layers at LONG_M)
    raw = PATHS["diana"][3]
    for (k, n), (kernel, _, pm) in path_layers("diana", LONG_M).items():
        calls[(kernel, pm, k, n)] = raw if kernel == "split_ternary" else None
    for m in M_SHAPES:       # the calls of ternary_packed's entry-point run
        for k, n in KN_SHAPES:
            calls[("ternary_packed", m, k, n)] = None
    for (kernel, m, k, n), raw in calls.items():
        raw = n if raw is None else raw
        b_al = aligned(raw, n)
        iters = 20 if n * k >= 4096 * 11008 else 50
        # torch._int_mm takes M > 16 only: fewer rows are zero-padded to 32
        pad_rows = (lambda t: torch.cat([t, t.new_zeros(32 - m, k)])
                    if m <= 16 else t)
        if kernel == "split_precision":
            acts, (w_b, w_q), _, sw, _ = split_precision_case(
                torch, m, k, n, raw, gen)
            x, x_q, sx = acts
            wbytes = k * b_al + 2 * k * (n - b_al)
            lo = w_q[:, :b_al].contiguous()
            # the kernel reads the K-major codes the layers hold
            weights = (w_b, w_q.t().contiguous().t(), lo,
                       w_b[:, b_al:].contiguous(), lo.t().contiguous().t())
            lib_int8 = (2, 4)     # int8 operand: row-major, K-major
            x_lib = pad_rows(x_q)

            def run(w):
                return ops.split_precision_op(x, x_q, sx, w[0], w[1], sw,
                                              raw)

            def plain(w):
                return split_precision_plain(x, x_q, sx, w[0], w[1], sw,
                                             b_al)

            def lib(w, i):   # two calls, no concatenation
                lo = torch._int_mm(x_lib, w[i])[:m].to(torch.float32) * \
                    sx * sw[None, :b_al]
                return lo, torch.matmul(x, w[3]).to(torch.float32)
            bound = bound_ms(m, k, n, wbytes, int8_cols=b_al,
                             bf16_cols=n - b_al)
        else:
            x, w_q, w_p, sx, sw = operands(
                m, k, n, 0 if kernel in ("ternary_matmul", "ternary_packed")
                else raw, gen)
            w_col = w_q.t().contiguous().t()
            # the library call reads the codes w[0] (row-major) or w[-1]
            # (K-major); quant_matmul, ternary_matmul and split_ternary read
            # w[-1] as the serving paths hold it (split_ternary beside the
            # packed stream w[1]), ternary_packed w[1]
            weights = (w_q, w_col)
            lib_int8 = (0, -1)
            x_lib = pad_rows(x)
            if kernel == "ternary_packed":
                weights = (w_q, w_p, w_col)
                wbytes = (k // 4) * n

                def run(w):
                    return ops.ternary_packed_matmul_op(x, w[1], sx, sw)

                def plain(w):
                    return ternary_packed_plain(x, w[1], sx, sw)
            elif kernel == "split_ternary":
                weights = (w_q, w_p, w_col)
                wbytes = k * b_al + (k // 4) * (n - b_al)

                def run(w):
                    return ops.split_ternary_op(x, w[2], w[1], sx, sw, raw)

                def plain(w):
                    return split_ternary_plain(x, w[0], w[1], sx, sw, b_al)
            else:
                wbytes = k * n
                op, plain_fn, wi = {
                    "quant_matmul": (ops.quant_matmul_op,
                                     quant_matmul_plain, -1),
                    "ternary_matmul": (ops.ternary_matmul_op,
                                       ternary_matmul_plain, -1)}[kernel]

                def run(w, op=op, wi=wi):
                    return op(x, w[wi], sx, sw)

                def plain(w, plain_fn=plain_fn, wi=wi):
                    return plain_fn(x, w[wi], sx, sw)

            def lib(w, i):
                return (torch._int_mm(x_lib, w[i])[:m].to(torch.float32) *
                        sx * sw[None, :])
            bound = bound_ms(m, k, n, wbytes)
        copies = -(-2 * L2_BYTES // wbytes)
        ring = [weights] + [tuple(t.clone() for t in weights)
                            for _ in range(copies - 1)]
        turn = itertools.cycle(ring)
        # a graph holds at least one call per weight copy: each replay
        # streams its weights from device memory
        rounds = graph_rounds(
            {"ms": lambda: run(next(turn)),
             "library_row_ms": lambda: lib(next(turn), lib_int8[0]),
             "library_col_ms": lambda: lib(next(turn), lib_int8[1])},
            max(iters, copies))
        rec = {"plain_ms": cuda_ms(lambda: plain(next(turn)),
                                   max(3, iters // 5)),
               "eager_ms": cuda_ms(lambda: run(next(turn)), iters)}
        for key, xs in rounds.items():
            spread(rec, key, xs)
        lib_key = min(("library_row_ms", "library_col_ms"),
                      key=lambda key: rec[key])
        spread(rec, "library_ms", rounds[lib_key])
        rec["bound_ms"], rec["bound_by"] = bound
        times[kernel][(m, k, n)] = rec
        del ring, turn, weights
        lib_name = "two calls" if kernel == "split_precision" else "_int_mm"
        print(f"[times] {kernel:<15s} M={m:<5d} K={k:<6d} N={n:<6d} "
              f"kernel {rec['ms']:.4f} ms ({rec['min_ms']:.4f}-"
              f"{rec['max_ms']:.4f}; eager {rec['eager_ms']:.4f})  plain "
              f"{rec['plain_ms']:.4f} ms  "
              f"{lib_name} {rec['library_ms']:.4f} ms "
              f"({rec['library_min_ms']:.4f}-{rec['library_max_ms']:.4f}; "
              f"int8 weight row-major {rec['library_row_ms']:.4f}, K-major "
              f"{rec['library_col_ms']:.4f})  bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']})  share {rec['bound_ms'] / rec['ms']:.3f}"
              f"  factor {rec['ms'] / rec['library_ms']:.3f}")
    return times


#: the K splits the wgmma GEMM of split_precision and ternary_matmul is
#: timed at (the sweep)
SWEEP_SPLITS = (1, 2, 4, 8)


def phase_split_sweep(torch, gen):
    """The wgmma GEMM of split_precision and of ternary_matmul at their
    served prefill call (M 512, K 4096, N 512; split_precision at raw
    boundary 342) with each K split of SWEEP_SPLITS in place of the
    wrapper's plan: each checked against the plain version (ternary_matmul
    and split_precision's int8 columns bit for bit, its bf16 columns within
    the bound) and timed as the kernels of phase 4 (graph replays, ROUNDS
    rounds, weights cold in L2); returns {kernel: {split: median ms}}."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import split_precision as sp
    from repro_torch.kernels import ternary_matmul as tm
    m, (k, n), raw = PREFILL_M, (4096, 512), PATHS["gpu_tc_like"][3]
    acts, (w_b, w_q), _, sw_p, b_al = split_precision_case(torch, m, k, n,
                                                           raw, gen)
    x, w_t, _, sx, sw = operands(m, k, n, 0, gen)
    cases = {
        "split_precision": (sp, (w_b, w_q.t().contiguous().t()),
                            k * b_al + 2 * k * (n - b_al)),
        "ternary_matmul": (tm, (w_t.t().contiguous().t(),), k * n)}
    out = {}
    for kernel, (module, weights, wbytes) in cases.items():
        copies = -(-2 * L2_BYTES // wbytes)
        ring = itertools.cycle([weights] + [
            tuple(t.clone() for t in weights) for _ in range(copies - 1)])
        if kernel == "split_precision":
            def call(w):
                return ops.split_precision_op(*acts, *w, sw_p, raw)
        else:
            def call(w):
                return ops.ternary_matmul_op(x, w[0], sx, sw)
        plan, out[kernel] = module.wgmma_split, {}
        try:
            for split in SWEEP_SPLITS:
                module.wgmma_split = lambda *_, split=split: split
                got = call(weights)
                if kernel == "split_precision":
                    ratio = check_split_precision_calls(
                        torch, [((*acts, *weights, sw_p, raw), {"bn": 128},
                                 got)])
                    check = (f"int8 columns bit-identical, bf16 columns "
                             f"{ratio:.3g} of the bound")
                else:
                    torch.cuda.synchronize()
                    if not torch.equal(got, tm.ternary_matmul_plain(
                            x, w_t, sx, sw)):
                        raise AssertionError(f"ternary_matmul K split "
                                             f"{split}: differs")
                    check = "bit-identical"
                xs = graph_rounds({"ms": lambda: call(next(ring))},
                                  copies)["ms"]
                out[kernel][split] = median(xs)
                print(f"[times] {kernel} M={m} K={k} N={n} wgmma K split "
                      f"{split}: kernel {out[kernel][split]:.4f} ms "
                      f"({min(xs):.4f}-{max(xs):.4f}); {check}")
        finally:
            module.wgmma_split = plan
        del ring
    return out


def phase_flash_times(torch, gen):
    """Times of the long prefill's flash_attention call as the path makes
    it (`attention.chunked_attention` on the model layout: q (4, 3072, 4,
    8, 128), k / v (4, 4096, 4, 128) bf16, causal, kv_len 3072), its plain
    version on the same layout, and scaled_dot_product_attention (causal,
    GQA) over the 3072 keys the call reads; returns the record."""
    import torch.nn.functional as F
    from repro_torch.models import attention as A
    B, H, KVH, D = FLASH_HEADS
    q, k, v = flash_operands(torch, B, H, KVH, LONG_PROMPT, LONG_CACHE, D,
                             gen, layout="model")

    def run():
        return A.chunked_attention(q, k, v, kv_len=LONG_PROMPT)

    def plain():
        return A.attention_plain(q, k, v, causal=True, kv_len=LONG_PROMPT)
    qh = q.reshape(B, LONG_PROMPT, H, D).transpose(1, 2)
    kh = k[:, :LONG_PROMPT].transpose(1, 2)
    vh = v[:, :LONG_PROMPT].transpose(1, 2)

    def lib():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                              enable_gqa=True)
    rec = {"plain_ms": cuda_ms(plain, 3)}
    for key, xs in graph_rounds({"ms": run, "library_ms": lib}, 5).items():
        spread(rec, key, xs)
    rec["bound_ms"], rec["bound_by"] = flash_bound_ms(
        B, H, KVH, LONG_PROMPT, LONG_PROMPT, D)
    print(f"[times] flash_attention B={B} H={H} KVH={KVH} D={D} Sq="
          f"{LONG_PROMPT} Sk={LONG_CACHE} kv_len={LONG_PROMPT} causal: "
          f"kernel {rec['ms']:.4f} ms ({rec['min_ms']:.4f}-"
          f"{rec['max_ms']:.4f})  plain {rec['plain_ms']:.4f} ms  sdpa "
          f"{rec['library_ms']:.4f} ms ({rec['library_min_ms']:.4f}-"
          f"{rec['library_max_ms']:.4f})  bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})  share {rec['bound_ms'] / rec['ms']:.3f}"
          f"  factor {rec['ms'] / rec['library_ms']:.3f}")
    return rec


#: record keys summed over a forward pass or a run (medians, and the
#: rounds' extremes summed: the range of a forward's time)
MIX_KEYS = ("ms", "min_ms", "max_ms", "eager_ms", "plain_ms", "library_ms",
            "library_min_ms", "library_max_ms", "library_row_ms",
            "library_col_ms", "bound_ms")


def entry_mix(times, only_m=None):
    """Sum of ternary_packed's records over its entry-point run (one call
    at each (M, K, N)), or over its calls at M = ``only_m``."""
    recs = [times["ternary_packed"][(m, k, n)] for m in M_SHAPES
            for k, n in KN_SHAPES if only_m in (None, m)]
    tot = {key: sum(r[key] for r in recs) for key in MIX_KEYS}
    by_bytes = sum(r["bound_ms"] for r in recs if r["bound_by"] == "bytes")
    tot["bound_by"] = ("bytes" if by_bytes >= tot["bound_ms"] / 2
                       else "operations")
    return tot


def forward_mix(times, path, kernel, phase, prefill_m=PREFILL_M):
    """Sum of per-layer records over one ``"prefill"`` (of ``prefill_m``
    tokens) or ``"decode"`` forward pass of yi-9b on ``path``, each layer
    at the M the path gives it."""
    tot = dict.fromkeys(MIX_KEYS + ("bytes_ms",), 0.0)
    for (k, n), (kern, count, prefill_m) in path_layers(
            path, prefill_m).items():
        if kern != kernel:
            continue
        m = prefill_m if phase == "prefill" else DECODE_M
        rec = times[kernel][(m, k, n)]
        for key in MIX_KEYS:
            tot[key] += count * rec[key]
        if rec["bound_by"] == "bytes":
            tot["bytes_ms"] += count * rec["bound_ms"]
    tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= tot["bound_ms"] / 2
                       else "operations")
    del tot["bytes_ms"]
    return tot


def print_mix(what, kernel, mix):
    """The ``[times]`` line of a sum over a forward pass or a run: medians
    (the rounds' extremes summed), share and the rule-2 factor kernel /
    library from the medians."""
    row = (f" (int8 weight row-major {mix['library_row_ms']:.4f}, K-major "
           f"{mix['library_col_ms']:.4f})" if "library_row_ms" in mix else "")
    eager = f"; eager {mix['eager_ms']:.4f}" if "eager_ms" in mix else ""
    print(f"[times] {what}: {kernel} kernel {mix['ms']:.4f} ms "
          f"({mix['min_ms']:.4f}-{mix['max_ms']:.4f}{eager})  plain "
          f"{mix['plain_ms']:.4f} ms  library {mix['library_ms']:.4f} ms "
          f"({mix['library_min_ms']:.4f}-{mix['library_max_ms']:.4f}){row}"
          f"  bound {mix['bound_ms']:.4f} ms ({mix['bound_by']})  share "
          f"{mix['bound_ms'] / mix['ms']:.3f}  factor "
          f"{mix['ms'] / mix['library_ms']:.3f}")


def plain_margins(torch, cfg, params, prompts, tokens, backend,
                  max_len=None):
    """Top-2 logit margins of the plain-version run at each generated step,
    with ``tokens`` (that run's own) fed back: (B, GEN_LEN)."""
    from repro_torch.models import _backend
    from repro_torch.models import transformer as T
    B, P = prompts.shape
    caches = T.init_cache(cfg, B, max_len or P + GEN_LEN,
                          device=prompts.device)
    out = []
    with _backend.use(backend):
        logits, caches = T.prefill(params, cfg, prompts, caches)
        for i in range(GEN_LEN):
            top2 = torch.topk(logits.float(), 2, dim=-1).values
            out.append(top2[:, 0] - top2[:, 1])
            if i + 1 < GEN_LEN:
                logits, caches = T.decode_step(params, cfg, tokens[:, i],
                                               caches, P + i)
    return torch.stack(out, dim=1)


def recording_split_precision(calls, limit):
    """Context: `ops.split_precision_op` keeps the operands and output of
    its first ``limit`` calls in ``calls`` (the layer check of
    gpu_tc_like); the kernel launches as before."""
    import contextlib
    from repro_torch.kernels import ops

    @contextlib.contextmanager
    def ctx():
        orig = ops.split_precision_op

        def recording(*args, **kw):
            out = orig(*args, **kw)
            if len(calls) < limit:
                calls.append((args, kw, out))
            return out
        ops.split_precision_op = recording
        try:
            yield
        finally:
            ops.split_precision_op = orig
    return ctx()


def check_split_precision_calls(torch, calls):
    """Each recorded call against the plain version on its own inputs;
    returns the largest bf16-column error / bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.split_precision import (bf16_error_bound,
                                                     split_precision_plain)
    worst = 0.0
    for (x, x_q, sx, w_b, w_q, sw, boundary), kw, got in calls:
        n = w_q.shape[1]
        b_al = min(ops.align_boundary(boundary, ops.block_n(kw["bn"], n)),
                   n)
        want = split_precision_plain(x, x_q, sx, w_b, w_q, sw, b_al)
        if not torch.equal(got[:, :b_al], want[:, :b_al]):
            raise AssertionError("split_precision on the path: int8 "
                                 "columns differ from the plain version")
        if b_al == n:
            continue
        err = (got[:, b_al:].double() - want[:, b_al:].double()).abs()
        bound = bf16_error_bound(x, w_b[:, b_al:], want[:, b_al:])
        if not bool((err <= bound).all()):
            raise AssertionError("split_precision on the path: bf16 "
                                 "columns outside the summation bound")
        worst = max(worst, float((err / bound.clamp_min(1e-300)).max()))
    return worst


def plain_float32_split_precision():
    """Context: the plain split_precision oracle sums its bf16 columns in
    float32 (cuBLAS; TF32 is off) instead of float64 -- another valid
    order, for the sensitivity run of gpu_tc_like."""
    import contextlib
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant_matmul import quant_matmul_plain

    def plain32(x, x_q, sx, w_bf16, w_q, sw, boundary):
        lo = quant_matmul_plain(x_q, w_q, sx, sw)
        hi = x.to(torch.float32) @ w_bf16.to(torch.float32)
        cols = torch.arange(w_q.shape[1], device=w_q.device)[None, :]
        return torch.where(cols < boundary, lo, hi)

    @contextlib.contextmanager
    def ctx():
        orig = ref.split_precision_matmul_ref
        ref.split_precision_matmul_ref = plain32
        try:
            yield
        finally:
            ref.split_precision_matmul_ref = orig
    return ctx()


def kernel_launches():
    from repro_torch.kernels import ops
    return {k: getattr(ops, attr).launches
            for k, (_, _, attr) in KERNELS.items()}


#: (ops attribute, counter) of each count of per-call weight copies
COPY_COUNTERS = (("quant_matmul", "transposed_copies"),
                 ("split_ternary", "transposed_copies"),
                 ("ternary_packed_matmul", "padded_copies"),
                 ("ternary_matmul", "transposed_copies"),
                 ("split_precision", "transposed_copies"))


def reset_launches():
    """Launch counts and the counts of per-call weight copies to 0."""
    from repro_torch.kernels import ops
    for _, _, attr in KERNELS.values():
        getattr(ops, attr).launches = 0
    for attr, counter in COPY_COUNTERS:
        setattr(getattr(ops, attr), counter, 0)


def weight_copies():
    from repro_torch.kernels import ops
    return {f"{attr}.{counter}": getattr(getattr(ops, attr), counter)
            for attr, counter in COPY_COUNTERS}


def check_no_weight_copies(path):
    """A serving path holds every int8 kernel's codes K-major and its
    packed streams and bf16 weights aligned: no call may have copied a
    weight."""
    copies = weight_copies()
    if any(copies.values()):
        raise AssertionError(f"{path}: weights copied per call {copies}")


def compare_tokens(torch, path, tokens, ref_tokens, margins, tol):
    """Tokens of the kernel run against the plain run's, per row up to the
    first step whose plain top-2 margin is below ``tol``; returns the
    number of (row, step) pairs compared."""
    compared = 0
    for row in range(tokens.shape[0]):
        low = torch.nonzero(margins[row] < tol).flatten()
        upto = int(low[0]) if low.numel() else GEN_LEN
        if not torch.equal(tokens[row, :upto], ref_tokens[row, :upto]):
            raise AssertionError(f"{path}: row {row} tokens differ before "
                                 f"step {upto}")
        compared += upto
    return compared


def phase_serving(torch, path, cfg, params, prompts):
    """Serve ``cfg`` planned on ``path`` with the kernels, then with the
    plain versions, then warm; returns (launches of the kernel run,
    serving record)."""
    from repro_torch.launch.serve import (check_coverage, kv_cache_for,
                                          plan_mapping_execution,
                                          serve_batch)
    from repro_torch.launch.train import emit_static_mapping
    platform, bias, kv_kernel, _ = PATHS[path]
    expected = {}
    for kernel, count, _ in path_layers(path).values():
        expected[kernel] = expected.get(kernel, 0) + count
    torch.cuda.reset_peak_memory_stats()
    out = ROOT / "build" / "chip_smoke" / f"{cfg.name}_{path}.json"
    t0 = time.perf_counter()
    art = emit_static_mapping(params, cfg, platform, out, act_log_scale=2.0,
                              bias=bias)
    plan, backend = plan_mapping_execution(params, art)
    check_coverage("serve", backend, require_full=True)
    hist = plan.kernel_histogram()
    for line in plan.histogram_lines():
        print(f"[serve:{path}] {line}")
    print(f"[serve:{path}] {backend.coverage()} (map, lower and bind "
          f"{time.perf_counter() - t0:.1f} s)")
    if hist != expected:
        raise AssertionError(f"{path}: kernel histogram {hist}, expected "
                             f"{expected}")
    wk = plan["units/0/attn/wk@0"]
    print(f"[serve:{path}] wk/wv: counts {wk.counts}, raw boundaries "
          f"{wk.boundaries}, aligned {wk.aligned_boundaries}")
    cfg = kv_cache_for(cfg, art)

    forwards = GEN_LEN
    calls = []
    reset_launches()
    with recording_split_precision(calls, expected.get("split_precision",
                                                       0)):
        tokens, stats = serve_batch(cfg, params, prompts, GEN_LEN,
                                    backend=backend)
    launches = kernel_launches()
    want = {k: expected.get(k, 0) * forwards for k in KERNELS}
    if launches != want:
        raise AssertionError(f"{path}: launches {launches}, expected "
                             f"{want} ({forwards} forwards)")
    check_no_weight_copies(path)
    peak = torch.cuda.max_memory_allocated() / 2**30
    logits = stats["prefill_logits"]
    if tuple(tokens.shape) != (REQUESTS, GEN_LEN) or \
            tuple(logits.shape) != (REQUESTS, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{path}: serving output has the wrong shape "
                             f"or is not finite")
    print(f"[serve:{path}] {REQUESTS} requests x prompt {PROMPT_LEN} + "
          f"gen {GEN_LEN}, kv {cfg.kv_cache_dtype}: prefill "
          f"{stats['prefill_s'] * 1e3:.3f} ms, decode "
          f"{stats['decode_s'] * 1e3:.3f} ms "
          f"({stats['tok_per_s']:.2f} tok/s, "
          f"{stats['decode_s'] * 1e3 / (GEN_LEN - 1):.3f} ms/step), "
          f"peak memory {peak:.2f} GiB")
    print(f"[serve:{path}] launches: " + " ".join(
        f"{k} {v} ({v // forwards} per forward)"
        for k, v in launches.items() if v) +
        "; weights copied per call: " + ", ".join(
            f"{k} 0" for k in weight_copies()))
    print(f"[serve:{path}] sample tokens: {tokens[:2, :8].tolist()}")

    backend.reference = True
    ref_tokens, ref_stats = serve_batch(cfg, params, prompts, GEN_LEN,
                                        backend=backend)
    if kernel_launches() != want:
        raise AssertionError(f"{path}: the plain-version run launched a "
                             f"kernel")
    ref_logits = ref_stats["prefill_logits"]
    same_tokens = torch.equal(tokens, ref_tokens)
    same_logits = torch.equal(logits, ref_logits)
    diff = float((logits.float() - ref_logits.float()).abs().max())
    print(f"[serve:{path}] plain-version run: prefill "
          f"{ref_stats['prefill_s'] * 1e3:.3f} ms, decode "
          f"{ref_stats['decode_s'] * 1e3:.3f} ms; tokens identical "
          f"{same_tokens}, prefill logits bit-identical {same_logits} "
          f"(max |diff| {diff:.4g})")
    record = {"prefill_ms": stats["prefill_s"] * 1e3,
              "decode_tok_per_s": stats["tok_per_s"],
              "plain_prefill_ms": ref_stats["prefill_s"] * 1e3,
              "peak_gib": peak, "kv_cache_dtype": cfg.kv_cache_dtype,
              "tokens_identical": same_tokens,
              "prefill_logits_identical": same_logits,
              "prefill_logits_max_abs_diff": diff}
    if kv_kernel != "split_precision":
        if not (same_tokens and same_logits):
            raise AssertionError(f"{path}: kernel and plain-version "
                                 f"serving disagree")
    else:
        ratio = check_split_precision_calls(torch, calls)
        print(f"[serve:{path}] the {len(calls)} split_precision calls of "
              f"the prefill agree with the plain version on their own "
              f"inputs: int8 columns bit-identical, bf16 columns within "
              f"{ratio:.3g} of the summation bound")
        del calls
        with plain_float32_split_precision():
            tok32, st32 = serve_batch(cfg, params, prompts, GEN_LEN,
                                      backend=backend)
        if kernel_launches() != want:
            raise AssertionError(f"{path}: the float32 plain run launched "
                                 f"a kernel")
        spread = float((st32["prefill_logits"].float() -
                        ref_logits.float()).abs().max())
        print(f"[serve:{path}] plain run with float32 sums: prefill "
              f"logits max |diff| {spread:.4g} from the float64 plain run, "
              f"tokens identical {torch.equal(tok32, ref_tokens)}")
        tol = SENSITIVITY_FACTOR * spread
        margins = plain_margins(torch, cfg, params, prompts, ref_tokens,
                                backend)
        compared = compare_tokens(torch, path, tokens, ref_tokens, margins,
                                  tol)
        print(f"[serve:{path}] tolerance {tol:.4g} = {SENSITIVITY_FACTOR:g}"
              f" x {spread:.4g}: kernel prefill logits max |diff| "
              f"{diff:.4g} (ratio {diff / max(spread, 1e-30):.3g}); tokens "
              f"identical over {compared} of {REQUESTS * GEN_LEN} "
              f"(row, step) pairs before the first plain top-2 margin "
              f"below it")
        if diff > tol:
            raise AssertionError(f"{path}: prefill logits differ by "
                                 f"{diff} > {tol}")
        record.update(tolerance=tol, tokens_compared=compared,
                      float32_plain_max_abs_diff=spread,
                      path_calls_worst_error_over_bound=ratio)
    backend.reference = False

    _, warm = serve_batch(cfg, params, prompts, GEN_LEN, backend=backend)
    check_no_weight_copies(path)    # over every run of the path
    warm_ms = (warm["prefill_s"] + warm["decode_s"]) * 1e3
    print(f"[serve:{path}] warm run: prefill {warm['prefill_s'] * 1e3:.3f} "
          f"ms, decode {warm['decode_s'] * 1e3:.3f} ms "
          f"({warm['tok_per_s']:.2f} tok/s, "
          f"{warm['decode_s'] * 1e3 / (GEN_LEN - 1):.3f} ms/step)")
    record.update(warm_prefill_ms=warm["prefill_s"] * 1e3,
                  warm_decode_tok_per_s=warm["tok_per_s"],
                  warm_wall_ms=warm_ms)
    busy_ms = phase_profile(torch, path, serve_batch, cfg, params, prompts,
                            backend)
    print(f"[profile:{path}] device busy {busy_ms:.3f} ms of the warm "
          f"run's {warm_ms:.3f} ms wall: idle share "
          f"{1.0 - busy_ms / warm_ms:.3f}")
    record["device_busy_ms"] = busy_ms
    del plan, backend
    gc.collect()
    torch.cuda.empty_cache()
    return launches, record


def recording_flash(calls):
    """Context: the flash_attention calls of `attention.chunked_attention`
    keep their operands and output in ``calls``; the kernel launches as
    before."""
    import contextlib
    from repro_torch.models import attention as A

    @contextlib.contextmanager
    def ctx():
        orig = A.flash_attention

        def recording(q, k, v, **kw):
            out = orig(q, k, v, **kw)
            calls.append((q, k, v, kw, out))
            return out
        A.flash_attention = recording
        try:
            yield
        finally:
            A.flash_attention = orig
    return ctx()


def checking_matmuls(checked, limits):
    """Context: the first ``limits[kernel]`` calls of `ops.quant_matmul_op`
    and `ops.split_ternary_op` (one forward pass: the prefill) are held bit
    for bit against the plain version on their own inputs as they are made;
    ``checked[kernel]`` is (calls checked, largest M).  The kernels launch
    as before; the plain versions launch nothing."""
    import contextlib
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.quant_matmul import quant_matmul_plain
    from repro_torch.kernels.split_ternary import split_ternary_plain

    def quant_plain(x, w_q, sx, sw):
        return quant_matmul_plain(x, w_q, sx, sw)

    def split_plain(x, w_q, w_p, sx, sw, boundary, bn=128):
        n = w_q.shape[1]
        b_al = min(ops.align_boundary(boundary, ops.block_n(bn, n)), n)
        return split_ternary_plain(x, w_q, w_p, sx, sw, b_al)
    plains = {"quant_matmul": ("quant_matmul_op", quant_plain),
              "split_ternary": ("split_ternary_op", split_plain)}

    def checking(kernel, orig, plain):
        def call(*args, **kw):
            out = orig(*args, **kw)
            n, rows = checked[kernel]
            if n < limits[kernel]:
                want = plain(*args, **kw)
                if not torch.equal(out, want):
                    raise AssertionError(
                        f"{kernel} call {n} of the long prefill (M "
                        f"{args[0].shape[0]}): max |err| "
                        f"{float((out - want).abs().max())} against the "
                        f"plain version")
                checked[kernel] = (n + 1, max(rows, int(args[0].shape[0])))
            return out
        return call

    @contextlib.contextmanager
    def ctx():
        origs = {k: getattr(ops, attr) for k, (attr, _) in plains.items()}
        for k, (attr, plain) in plains.items():
            checked[k] = (0, 0)
            setattr(ops, attr, checking(k, origs[k], plain))
        try:
            yield
        finally:
            for k, (attr, _) in plains.items():
                setattr(ops, attr, origs[k])
    return ctx()


def plain_float64_attention():
    """Context: the plain attention of a ``reference=True`` run evaluates
    the flash kernel's function in float64 (scores, exponentials, sums and
    the PV product; ``p`` still rounded to bf16 before PV) instead of
    float32 -- another valid summation, for the sensitivity run of
    diana_long, as the float32 plain run is for gpu_tc_like."""
    import contextlib
    import torch
    from repro_torch.kernels.flash_attention import PLAIN_Q_BLOCK
    from repro_torch.models import attention as A

    def plain64(q, k, v, *, causal, kv_len):
        B, Sq, KVH, G, hd = q.shape
        Sk = k.shape[1]
        f64 = torch.float64
        kd, vd = k.to(f64), v.to(f64)
        out = torch.empty(q.shape[:-1] + (v.shape[-1],), dtype=q.dtype,
                          device=q.device)
        kpos = torch.arange(Sk, device=q.device)[None, :]
        for q0 in range(0, Sq, PLAIN_Q_BLOCK):
            qb = q[:, q0:q0 + PLAIN_Q_BLOCK].to(f64)
            n = qb.shape[1]
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kd) * hd ** -0.5
            qpos = q0 + torch.arange(n, device=q.device)[:, None]
            mask = torch.ones((n, Sk), dtype=torch.bool, device=q.device)
            if causal:
                mask &= kpos <= qpos
            if kv_len is not None:
                mask &= kpos < kv_len
            s = s.masked_fill(~mask, float("-inf"))
            p = torch.exp(s - s.amax(dim=-1, keepdim=True))
            l = p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]
            acc = torch.einsum("bkgqs,bskd->bqkgd",
                               p.to(v.dtype).to(f64), vd)
            out[:, q0:q0 + n] = (acc / l.clamp_min(1e-30)).to(q.dtype)
            del s, p, acc
        return out

    @contextlib.contextmanager
    def ctx():
        orig = A.attention_plain
        A.attention_plain = plain64
        try:
            yield
        finally:
            A.attention_plain = orig
    return ctx()


def logit_distance(torch, a, b):
    """(max |a - b|, RMS of a - b) over (B, vocab) logits."""
    d = a.double() - b.double()
    return float(d.abs().max()), float(d.pow(2).mean().sqrt())


def phase_long(torch, cfg, params, prompts):
    """diana_long: the long-prompt traffic on the diana artifact of the
    diana phase (module docstring); returns (launches of the kernel run,
    serving record, largest |error| of the prefill's flash calls)."""
    from repro_torch.api import MappingArtifact
    from repro_torch.launch.serve import (check_coverage, kv_cache_for,
                                          plan_mapping_execution,
                                          serve_batch)
    path = "diana_long"
    art = MappingArtifact.load(
        str(ROOT / "build" / "chip_smoke" / f"{cfg.name}_diana.json"))
    t0 = time.perf_counter()
    plan, backend = plan_mapping_execution(params, art)
    check_coverage("serve", backend, require_full=True)
    cfg = kv_cache_for(cfg, art)
    print(f"[serve:{path}] {backend.coverage()} (lower and bind "
          f"{time.perf_counter() - t0:.1f} s)")
    want = dict.fromkeys(KERNELS, 0)
    for kernel, count, _ in path_layers("diana").values():
        want[kernel] += count * GEN_LEN
    want["flash_attention"] = cfg.n_layers      # one per layer, in prefill
    B, P = prompts.shape

    def serve():
        return serve_batch(cfg, params, prompts, GEN_LEN, backend=backend,
                           max_len=LONG_CACHE)

    calls, checked = [], {}
    limits = dict.fromkeys(KERNELS, 0)
    for kernel, count, _ in path_layers("diana").values():
        limits[kernel] += count       # one forward pass: the prefill
    reset_launches()
    with recording_flash(calls), checking_matmuls(checked, limits):
        tokens, stats = serve()
    launches = kernel_launches()
    if launches != want:
        raise AssertionError(f"{path}: launches {launches}, expected "
                             f"{want}")
    check_no_weight_copies(path)
    logits = stats["prefill_logits"]
    if tuple(tokens.shape) != (B, GEN_LEN) or \
            tuple(logits.shape) != (B, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{path}: serving output has the wrong shape "
                             f"or is not finite")
    print(f"[serve:{path}] {B} requests x prompt {P} + gen {GEN_LEN} in a "
          f"{LONG_CACHE}-slot {cfg.kv_cache_dtype} cache: prefill "
          f"{stats['prefill_s'] * 1e3:.3f} ms with the matmul checks inline,"
          f" decode {stats['decode_s'] * 1e3:.3f} ms "
          f"({stats['decode_s'] * 1e3 / (GEN_LEN - 1):.3f} ms/step)")
    print(f"[serve:{path}] launches: " + " ".join(
        f"{k} {v}" for k, v in launches.items() if v) +
        "; weights copied per call: " + ", ".join(
            f"{k} 0" for k in weight_copies()))
    for kernel, (n, rows) in checked.items():
        if n != limits[kernel] or (n and rows != B * P):
            raise AssertionError(f"{path}: {n} {kernel} calls of the "
                                 f"prefill checked (largest M {rows}), "
                                 f"expected {limits[kernel]} at M {B * P}")
    print(f"[serve:{path}] the " + " and the ".join(
        f"{n} {k}" for k, (n, _) in checked.items()) +
        f" calls of the prefill (M {B * P}; the head's M {B}) are "
        f"bit-identical to the plain version on their own inputs")

    if len(calls) != cfg.n_layers:
        raise AssertionError(f"{path}: {len(calls)} flash calls recorded")
    worst_err = worst_ratio = 0.0
    for i, (q, k, v, kw, out) in enumerate(calls):
        err, ratio = check_flash(torch, q, k, v, out, kw["causal"],
                                 kw["kv_len"], f"{path} layer {i}")
        worst_err, worst_ratio = max(worst_err, err), max(worst_ratio, ratio)
    shapes = calls[0]
    print(f"[serve:{path}] the {len(calls)} flash_attention calls of the "
          f"prefill (q {tuple(shapes[0].shape)}, k {tuple(shapes[1].shape)},"
          f" kv_len {shapes[3]['kv_len']}) agree with the plain version on "
          f"their own inputs: max |err| {worst_err:.4g}, at most "
          f"{worst_ratio:.4g} of the bound")
    del calls, shapes
    gc.collect()

    # the kernel run differs from the plain run only in flash's summation
    # order (the matmul kernels are bit-identical to their plain
    # versions); a plain run in float64 attention differs from it by
    # another valid one
    backend.reference = True
    ref_tokens, ref_stats = serve()
    with plain_float64_attention():
        tok64, st64 = serve()
    if kernel_launches() != want:
        raise AssertionError(f"{path}: a plain run launched a kernel")
    ref_logits = ref_stats["prefill_logits"]
    spread, spread_rms = logit_distance(torch, st64["prefill_logits"],
                                        ref_logits)
    diff, diff_rms = logit_distance(torch, logits, ref_logits)
    tol, tol_rms = SENSITIVITY_FACTOR * spread, SENSITIVITY_FACTOR * spread_rms
    # what an output unrelated to the plain run's would give: the plain
    # logits of another request
    other, other_rms = logit_distance(torch, ref_logits.roll(1, dims=0),
                                      ref_logits)
    print(f"[serve:{path}] plain run: prefill "
          f"{ref_stats['prefill_s'] * 1e3:.3f} ms, max |logit| "
          f"{float(ref_logits.abs().max()):.4g}; plain run in float64 "
          f"attention: prefill logits max |diff| {spread:.4g}, RMS "
          f"{spread_rms:.4g} from it, tokens identical "
          f"{torch.equal(tok64, ref_tokens)}; another request's logits: max "
          f"|diff| {other:.4g}, RMS {other_rms:.4g}")
    margins = plain_margins(torch, cfg, params, prompts, ref_tokens,
                            backend, max_len=LONG_CACHE)
    compared = compare_tokens(torch, path, tokens, ref_tokens, margins, tol)
    print(f"[serve:{path}] tolerance {SENSITIVITY_FACTOR:g} x the float64 "
          f"run's distance: max {tol:.4g}, RMS {tol_rms:.4g}; kernel "
          f"prefill logits max |diff| {diff:.4g} (ratio "
          f"{diff / max(spread, 1e-30):.3g}), RMS {diff_rms:.4g} (ratio "
          f"{diff_rms / max(spread_rms, 1e-30):.3g}); tokens identical over "
          f"{compared} of {B * GEN_LEN} (row, step) pairs before the first "
          f"plain top-2 margin below the max tolerance")
    if diff > tol or diff_rms > tol_rms:
        raise AssertionError(f"{path}: prefill logits differ by max {diff} "
                             f"> {tol} or RMS {diff_rms} > {tol_rms}")
    backend.reference = False

    torch.cuda.reset_peak_memory_stats()
    _, warm = serve()
    check_no_weight_copies(path)    # over every run of the path
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[serve:{path}] warm run: prefill {warm['prefill_s'] * 1e3:.3f} "
          f"ms, decode {warm['decode_s'] * 1e3:.3f} ms "
          f"({warm['decode_s'] * 1e3 / (GEN_LEN - 1):.3f} ms/step), peak "
          f"memory {peak:.2f} GiB")
    record = {"checked_prefill_ms": stats["prefill_s"] * 1e3,
              "decode_ms_per_step": stats["decode_s"] * 1e3 / (GEN_LEN - 1),
              "plain_prefill_ms": ref_stats["prefill_s"] * 1e3,
              "warm_prefill_ms": warm["prefill_s"] * 1e3,
              "warm_decode_ms_per_step":
                  warm["decode_s"] * 1e3 / (GEN_LEN - 1),
              "peak_gib": peak, "kv_cache_dtype": cfg.kv_cache_dtype,
              "matmul_calls_checked": {k: n for k, (n, _) in checked.items()},
              "flash_calls_worst_error_over_bound": worst_ratio,
              "max_abs_logit": float(ref_logits.abs().max()),
              "float64_plain_max_abs_diff": spread,
              "float64_plain_rms_diff": spread_rms,
              "other_request_max_abs_diff": other,
              "other_request_rms_diff": other_rms,
              "tolerance": tol, "tolerance_rms": tol_rms,
              "prefill_logits_max_abs_diff": diff,
              "prefill_logits_rms_diff": diff_rms,
              "tokens_compared": compared}
    del plan, backend
    gc.collect()
    torch.cuda.empty_cache()
    return launches, record, worst_err


def phase_profile(torch, path, serve_batch, cfg, params, prompts, backend):
    """Device time by kernel over one more serving run, from
    torch.profiler's device activity (kernels, copies; the host's
    operators are not recorded, which keeps the profiler's own cost low);
    returns the summed device time in ms."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, st = serve_batch(cfg, params, prompts, GEN_LEN, backend=backend)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    wall_ms = (st["prefill_s"] + st["decode_s"]) * 1e3
    print(f"[profile:{path}] profiled run: wall {wall_ms:.3f} ms, device "
          f"kernels {busy_ms:.3f} ms in {sum(e.count for e in rows)} "
          f"launches")
    for e in rows[:12]:
        print(f"[profile:{path}]   {e.self_device_time_total / 1e3:10.3f} "
              f"ms {e.count:7d}x  {e.key[:90]}")
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
    _build.build_all(tuple(KERNELS))
    for kname, log in sorted(_build.PTXAS_REPORT.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {kname}: {line.strip()}")
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    print("kernels: " + " ".join(KERNELS))
    phase_sass(torch)

    def mark(what):
        print(f"[phase] {what} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)
    mark("build")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    worst = phase_kernels(torch, gen)
    mark("kernel checks")
    print(f"[times] bounds from the H100 SXM data sheet (3.35 TB/s, 1979 "
          f"int8 TOP/s and 989 bf16 TFLOP/s dense, at 700 W); this card: "
          f"{smi}")
    entry_launches = phase_packed_entry(torch, gen)
    times = phase_times(torch, gen)
    sweep = phase_split_sweep(torch, gen)
    flash_rec = phase_flash_times(torch, gen)
    mark("kernel times")
    for kernel in KERNELS:
        path = LAUNCH_PATH[kernel]
        if path not in PATHS:
            continue
        for phase in ("decode", "prefill"):
            print_mix(f"per {phase} forward on {path}", kernel,
                      forward_mix(times, path, kernel, phase))

    from repro_torch.configs import base as cfgbase
    from repro_torch.models import transformer as T
    cfg = cfgbase.get("yi-9b")
    dev = torch.device("cuda")
    sgen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    params = T.init_lm(sgen, cfg)
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, "
          f"head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"params {sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B "
          f"(init {time.perf_counter() - t0:.1f} s)")
    prompts = torch.randint(0, cfg.vocab, (REQUESTS, PROMPT_LEN),
                            generator=sgen, device=dev)
    launches, serving = {"entry point": entry_launches}, {}
    for path in PATHS:
        launches[path], serving[path] = phase_serving(
            torch, path, cfg, params, prompts)
        mark(f"serving {path}")
    del prompts
    long_prompts = torch.randint(0, cfg.vocab, (REQUESTS, LONG_PROMPT),
                                 generator=sgen, device=dev)
    launches["diana_long"], serving["diana_long"], long_err = phase_long(
        torch, cfg, params, long_prompts)
    mark("serving diana_long")
    worst["flash_attention"] = max(worst["flash_attention"], long_err)
    # one prefill forward of diana_long makes one flash call per layer
    flash_mix = {key: flash_rec[key] * cfg.n_layers
                 for key in ("ms", "min_ms", "max_ms", "plain_ms",
                             "library_ms", "library_min_ms",
                             "library_max_ms", "bound_ms")}
    flash_mix["bound_by"] = flash_rec["bound_by"]
    print_mix("per prefill forward on diana_long", "flash_attention",
              flash_mix)
    long_mix = {}
    for kernel in ("quant_matmul", "split_ternary"):
        long_mix[kernel] = forward_mix(times, "diana", kernel, "prefill",
                                       LONG_M)
        print_mix("per prefill forward on diana_long", kernel,
                  long_mix[kernel])
    serving["diana_long"]["prefill_forward_mix"] = dict(
        long_mix, flash_attention=flash_mix)
    packed_mix = entry_mix(times)
    print_mix("over the entry-point run", "ternary_packed", packed_mix)
    for m in M_SHAPES:
        print_mix(f"over the entry-point run's M {m} calls",
                  "ternary_packed", entry_mix(times, m))

    records = []
    for kernel, (source, replaces, _) in KERNELS.items():
        path = LAUNCH_PATH[kernel]
        if kernel == "flash_attention":
            mix = flash_mix
        elif kernel == "ternary_packed":
            mix = packed_mix
        else:
            mix = forward_mix(times, path, kernel, "prefill")
        records.append({"name": kernel, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": launches[path][kernel],
                        "max_abs_err": worst[kernel], "ms": mix["ms"],
                        "plain_ms": mix["plain_ms"],
                        "bound_ms": mix["bound_ms"],
                        "bound_by": mix["bound_by"],
                        "library_ms": mix["library_ms"]})
    result = {"kernels": records, "serving": serving,
              "split_sweep_ms": sweep,
              "seconds": time.perf_counter() - t_start}
    out = ROOT / "build" / "chip_smoke" / "result.json"
    out.write_text(json.dumps(result, indent=1))
    print(f"[done] {result['seconds']:.1f} s")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
