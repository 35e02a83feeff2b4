#!/usr/bin/env python3
"""Where the time of the int8 wgmma GEMM (``src/repro_torch/csrc/
int8_wgmma.cuh``) goes, on one H100: what the shared-memory unpacking of
the 2-bit stream costs, and a per-block timeline of a launch.

    python3 chip_unpack_variants.py [variant ...]   # all by default

Builds a kernel's ``.cu`` against textual variants of int8_wgmma.cuh, each
into ``build/unpack_variants/<name>/``, and times each in a process of its
own (every library carries its own CUDA runtime).

ternary_packed.cu's wgmma path (M > 16), at three shapes: the long
prefill's (12288, 4096, 512), and (512, 4096, 512) and (512, 4096, 11008).
Only ``base`` is the kernel; the others drop a piece of the consumer
warpgroups' unpacking and give wrong numbers, which the ``equal`` column
shows:

  base              the kernel as built by the port
  no_unpack         no unpacking (the B tile is whatever the ring holds)
  ld_st_only        the loads and 16-byte stores of the unpacking, no ALU
  no_decode         no code - 1 decode (SWAR) of the 2-bit codes
  no_transpose      no 4x4 byte transpose
  no_fence          no fence.proxy.async before the named barrier
  no_sync_no_fence  neither the fence nor the named barrier
  stages6           a ring of 6 stages instead of 4

Times are CUDA-event means over 50 launches after 3 warm-up calls, with
the operands warm in L2.

ternary_matmul.cu's wgmma path (`Int8Codes`) at its served prefill call,
M 512 x (4096, 512), with K splits 1, 2, 4 and 8, and at (512, 4096,
4096) unsplit (quant_matmul's call, 128 tiles):

  ternary_matmul    the kernel as built by the port
  timeline          the same, with thread 0 of each block stamping
                    %globaltimer and clock64 at six points: block start,
                    first ``full`` barrier passed, mainloop end, the split
                    epilogue's first cluster barrier passed (its partial
                    tile in shared memory), the end of its DSMEM sums and
                    their stores (unsplit both at the mainloop end), and
                    the block's end (after its stores, or the cluster's
                    last barrier); the record goes to a device buffer at
                    the block's end

Each is timed as ``chip_smoke.py`` times kernels: a CUDA graph of 52
calls, each on the next of 52 copies of the codes (cold in L2), replayed
5 times between CUDA events; the two ms-per-call columns give the
instrumentation's cost.  The timeline prints, per shape and split, the
median over blocks of each span (clock64 converted at the rate the blocks'
own globaltimer spans give), the median launch's span from its first
block's start to its last block's end, the start skew of its blocks, and
the gap from the previous launch's last block end to its first block
start (the launch latency inside the graph, which no block sees).  The
card's name and power limit come first.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "unpack_variants"
SHAPES = [(12288, 4096, 512), (512, 4096, 512), (512, 4096, 11008)]
#: (M, K, N, K split) of the ternary_matmul runs
TIMELINE_CALLS = [(512, 4096, 512, s) for s in (1, 2, 4, 8)] + \
    [(512, 4096, 4096, 1)]
GRAPH_CALLS, REPLAYS = 52, 5

CALL = """        unpack_tile<BN>(b + T::kBBytes, b, lo, threadIdx.x);
        hopper::fence_proxy_async();
        hopper::named_barrier_sync(kConsumerBarrier, kConsumers);"""
TRANSPOSE = """      i8gemm::transpose4x4(decode4(w & 0x03030303u),
                           decode4((w >> 2) & 0x03030303u),
                           decode4((w >> 4) & 0x03030303u),
                           decode4((w >> 6) & 0x03030303u), t);"""
UNPACK = "template <int BN>\n__device__ __forceinline__ void unpack_tile("
COPY4 = ("__device__ __forceinline__ void copy4(uint32_t a, uint32_t b, "
         "uint32_t c, uint32_t d, int (&t)[4]) {\n  t[0] = a; t[1] = b; "
         "t[2] = c; t[3] = d;\n}\n")

# the timeline variant: its anchors in int8_wgmma.cuh and what it adds
TL_SPLIT_END = """        if (n0 + col + c < N) orow[c] = y[c];
    }
  }
  cluster.sync();
}"""
TL_EXCHANGED = "  cluster.sync();\n  const int r_lo"
TL_START = "  uint64_t* empty = full + kStages;\n"
TL_FULL = "    hopper::mbar_wait(&full[s], (kt / kStages) & 1);\n"
TL_MAIN_END = "  hopper::fence_operands(hacc);\n"
TL_SPLIT_CALL = """    split_epilogue<BN, Src>(src, acc, hacc, smem, sws, s, out, M, N, m0, n0,
                            rank, ksplit);
    return;
  }
"""
TL_KERNEL_END = """        if (n + 1 < N) orow[n + 1] = value(4 * j + 2 * r + 1, n + 1, sw2.y);
      }
    }
  }
}
"""
TL_DEFS = r"""
// timeline: thread 0 of each block stamps %globaltimer and clock64 at
// six points into tl_s, and writes one record per block at its end
constexpr unsigned kTimelineSlots = 1u << 16;
__device__ unsigned tl_next;
// block, SM, globaltimer at the 6 points, clock64 at the 6 points
__device__ unsigned long long tl_rec[kTimelineSlots][14];
__shared__ unsigned long long tl_s[12];

__device__ __forceinline__ void tl_stamp(int i) {
  if (threadIdx.x != 0) return;
  unsigned long long g;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
  tl_s[i] = g;
  tl_s[6 + i] = clock64();
}

__device__ __forceinline__ void tl_write() {
  if (threadIdx.x != 0) return;
  unsigned sm;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  const unsigned slot = atomicAdd(&tl_next, 1u);
  if (slot >= kTimelineSlots) return;
  tl_rec[slot][0] = blockIdx.x;
  tl_rec[slot][1] = sm;
  for (int i = 0; i < 12; ++i) tl_rec[slot][2 + i] = tl_s[i];
}

"""
TL_HOST = r"""
extern "C" int timeline_reset() {
  const unsigned zero = 0;
  return static_cast<int>(
      cudaMemcpyToSymbol(i8wgmma::tl_next, &zero, sizeof zero));
}

// copies min(records, max_records) records of 14 u64 to dst; returns the
// number of blocks that wrote one, or -1
extern "C" int timeline_read(void* dst, int max_records) {
  unsigned n = 0;
  if (cudaMemcpyFromSymbol(&n, i8wgmma::tl_next, sizeof n) != cudaSuccess)
    return -1;
  unsigned c = n < i8wgmma::kTimelineSlots ? n : i8wgmma::kTimelineSlots;
  if (c > static_cast<unsigned>(max_records)) c = max_records;
  if (cudaMemcpyFromSymbol(dst, i8wgmma::tl_rec, c * 14ull * 8) !=
      cudaSuccess)
    return -1;
  return static_cast<int>(n);
}
"""
KERNEL_DEF = "template <int BN, class Src>\n__global__ void"


def timeline(h: str) -> str:
    """int8_wgmma.cuh with the timeline's stamps and its host functions."""
    for piece in (TL_SPLIT_END, TL_EXCHANGED, TL_START, TL_FULL,
                  TL_MAIN_END, TL_SPLIT_CALL, TL_KERNEL_END, KERNEL_DEF):
        if h.count(piece) != 1:
            raise SystemExit("int8_wgmma.cuh changed: update the variants")
    split_fn = "// The epilogue of a split-K block"
    if h.count(split_fn) != 1:
        raise SystemExit("int8_wgmma.cuh changed: update the variants")
    h = h.replace(split_fn, TL_DEFS + split_fn)
    h = h.replace(TL_SPLIT_END, TL_SPLIT_END.replace(
        "  cluster.sync();\n}", "  tl_stamp(4);\n  cluster.sync();\n}"))
    h = h.replace(TL_EXCHANGED, TL_EXCHANGED.replace(
        "  const int r_lo", "  tl_stamp(3);\n  const int r_lo"))
    h = h.replace(TL_START, TL_START + "  tl_stamp(0);\n")
    h = h.replace(TL_FULL, TL_FULL + "    if (kt == 0) tl_stamp(1);\n")
    h = h.replace(TL_MAIN_END, TL_MAIN_END + "  tl_stamp(2);\n")
    h = h.replace(TL_SPLIT_CALL, TL_SPLIT_CALL.replace(
        "    return;\n  }\n",
        "    tl_stamp(5);\n    tl_write();\n    return;\n  }\n"
        "  tl_stamp(3);  // no reduction\n  tl_stamp(4);\n"))
    h = h.replace(TL_KERNEL_END, TL_KERNEL_END[:-2] +
                  "  tl_stamp(5);\n  tl_write();\n}\n")
    return h + TL_HOST


def variants(h: str) -> dict:
    """{name: (int8_wgmma.cuh text, the .cu it is built with)}."""
    for piece in (CALL, TRANSPOSE, UNPACK, "constexpr int kStages = 4;"):
        if piece not in h:
            raise SystemExit("int8_wgmma.cuh changed: update the variants")
    fence_sync = CALL.split("\n", 1)[1]
    packed = {
        "base": h,
        "no_unpack": h.replace(CALL, fence_sync),
        "ld_st_only": h.replace(
            "w = __funnelshift_r(w, w, 8 * rot);", "").replace(
            TRANSPOSE, "      t[0] = t[1] = t[2] = t[3] = w;"),
        "no_decode": h.replace(
            "return ((b | 0x80808080u) - 0x01010101u) ^ 0x80808080u;",
            "return b;"),
        "no_transpose": h.replace("i8gemm::transpose4x4(", "copy4(").replace(
            UNPACK, COPY4 + UNPACK),
        "no_fence": h.replace(CALL, CALL.replace(
            "        hopper::fence_proxy_async();\n", "")),
        "no_sync_no_fence": h.replace(CALL, CALL.split("\n", 1)[0]),
        "stages6": h.replace("constexpr int kStages = 4;",
                             "constexpr int kStages = 6;"),
    }
    out = {name: (text, "ternary_packed") for name, text in packed.items()}
    out["ternary_matmul"] = (h, "ternary_matmul")
    out["timeline"] = (timeline(h), "ternary_matmul")
    return out


def build(names_texts) -> None:
    from repro_torch.kernels import _build
    procs = {}
    for name, (text, source) in names_texts.items():
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        (d / "int8_wgmma.cuh").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{d}", "-o",
               str(d / "lib.so"), str(d / f"{source}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc exit {proc.returncode}\n{log}")
        spills = sum(int(a) for a in re.findall(
            r"(\d+) bytes spill stores", log))
        print(f"[build] {name}: spill stores {spills} bytes", flush=True)


def load(name: str, source: str):
    from repro_torch.kernels import _build
    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    fn = getattr(lib, f"{source}_launch")
    fn.argtypes = _build.SIGNATURES[source]
    fn.restype = ctypes.c_int
    return lib, fn


def time_unpack(name: str) -> None:
    import torch
    from repro_torch.kernels.ternary_packed import (pack_ternary,
                                                    ternary_packed_plain)
    _, fn = load(name, "ternary_packed")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for m, k, n in SHAPES:
        x = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        w_p = pack_ternary(torch.randint(-1, 2, (k, n), generator=gen,
                                         device=dev, dtype=torch.int8))
        sx = torch.tensor([0.03], device=dev)
        sw = torch.rand((n,), generator=gen, device=dev)
        out = torch.empty((m, n), device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            rc = fn(x.data_ptr(), w_p.data_ptr(), sx.data_ptr(),
                    sw.data_ptr(), out.data_ptr(), m, n, k, k // 4, 0, 0,
                    stream)   # no decode plan: M > 16
            if rc:
                raise RuntimeError(f"{name}: launch returned {rc}")
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(50):
            call()
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / 50
        equal = torch.equal(out, ternary_packed_plain(x, w_p, sx, sw))
        print(f"[time] {name:<17s} M={m:<6d} K={k} N={n:<6d} {ms:.4f} ms  "
              f"equal to the plain version {equal}", flush=True)


def median(xs):
    ys = sorted(xs)
    return ys[len(ys) // 2] if len(ys) % 2 else \
        (ys[len(ys) // 2 - 1] + ys[len(ys) // 2]) / 2


#: the spans between the timeline's six points (split: the second and
#: third are the partial tile's store to shared memory and the first
#: cluster barrier, then the DSMEM sums and their stores; unsplit both are
#: 0 and the last is the stores)
SPANS = ("prologue to first full", "mainloop", "partial tile + barrier",
         "DSMEM sums + stores", "stores / last barrier")


def spans(rows, blocks):
    """The timeline's medians (us) from ``rows`` (block, SM, globaltimer x
    6, clock64 x 6 per block, in the order the blocks ended) of launches of
    ``blocks`` blocks, GRAPH_CALLS launches per replay."""
    last = len(SPANS)
    g = [r[2:2 + last + 1] for r in rows]
    c = [r[3 + last:] for r in rows]
    # clock64 cycles per ns, from the blocks' own spans (globaltimer may
    # tick coarsely; the sum over all blocks does not)
    rate = sum(b[last] - b[0] for b in c) / max(
        1, sum(b[last] - b[0] for b in g))
    out = {nm: median([(b[i + 1] - b[i]) / rate / 1e3 for b in c])
           for i, nm in enumerate(SPANS)}
    out["block total"] = median([(b[last] - b[0]) / rate / 1e3 for b in c])
    launches = [g[i:i + blocks] for i in range(0, len(g), blocks)]
    out["launch span"] = median([(max(b[last] for b in L) -
                                  min(b[0] for b in L)) / 1e3
                                 for L in launches])
    out["start skew"] = median([(max(b[0] for b in L) -
                                 min(b[0] for b in L)) / 1e3
                                for L in launches])
    out["launch gap"] = median([
        (min(b[0] for b in launches[i + 1]) -
         max(b[last] for b in launches[i])) / 1e3
        for i in range(len(launches) - 1)
        if (i + 1) % GRAPH_CALLS])
    out["clock GHz"] = rate
    return out


def time_timeline(name: str) -> None:
    """ternary_matmul's wgmma path at TIMELINE_CALLS: graph ms per call,
    bit-exactness, and (the ``timeline`` variant) the per-span medians."""
    import torch
    from repro_torch.kernels.ternary_matmul import ternary_matmul_plain
    lib, fn = load(name, "ternary_matmul")
    stamps = name == "timeline"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for m, k, n, split in TIMELINE_CALLS:
        x = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        w_t = torch.randint(-1, 2, (k, n), generator=gen, device=dev,
                            dtype=torch.int8)
        ring = [w_t.t().contiguous() for _ in range(GRAPH_CALLS)]
        sx = torch.tensor([0.03], device=dev)
        sw = torch.rand((n,), generator=gen, device=dev)
        out = torch.empty((m, n), device=dev)

        def call(w):
            # the current stream: a graph captures on a stream of its own
            rc = fn(x.data_ptr(), w.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                    out.data_ptr(), m, n, k, 0, split,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: launch returned {rc}")
        for w in ring[:2]:
            call(w)
        torch.cuda.synchronize()
        equal = torch.equal(out, ternary_matmul_plain(x, w_t, sx, sw))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for w in ring:
                call(w)
        graph.replay()
        torch.cuda.synchronize()
        if stamps and lib.timeline_reset():
            raise RuntimeError("timeline_reset failed")
        ms = []
        for _ in range(REPLAYS):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            stop.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(stop) / GRAPH_CALLS)
        line = (f"[timeline] {name:<14s} M={m} K={k} N={n:<5d} split {split}:"
                f" {median(ms) * 1e3:.2f} us per call in a graph "
                f"({min(ms) * 1e3:.2f}-{max(ms) * 1e3:.2f}); equal to the "
                f"plain version {equal}")
        if stamps:
            tiles = -(-m // 128) * -(-n // 128)   # BN 128 at these shapes
            blocks = tiles * split
            want = blocks * GRAPH_CALLS * REPLAYS
            width = 2 + 2 * (len(SPANS) + 1)
            buf = (ctypes.c_ulonglong * (width * want))()
            got = lib.timeline_read(buf, want)
            if got != want:
                raise RuntimeError(f"timeline: {got} records, expected "
                                   f"{want}")
            rows = [buf[width * i:width * (i + 1)] for i in range(want)]
            sp = spans(rows, blocks)
            line += "\n[timeline]   " + "; ".join(
                f"{key} {val:.3f}" + ("" if key == "clock GHz" else " us")
                for key, val in sp.items()) + f" ({blocks} blocks)"
        print(line, flush=True)
        del graph, ring


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_unpack_variants: needs a CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--time"]:
        name = sys.argv[2]
        if name in ("ternary_matmul", "timeline"):
            time_timeline(name)
        else:
            time_unpack(name)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    texts = variants((CSRC / "int8_wgmma.cuh").read_text())
    names = sys.argv[1:] or list(texts)
    unknown = [n for n in names if n not in texts]
    if unknown:
        print(f"chip_unpack_variants: unknown variants {unknown}; known: "
              f"{list(texts)}", file=sys.stderr)
        return 2
    build({name: texts[name] for name in names})
    for name in names:
        rc = subprocess.run([sys.executable, __file__, "--time",
                             name]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
