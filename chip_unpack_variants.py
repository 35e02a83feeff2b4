#!/usr/bin/env python3
"""What the shared-memory unpacking of the 2-bit stream costs in the int8
wgmma GEMM (``src/repro_torch/csrc/int8_wgmma.cuh``), on one H100.

    python3 chip_unpack_variants.py

Builds ternary_packed.cu against textual variants of int8_wgmma.cuh, each
into ``build/unpack_variants/<name>/``, and times its wgmma path (M > 16)
on each, one process per variant (every library carries its own CUDA
runtime), at three shapes: the long prefill's (12288, 4096, 512), and
(512, 4096, 512) and (512, 4096, 11008).  Only ``base`` is the kernel; the
others drop a piece of the consumer warpgroups' unpacking and give wrong
numbers, which the ``equal`` column shows:

  base              the kernel as built by the port
  no_unpack         no unpacking (the B tile is whatever the ring holds)
  ld_st_only        the loads and 16-byte stores of the unpacking, no ALU
  no_decode         no code - 1 decode (SWAR) of the 2-bit codes
  no_transpose      no 4x4 byte transpose
  no_fence          no fence.proxy.async before the named barrier
  no_sync_no_fence  neither the fence nor the named barrier
  stages6           a ring of 6 stages instead of 4

Times are CUDA-event means over 50 launches after 3 warm-up calls, with
the operands warm in L2; the card's name and power limit come first.
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


def variants(h: str) -> dict:
    for piece in (CALL, TRANSPOSE, UNPACK, "constexpr int kStages = 4;"):
        if piece not in h:
            raise SystemExit("int8_wgmma.cuh changed: update the variants")
    fence_sync = CALL.split("\n", 1)[1]
    return {
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


def build(names_texts) -> None:
    from repro_torch.kernels import _build
    procs = {}
    for name, text in names_texts.items():
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        (d / "int8_wgmma.cuh").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{d}", "-o",
               str(d / "lib.so"), str(d / "ternary_packed.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc exit {proc.returncode}\n{log}")
        spills = sum(int(a) for a in re.findall(
            r"(\d+) bytes spill stores", log))
        print(f"[build] {name}: spill stores {spills} bytes", flush=True)


def time_variant(name: str) -> None:
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.ternary_packed import (pack_ternary,
                                                    ternary_packed_plain)
    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    fn = lib.ternary_packed_launch
    fn.argtypes = _build.SIGNATURES["ternary_packed"]
    fn.restype = ctypes.c_int
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


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_unpack_variants: needs a CUDA device", file=sys.stderr)
        return 1
    if len(sys.argv) > 1:
        time_variant(sys.argv[1])
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    texts = variants((CSRC / "int8_wgmma.cuh").read_text())
    build(texts)
    for name in texts:
        rc = subprocess.run([sys.executable, __file__, name]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
