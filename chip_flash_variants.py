#!/usr/bin/env python3
"""The flash-attention kernel (``src/repro_torch/csrc/flash_attention.cu``)
against an earlier version of its source, on one H100.

    python3 chip_flash_variants.py [--parent DIR]

``DIR`` holds an earlier ``csrc/`` (for example ``git archive <commit>
src/repro_torch/csrc`` unpacked there).  Each source is built with the
port's nvcc flags and its instantiated shapes (`flash_attention.SHAPES`,
which a source from before that list ignores) into
``build/flash_variants/<name>/``, its ptxas report printed per
instantiation (registers, spills), and timed in a process of its own (every library carries its own CUDA runtime), in the order
parent, this, this, parent, so that the two are compared within one call
on one card:

  yi-9b     diana_long's call: B 4, H 32, KVH 4, D 128, Sq 3072 in a
            4096-key cache, kv_len 3072, causal
  zamba2    its long leg's call: B 4, H 32, KVH 32, D 64, Sq = Sk 4096
  h2o       the long leg's call: B 1, H 32, KVH 8, D 120, Sq 8192 in a
            9216-key cache, kv_len 8192, window 4096 (sources with the
            window and D 120 only), and the same without the window
  deepseek  the long leg's call: B 1, H = KVH 16, query / key dim 192,
            value dim 128, Sq 2560 in a 4096-key cache, kv_len 2560
            (sources with a value head dim of their own only)

Times are CUDA-event means over 50 launches after 3 warm-up calls, with
the operands warm in L2.  Each output is held against the plain version
(`flash_attention_plain`) within `flash_error_bound`.  The card's name
and power limit come first.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "flash_variants"
#: (tag, B, H, KVH, D, Dv, Sq, Sk, kv_len, window)
CASES = [("yi-9b", 4, 32, 4, 128, 128, 3072, 4096, 3072, None),
         ("zamba2", 4, 32, 32, 64, 64, 4096, 4096, 4096, None),
         ("h2o", 1, 32, 8, 120, 120, 8192, 9216, 8192, 4096),
         ("h2o", 1, 32, 8, 120, 120, 8192, 9216, 8192, None),
         ("deepseek", 1, 16, 16, 192, 128, 2560, 4096, 2560, None)]
REPS, WARM = 50, 3


def build(sources) -> None:
    """nvcc each ``{name: csrc dir}`` in parallel; print its ptxas report
    per kernel instantiation."""
    from repro_torch.kernels import _build
    procs = {}
    for name, src in sources.items():
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{d}",
               *_build.include_flags("flash_attention", d / "shapes.h"),
               "-o", str(d / "lib.so"), str(d / "flash_attention.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc exit {proc.returncode}\n{log}")
        fn = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = re.search(r"flash_fwd\w*?E(?=v14)", m.group(1))
                fn = fn.group(0) if fn else m.group(1)
            elif fn and ("registers" in line or "spill" in line):
                print(f"[ptxas] {name} {fn}: "
                      f"{line.split(':', 1)[-1].strip()}", flush=True)


def time_source(name: str) -> None:
    import torch
    from repro_torch.kernels._build import SIGNATURES
    from repro_torch.kernels.flash_attention import (flash_attention_plain,
                                                     flash_error_bound)
    d = OUT / name
    lib = ctypes.CDLL(str(d / "lib.so"))
    fn = lib.flash_attention_launch
    src = (d / "flash_attention.cu").read_text()
    windowed = "int window" in src
    value_dim = "int Dv," in src   # the value head dim is an argument
    sig = list(SIGNATURES["flash_attention"])
    if not value_dim:
        del sig[10]
    fn.argtypes = sig if windowed else sig[:-2] + sig[-1:]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for tag, B, H, KVH, D, Dv, sq, sk, kv_len, window in CASES:
        if ((window is not None or D == 120) and not windowed) or \
                (Dv != D and not value_dim):
            continue
        q = torch.randn((B, H, sq, D), generator=gen, device=dev
                        ).to(torch.bfloat16)
        k = torch.randn((B, KVH, sk, D), generator=gen, device=dev
                        ).to(torch.bfloat16)
        v = torch.randn((B, KVH, sk, Dv), generator=gen, device=dev
                        ).to(torch.bfloat16)
        o = torch.empty((B, H, sq, Dv), dtype=torch.bfloat16, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        tail = ((1, window or 0, stream) if windowed else (1, stream))
        dims = (D, Dv) if value_dim else (D,)

        def call():
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    B, H, KVH, sq, kv_len, *dims, *q.stride()[:3],
                    *k.stride()[:3], *v.stride()[:3], *o.stride()[:3], *tail)
            if rc:
                raise RuntimeError(f"{name}: launch returned {rc}")
        for _ in range(WARM):
            call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            call()
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / REPS
        want = flash_attention_plain(q, k, v, causal=True, kv_len=kv_len,
                                     window=window)
        ratio = float(((o.double() - want.double()).abs() / flash_error_bound(
            q, k, v, want, kv_len=kv_len)).max())
        print(f"[time] {name:<6s} {tag:<8s} B={B} H={H} KVH={KVH} D={D} "
              f"Dv={Dv} Sq={sq} Sk={sk} kv_len={kv_len} window={window}: "
              f"{ms:.4f} ms  error / bound {ratio:.4g}", flush=True)
        if ratio > 1:
            raise SystemExit(f"{name} {tag}: output outside the bound")


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_flash_variants: needs a CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--time"]:
        time_source(sys.argv[2])
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a directory holding an earlier csrc/")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    sources = {"this": CSRC}
    if args.parent is not None:
        sources["parent"] = args.parent / "csrc"
    build(sources)
    order = (["parent", "this", "this", "parent"] if "parent" in sources
             else ["this"])
    for name in order:
        rc = subprocess.run([sys.executable, __file__, "--time",
                             name]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
