"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, at first use, into its own shared library
under ``build/torch_ext/`` at the repository root, named by a hash of the
sources and of the macros its Python module gives it, so an edit rebuilds.
The libraries have a plain C interface (pointers, ints and the CUDA stream
as ``void*``), so the build includes no PyTorch header.  `build_all` starts
one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C signature of each library's launch function
SIGNATURES = {
    # x, w_q (K-major), sx, sw, out, M, N, K, then the decode GEMM's plan
    # (bn, split; M <= 16) and the stream, as every int8 kernel ends
    "quant_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, w_q (K-major), w_packed, sx, sw, out, M, N, K, Kp, boundary, ...
    "split_ternary": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _P],
    # x, w_t (K-major), sx, sw, out, M, N, K, ...
    "ternary_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x_bf16, x_q, w_bf16, w_q (K-major), sx, sw, out, M, N, K, boundary,
    # ...
    "split_precision": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P],
    # x, w_packed, sx, sw, out, M, N, K, Kp, ...
    "ternary_packed": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, o, B, H, KVH, Sq, kv_end, D, Dv, the (b, h, s) strides of
    # q, k, v and o, causal, window (0: none), stream
    "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        *[_L] * 12, _I, _I, _P],
}

_LIBS: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each fresh build
PTXAS_REPORT: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def defines(name: str) -> Dict[str, str]:
    """The macros that kernel ``name``'s module (``repro_torch.kernels.
    <name>``) defines for its source as ``NVCC_DEFINES`` (e.g. the shapes
    to instantiate); none if it defines none."""
    module = importlib.import_module(f"repro_torch.kernels.{name}")
    return dict(getattr(module, "NVCC_DEFINES", {}))


def include_flags(name: str, header: Path) -> list:
    """Write `defines` of ``name`` to ``header`` and return the nvcc flags
    that include it before the source (none if it has no macros)."""
    macros = defines(name)
    if not macros:
        return []
    header.write_text("".join(f"#define {k} {v}\n"
                              for k, v in macros.items()))
    return ["-include", str(header)]


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(defines(name).items())).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all(names: Sequence[str] = tuple(SIGNATURES)) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, all ``nvcc``
    processes in parallel; raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{CSRC}",
               *include_flags(name, tmp.with_suffix(".h")), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        PTXAS_REPORT[name] = log
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: _lib_path(name) for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def launch(name: str, *args) -> None:
    """Call ``<name>_launch(*args)`` and raise if the launch was refused
    (the C side returns ``cudaGetLastError()`` right after the launch)."""
    lib = library(name)
    rc = getattr(lib, f"{name}_launch")(*args)
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({rc})")


def refuse_grad(name: str, *tensors) -> None:
    """Raise when autograd would need a gradient through kernel ``name``:
    the hand-written kernels have no backward pass, and a result written
    by a kernel carries no ``grad_fn``, so the gradient would vanish
    silently.  Called on the card only: on the CPU the wrappers run their
    plain versions, which autograd differentiates."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the {name} kernel has no "
            f"backward pass; call it under torch.no_grad() or on detached "
            f"tensors")
