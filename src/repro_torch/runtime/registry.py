"""Capability-keyed kernel registry: which fused kernel executes a layer
whose ACTIVE domains have a given weight-bit signature.

`lower()` used to hardcode an if/elif ladder over bit-widths; adding a
pairing (e.g. the DIANA ternary+int8 mixed layer) meant edits across
lower/plan/execute.  The registry replaces the ladder with one table:

    key:   tuple of BIT CLASSES in PLAN (domain) order —
             "t"  ternary        (weight_bits == 2)
             "q"  int-quantized  (2 < weight_bits <= 8)
             "f"  identity       (weight_bits >= 16)
    value: a `KernelCapability` naming the plan-level kernel.

Built-in registrations:

    ("q",)      quant_matmul       ("t",)  ternary_matmul   ("f",)  fp
    ("q", "f")  split_precision    (int8 cols | identity cols)
    ("q", "t")  split_ternary      (int8 cols | 2-bit-packed ternary cols)

A new pairing is ONE ``register_kernel`` call; `kernel_for` turns a layer's
active bit-widths into ``(kernel, note)`` with ordering hints when only the
flipped key is registered (the fused kernels fix which domain owns the low
columns).  Introspection: `capability_matrix()` renders the table for docs
and `Platform.kernel_capabilities()` projects it onto a platform's domain
pairs.  The table is the JAX package's, row for row, so both packages
lower an artifact to the same plan.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.runtime.plan import (KERNEL_FP, KERNEL_QUANT, KERNEL_SPLIT,
                                KERNEL_SPLIT_TERNARY, KERNEL_TERNARY, KERNELS)

#: bit-class codes -> human description (doc rendering)
BIT_CLASSES = {"t": "ternary (2-bit)", "q": "int (3..8-bit)",
               "f": "identity (>=16-bit)"}


def bit_class(bits: int) -> str | None:
    """Canonical capability class of a weight bit-width (None: no kernel
    covers this width — e.g. 1-bit or 9..15-bit domains)."""
    bits = int(bits)
    if bits == 2:
        return "t"
    if 2 < bits <= 8:
        return "q"
    if bits >= 16:
        return "f"
    return None


@dataclasses.dataclass(frozen=True)
class KernelCapability:
    """One registry row: a bit-class key executed by a named kernel."""
    key: Tuple[str, ...]
    kernel: str
    description: str = ""


_REGISTRY: Dict[Tuple[str, ...], KernelCapability] = {}


def register_kernel(key: Sequence[str], kernel: str, description: str = "",
                    overwrite: bool = False) -> KernelCapability:
    """Register ``kernel`` (a `repro_torch.runtime.plan` kernel name) for layers
    whose active domains match ``key`` (bit classes in plan order)."""
    key = tuple(key)
    for cls in key:
        if cls not in BIT_CLASSES:
            raise ValueError(f"unknown bit class {cls!r} in {key} "
                             f"(known: {sorted(BIT_CLASSES)})")
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r} (known: {KERNELS})")
    if key in _REGISTRY and not overwrite:
        raise ValueError(f"capability {key} already registered to "
                         f"{_REGISTRY[key].kernel!r} (pass overwrite=True)")
    cap = KernelCapability(key=key, kernel=kernel, description=description)
    _REGISTRY[key] = cap
    return cap


def unregister_kernel(key: Sequence[str]) -> None:
    _REGISTRY.pop(tuple(key), None)


def registered() -> List[KernelCapability]:
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def _bits_text(bits: Sequence[int]) -> str:
    return " + ".join(f"{int(b)}-bit" for b in bits)


def kernel_for(bits: Sequence[int]) -> Tuple[str, str]:
    """(kernel, note) for a layer from its ACTIVE domains' weight bit-widths
    in plan order.  ``note`` is non-empty iff no registered kernel covers
    the signature and the layer must fall back to fp."""
    bits = [int(b) for b in bits]
    if not bits:
        return KERNEL_FP, "no channels assigned"
    classes = tuple(bit_class(b) for b in bits)
    if None in classes:
        bad = bits[classes.index(None)]
        return KERNEL_FP, f"no kernel for {bad}-bit weights"
    cap = _REGISTRY.get(classes)
    if cap is not None:
        return cap.kernel, ""
    flipped = _REGISTRY.get(tuple(reversed(classes)))
    if flipped is not None:
        return KERNEL_FP, (
            f"{flipped.kernel} needs the {BIT_CLASSES[flipped.key[0]]} "
            f"domain ordered before the {BIT_CLASSES[flipped.key[1]]} "
            f"domain (got {_bits_text(bits)})")
    if len(classes) > 2:
        return KERNEL_FP, (f"{len(classes)} active domains "
                           f"({_bits_text(bits)}) exceed the fused kernels")
    return KERNEL_FP, f"no fused kernel for {_bits_text(bits)} domains"


def capability_matrix() -> List[str]:
    """The registry rendered as aligned text rows (doc embedding)."""
    rows = []
    for cap in registered():
        sig = " | ".join(BIT_CLASSES[c] for c in cap.key)
        rows.append(f"{sig:<44} -> {cap.kernel:<16} {cap.description}")
    return rows


# --------------------------------------------------------------------------
# built-in capabilities (one line per kernel — THE place new pairings land)
# --------------------------------------------------------------------------

register_kernel(("f",), KERNEL_FP, "single identity domain, no quant")
register_kernel(("q",), KERNEL_QUANT, "w8a8, int32 accumulate")
register_kernel(("t",), KERNEL_TERNARY, "codes in {-1,0,+1}, int8 path")
register_kernel(("q", "f"), KERNEL_SPLIT,
                "fused int8 cols | bf16 cols (paper Fig. 3)")
register_kernel(("q", "t"), KERNEL_SPLIT_TERNARY,
                "fused int8 cols | 2-bit-packed ternary cols (DIANA)")
