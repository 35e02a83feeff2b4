"""`ExecutionPlan`: the lowered, executable form of a mapping artifact.

Where a `MappingArtifact` records *what the search decided* (a domain index
per output channel), an `ExecutionPlan` records *how to run it*: per layer,
the stable channel permutation that makes same-domain channels contiguous
(paper Fig. 3), the resulting cumulative domain boundaries both raw and
rounded up to the kernels' N-block size (`kernels.ops` alignment rule), the
weight/activation quantization scales, and the kernel that executes the
layer:

    "split_precision"   fused two-domain matmul (int8 cols | identity cols)
    "split_ternary"     fused two-domain matmul (int8 cols | 2-bit-packed
                        ternary cols — the DIANA digital+AIMC pairing)
    "quant_matmul"      single quantized domain, w8a8 int32-accumulate
    "ternary_matmul"    single 2-bit domain, codes in {-1, 0, +1}
    "fp"                identity fallback (reason recorded in ``note``)

The kernel choice is driven by the capability registry in
`repro_torch.runtime.registry` — new (bits, bits) pairings are one
``register_kernel`` call, not edits across lower/plan/execute.

Plans serialize to JSON (schema v2, shared with the artifact's
``schema_version``) so a lowered mapping can ship alongside its artifact:

    {"schema_version": 2, "model": ..., "platform": ..., "block_n": 128,
     "domains": [{"name", "weight_bits", "act_bits"}, ...],
     "layers": [{"name", "kernel", "c_in", "c_out", "perm": [...],
                 "counts": [...], "boundaries": [...],
                 "aligned_boundaries": [...], "w_log_scales": [...] | null,
                 "act_log_scale": float | null, "searchable": bool,
                 "note": str, "groups": int}, ...]}

``groups`` > 1 marks a grouped/depthwise conv layer: the executors
zero-embed its per-group weight into a block-diagonal dense matrix at bind
time so it runs through the same im2col'd kernels (the port's conv
execution waits for a later slice).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

PLAN_SCHEMA_VERSION = 2

KERNEL_SPLIT = "split_precision"
KERNEL_SPLIT_TERNARY = "split_ternary"
KERNEL_QUANT = "quant_matmul"
KERNEL_TERNARY = "ternary_matmul"
KERNEL_FP = "fp"
KERNELS = (KERNEL_SPLIT, KERNEL_SPLIT_TERNARY, KERNEL_QUANT, KERNEL_TERNARY,
           KERNEL_FP)


class LoweringError(ValueError):
    """An artifact cannot be lowered onto the given model/kernels."""


@dataclasses.dataclass
class LayerPlan:
    """Execution recipe for one ODiMO-managed layer."""
    name: str
    kernel: str                       # one of KERNELS
    c_in: int
    c_out: int
    perm: np.ndarray                  # (C_out,) stable domain-grouping perm
    counts: List[int]                 # channels per domain (plan order)
    boundaries: List[int]             # cumulative domain boundaries, raw
    aligned_boundaries: List[int]     # rounded up to block_n (ops.py rule)
    w_log_scales: List[float] | None  # per-domain weight quant log-scales
    act_log_scale: float | None       # activation log-scale (None = dynamic)
    searchable: bool = True
    note: str = ""                    # e.g. why the fp fallback was chosen
    tuning: Dict[str, int] | None = None  # kernel block sizes: bm/bn/bk
    groups: int = 1                   # grouped/depthwise conv group count

    def __post_init__(self):
        self.perm = np.asarray(self.perm, dtype=np.int64)
        if self.kernel not in KERNELS:
            raise LoweringError(f"{self.name}: unknown kernel {self.kernel!r}"
                                f" (known: {KERNELS})")

    def inv_perm(self) -> np.ndarray:
        """Inverse permutation: planned-order outputs -> original order."""
        return np.argsort(self.perm)

    def active_domains(self) -> List[int]:
        """Domain indices that actually own channels in this layer."""
        return [i for i, c in enumerate(self.counts) if c > 0]

    def split_boundary(self) -> int:
        """First column of the LAST active domain (the split kernel's
        int8/identity boundary when exactly two domains are active)."""
        act = self.active_domains()
        if len(act) < 2:
            return self.c_out
        return int(sum(self.counts[: act[-1]]))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["perm"] = [int(v) for v in self.perm]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "LayerPlan":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


@dataclasses.dataclass
class ExecutionPlan:
    """A fully lowered mapping: one `LayerPlan` per artifact layer."""
    model: str
    domains: List[Dict[str, Any]]
    layers: List[LayerPlan]
    platform: str | None = None
    block_n: int = 128
    schema_version: int = PLAN_SCHEMA_VERSION

    @property
    def n_domains(self) -> int:
        return len(self.domains)

    def __getitem__(self, name: str) -> LayerPlan:
        for lp in self.layers:
            if lp.name == name:
                return lp
        raise KeyError(name)

    def kernel_histogram(self) -> Dict[str, int]:
        hist: Dict[str, int] = {}
        for lp in self.layers:
            hist[lp.kernel] = hist.get(lp.kernel, 0) + 1
        return hist

    def fallback_reasons(self) -> Dict[str, List[str]]:
        """``{note: [layer names]}`` for every layer that recorded a note —
        the capability fp fallbacks a coverage report should surface."""
        out: Dict[str, List[str]] = {}
        for lp in self.layers:
            if lp.note:
                # lower() prefixes notes with the layer name; strip it so
                # layers sharing a reason group into one report line
                reason = lp.note.removeprefix(f"{lp.name}: ")
                out.setdefault(reason, []).append(lp.name)
        return out

    def histogram_lines(self) -> List[str]:
        """Human-readable per-kernel layer histogram + decline reasons (the
        ``serve --mapping`` / ``dryrun --mapping`` at-a-glance report)."""
        hist = self.kernel_histogram()
        lines = ["kernel histogram: " +
                 " ".join(f"{k}:{v}" for k, v in sorted(hist.items()))]
        for note, names in sorted(self.fallback_reasons().items()):
            shown = ", ".join(names[:6]) + (" ..." if len(names) > 6 else "")
            lines.append(f"  fallback x{len(names)} ({note}): {shown}")
        return lines

    def summary(self) -> str:
        hist = " ".join(f"{k}:{v}"
                        for k, v in sorted(self.kernel_histogram().items()))
        return (f"ExecutionPlan({self.model}, platform={self.platform}, "
                f"{len(self.layers)} layers, {hist})")

    # ---- (de)serialization ----------------------------------------------

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["layers"] = [lp.to_dict() for lp in self.layers]
        return d

    def to_json(self, indent: int | None = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "ExecutionPlan":
        d = dict(d)
        version = d.pop("schema_version", PLAN_SCHEMA_VERSION)
        if version > PLAN_SCHEMA_VERSION:
            raise ValueError(f"execution plan schema v{version} is newer "
                             f"than supported v{PLAN_SCHEMA_VERSION}")
        d["layers"] = [LayerPlan.from_dict(l) for l in d.get("layers", [])]
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(schema_version=version,
                   **{k: v for k, v in d.items() if k in fields})

    @classmethod
    def from_json(cls, s: str) -> "ExecutionPlan":
        return cls.from_dict(json.loads(s))

    def save(self, path) -> Path:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.to_json())
        return p

    @classmethod
    def load(cls, path) -> "ExecutionPlan":
        return cls.from_json(Path(path).read_text())
