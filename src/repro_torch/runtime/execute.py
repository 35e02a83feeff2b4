"""Per-layer executors for `ExecutionPlan`s (``repro.runtime.execute``
counterpart).

`prepare_layer` binds one `LayerPlan` to a concrete weight once: the
plan's channel permutation and its inverse, per-domain weight quantization
with the plan's scales (each active quantized domain's columns carry that
domain's own step), the 2-bit-packed ternary stream of the split_ternary
kernel, the bf16 weight of the split_precision kernel, the K-major layout
of every int8 kernel's codes (a ``(K, N)`` view of a contiguous ``(N, K)``
tensor), and the static activation scale.  `execute_layer` then
only quantizes the activations and calls the kernel -- the CUDA kernel for
tensors on the card, its plain version for tensors on the CPU -- or, with
``reference=True``, the oracles of `kernels.ref`; outputs come back in the
original channel order.

`PlannedBackend` binds a plan to a params dict by layer name and serves the
name-keyed matmul-backend protocol of `repro_torch.models._backend`.
Stacked ``base@r`` layers bind to a list of per-repeat prepared layers,
indexed by the repeat the model's layer loop publishes.

Every plan kernel executes: ``quant_matmul``, ``ternary_matmul`` and
``split_ternary`` (the DIANA plans), ``split_precision`` (int8 + identity
platforms such as ``gpu_tc_like``) and the ``fp`` identity, on 2-D dense
weights.  Conv and grouped layers and multi-variant banks (``PlanSet``)
wait for later slices; conv and grouped layers are refused at bind time.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.kernels import ops, ref
from repro_torch.kernels.quant_matmul import _pad_to
from repro_torch.kernels.ternary_packed import pack_ternary
from repro_torch.models import _backend
from repro_torch.runtime.lower import _layer_weight, _walk_path
from repro_torch.runtime.plan import (KERNEL_FP, KERNEL_QUANT, KERNEL_SPLIT,
                                      KERNEL_SPLIT_TERNARY, KERNEL_TERNARY,
                                      ExecutionPlan, LayerPlan)


class ExecutionError(RuntimeError):
    """A planned layer cannot be executed as lowered."""


@dataclasses.dataclass
class PreparedLayer:
    """A `LayerPlan` bound to concrete tensors, ready to execute."""
    plan: LayerPlan
    inv: torch.Tensor                    # inverse channel permutation
    w_perm: torch.Tensor | None          # permuted weight (fp kernel only)
    b: torch.Tensor | None               # bias, ORIGINAL channel order
    w_q: torch.Tensor | None             # int8 codes, permuted (K, N)
    sw: torch.Tensor | None              # (N,) per-column step, f32
    w_t_packed: torch.Tensor | None = None   # split_ternary packed codes
    w_bf16: torch.Tensor | None = None       # split_precision bf16 weight
    act_scale: torch.Tensor | None = None    # exp(act_log_scale), f32
    act_sx: torch.Tensor | None = None       # activation step, f32
    boundary: int = 0                    # raw split boundary
    bn: int = 128                        # N-block the boundary aligns to


def _quant_domain(lp: LayerPlan, domain_bits: List[int]) -> int:
    """Index of the first active quantized domain."""
    quantized = [i for i in lp.active_domains() if domain_bits[i] < 16]
    if not quantized:
        raise ExecutionError(f"{lp.name}: no quantized domain for kernel "
                             f"{lp.kernel}")
    return quantized[0]


def _per_column_quant(lp: LayerPlan, wf: torch.Tensor,
                      domain_bits: List[int]):
    """(w_q int8 codes, sw (N,) f32 steps) in PERMUTED column order: each
    active quantized domain's columns are quantized with that domain's own
    ``w_log_scales`` entry and bit-width; identity columns inherit the
    driving quantized domain's codes."""
    drive = _quant_domain(lp, domain_bits)
    if lp.w_log_scales is not None:
        ls_of = lambda d: float(lp.w_log_scales[d])
    else:  # lowered without scales: max-abs of the bound weight
        ls = float(quant.init_log_scale(wf))
        ls_of = lambda d: ls
    col_ls = np.zeros(lp.c_out, np.float32)
    col_levels = np.ones(lp.c_out, np.float32)
    start = 0
    for d, c in enumerate(lp.counts):
        if c:
            src = d if domain_bits[d] < 16 else drive
            col_ls[start:start + c] = ls_of(src)
            col_levels[start:start + c] = quant.qlevels(
                min(int(domain_bits[src]), 8))
        start += c
    scale = torch.from_numpy(np.exp(col_ls)).to(wf.device)
    levels = torch.from_numpy(col_levels).to(wf.device)
    w_q = torch.round(torch.clamp(wf / scale[None, :], -1.0, 1.0) *
                      levels[None, :]).to(torch.int8)
    return w_q, (scale / levels).to(torch.float32)


def _pack_ternary_stream(lp: LayerPlan, w_q: torch.Tensor) -> torch.Tensor:
    """2-bit-pack the ternary-domain columns of the codes (int8 columns
    zeroed; the kernel never reads them from this stream), K padded up to a
    multiple of 4 with code 0."""
    cols = torch.arange(w_q.shape[1], device=w_q.device)[None, :]
    w_t = torch.where(cols >= lp.split_boundary(), w_q,
                      torch.zeros((), dtype=torch.int8, device=w_q.device))
    return pack_ternary(_pad_to(w_t, 4, 0))


def prepare_layer(lp: LayerPlan, w, b=None,
                  domain_bits: List[int] | None = None,
                  block_n: int = 128) -> PreparedLayer:
    """Bind ``lp`` to a 2-D ``(C_in, C_out)`` weight (+ optional bias);
    every plan kernel binds (`LayerPlan` admits no other)."""
    if getattr(w, "ndim", 0) != 2 or lp.groups > 1:
        raise ExecutionError(f"{lp.name}: conv weights and grouped layers "
                             f"wait for a later slice of the port (weight "
                             f"shape {tuple(getattr(w, 'shape', ()))}, "
                             f"groups={lp.groups})")
    if int(w.shape[-1]) != lp.c_out:
        raise ExecutionError(f"{lp.name}: weight has {int(w.shape[-1])} "
                             f"output channels, plan expects {lp.c_out}")
    if domain_bits is None:
        domain_bits = [8] * len(lp.counts)
    bn = int((lp.tuning or {}).get("bn", block_n))
    if bn < 1:
        raise ExecutionError(f"{lp.name}: invalid kernel tuning {lp.tuning}")
    dev = w.device
    w_perm = torch.index_select(w, 1, torch.from_numpy(lp.perm).to(dev))
    w_q = sw = w_t_packed = w_bf16 = act_scale = act_sx = None
    if lp.kernel != KERNEL_FP:
        w_q, sw = _per_column_quant(lp, w_perm.to(torch.float32),
                                    domain_bits)
        if lp.kernel == KERNEL_SPLIT:
            w_bf16 = w_perm.to(torch.bfloat16)
        w_perm = None          # the quantized kernels never read it
    if lp.kernel == KERNEL_SPLIT_TERNARY:
        w_t_packed = _pack_ternary_stream(lp, w_q)
    if w_q is not None:
        # every int8 kernel reads its codes K-major: one (N, K) copy, held
        # as its (K, N) transposed view
        w_q = w_q.t().contiguous().t()
    if lp.act_log_scale is not None:
        act_scale = torch.tensor(np.exp(lp.act_log_scale),
                                 dtype=torch.float32, device=dev)
        act_sx = (act_scale / quant.qlevels(8)).to(torch.float32)
    return PreparedLayer(
        plan=lp, inv=torch.from_numpy(lp.inv_perm()).to(dev), w_perm=w_perm,
        b=b, w_q=w_q, sw=sw, w_t_packed=w_t_packed, w_bf16=w_bf16,
        act_scale=act_scale, act_sx=act_sx, boundary=lp.split_boundary(),
        bn=bn)


def _act_quant(xf: torch.Tensor, prep: PreparedLayer):
    """(x_q int8, sx step): the prepared static scale when one was lowered,
    else dynamic max-abs."""
    if prep.act_scale is not None:
        scale, sx = prep.act_scale, prep.act_sx
    else:
        scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-8)
        sx = (scale / quant.qlevels(8)).to(torch.float32)
    x_q = torch.round(torch.clamp(xf / scale, -1.0, 1.0) *
                      quant.qlevels(8)).to(torch.int8)
    return x_q, sx


def execute_layer(prep: PreparedLayer, x, *,
                  reference: bool = False) -> torch.Tensor:
    """Run ``x (..., C_in)`` through the prepared layer's kernel; returns
    ``(..., C_out)`` in the original channel order, bias applied, in
    ``x.dtype``.  ``reference=True`` runs the plain oracles instead."""
    lp = prep.plan
    wk = prep.w_perm if prep.w_perm is not None else prep.w_q
    if int(x.shape[-1]) != int(wk.shape[0]):
        raise ExecutionError(f"{lp.name}: input has {int(x.shape[-1])} "
                             f"features, weight expects {int(wk.shape[0])}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    xf = x2.to(torch.float32)
    # the ops clamp the N-block and round the boundary up to it; the
    # oracles split at the same column
    b_al = ops.align_boundary(prep.boundary, ops.block_n(prep.bn, lp.c_out))
    if lp.kernel == KERNEL_FP:
        y = xf @ prep.w_perm.to(torch.float32)
    elif lp.kernel in (KERNEL_QUANT, KERNEL_TERNARY):
        x_q, sx = _act_quant(xf, prep)
        if lp.kernel == KERNEL_TERNARY:
            fn = ref.ternary_matmul_ref if reference else \
                ops.ternary_matmul_op
        else:
            fn = ref.quant_matmul_ref if reference else ops.quant_matmul_op
        y = fn(x_q, prep.w_q, sx, prep.sw)
    elif lp.kernel == KERNEL_SPLIT_TERNARY:
        x_q, sx = _act_quant(xf, prep)
        if reference:
            y = ref.split_ternary_matmul_ref(x_q, prep.w_q, prep.w_q, sx,
                                             prep.sw, b_al)
        else:
            y = ops.split_ternary_op(x_q, prep.w_q, prep.w_t_packed, sx,
                                     prep.sw, prep.boundary, bn=prep.bn)
    else:  # KERNEL_SPLIT (prepare_layer admits nothing else)
        x_q, sx = _act_quant(xf, prep)
        xb = x2.to(torch.bfloat16)
        if reference:
            y = ref.split_precision_matmul_ref(xb, x_q, sx, prep.w_bf16,
                                               prep.w_q, prep.sw, b_al)
        else:
            y = ops.split_precision_op(xb, x_q, sx, prep.w_bf16, prep.w_q,
                                       prep.sw, prep.boundary, bn=prep.bn)
    y = torch.index_select(y, -1, prep.inv)
    if prep.b is not None:
        y = y + prep.b.to(y.dtype)
    return y.reshape(*lead, lp.c_out).to(x.dtype)


def _node_weight_ok(node) -> bool:
    w = _layer_weight(node)
    return isinstance(node, dict) and isinstance(w, torch.Tensor) \
        and w.dim() == 2 and not w.is_meta


class PlannedBackend:
    """One `ExecutionPlan` bound to a params dict, as a name-keyed matmul
    backend: ``backend(name, p, x)`` runs the planned kernel of layer
    ``name`` (stacked layers: of the repeat published by
    `_backend.scan_slot`) or returns None for layers the plan does not
    cover.  ``reference=True`` executes the plain oracles instead of the
    kernels (attribute; may be flipped between runs); it also selects the
    flash kernel's plain version in `attention.chunked_attention`.  Layers the plan
    names but the params cannot bind are listed in ``unbound``."""

    def __init__(self, plan: ExecutionPlan, params, *,
                 reference: bool = False):
        self.plan = plan
        self.reference = reference
        domain_bits = [int(d["weight_bits"]) for d in plan.domains]
        prep = lambda lp, node: prepare_layer(
            lp, _layer_weight(node), b=node.get("b"),
            domain_bits=domain_bits, block_n=plan.block_n)
        self._by_name: Dict[str, Any] = {}
        self.bound: List[str] = []
        self.unbound: List[str] = []
        stacked: Dict[str, List[Tuple[int, LayerPlan, Any]]] = {}
        for lp in plan.layers:
            node = _walk_path(params, lp.name)
            base, _, rep = lp.name.partition("@")
            if rep:
                stacked.setdefault(base, []).append((int(rep), lp, node))
            elif _node_weight_ok(node):
                self._by_name[lp.name] = prep(lp, node)
                self.bound.append(lp.name)
            else:
                self.unbound.append(lp.name)
        for base, entries in sorted(stacked.items()):
            entries.sort(key=lambda e: e[0])
            reps = [r for r, _, _ in entries]
            if reps != list(range(len(reps))):
                raise ExecutionError(
                    f"{base}: stacked plan repeats {reps} are not the "
                    f"contiguous range 0..{len(reps) - 1}")
            stack_w = _layer_weight(_walk_path(params, base))
            if getattr(stack_w, "ndim", 0) == 3 and \
                    int(stack_w.shape[0]) != len(reps):
                raise ExecutionError(
                    f"{base}: plan covers {len(reps)} repeats but the "
                    f"stacked weight carries {int(stack_w.shape[0])} -- the "
                    f"artifact does not match this model's layer stack")
            if not all(_node_weight_ok(node) for _, _, node in entries):
                self.unbound.extend(lp.name for _, lp, _ in entries)
                continue
            self._by_name[base] = [prep(lp, node) for _, lp, node in entries]
            self.bound.extend(lp.name for _, lp, _ in entries)

    def coverage(self) -> str:
        return (f"{len(self.bound)}/{len(self.plan.layers)} planned layers "
                f"bound to weights, {len(self.unbound)} unbound")

    def __call__(self, name, p, x):
        if name is None:
            return None
        entry = self._by_name.get(name)
        if entry is None:
            return None
        if isinstance(entry, list):
            r = _backend.current_scan_index()
            if r is None:
                raise ExecutionError(
                    f"{name}: stacked plan executed outside a scan_slot "
                    f"context (no repeat index to select the layer)")
            entry = entry[r]
        return execute_layer(entry, x, reference=self.reference)
