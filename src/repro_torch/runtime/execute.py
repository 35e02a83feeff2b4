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

Both 2-D dense weights and 4-D HWIO conv weights bind: a conv weight is
flattened to ``(kh*kw*C_in, C_out)`` and runs through
`execute_conv_layer`, which im2cols the NHWC input onto the same kernels;
a grouped (depthwise) conv weight is first zero-embedded into its
block-diagonal full form (`_expand_grouped`).  The prepared weights hold K
zero-padded to the kernels' `K_ALIGN` (and the split kernels' N to their
16-column alignment), so that no call copies a weight: the im2col patches
come out with the padded width, and the padded output columns fall away
with the inverse permutation.

`PlanSet` binds a bank of plans (precision variants of the same weights)
to a params dict by layer name (or in a model handle's plan order) and
serves the name-keyed matmul-backend protocol of
`repro_torch.models._backend` (``backend(name, p, x, conv=None)``), in
the variant `_backend.plan_variant` publishes; prepared
tensors of coinciding layers are shared across variants
(`prepared_nbytes` counts them once).  `PlannedBackend` is its one-variant
case.  Stacked ``base@r`` layers bind to a list of per-repeat prepared
layers, indexed by the repeat the model's layer loop publishes.

Every plan kernel executes: ``quant_matmul``, ``ternary_matmul`` and
``split_ternary`` (the DIANA plans), ``split_precision`` (int8 + identity
platforms such as ``gpu_tc_like``) and the ``fp`` identity.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.kernels import ops, ref
from repro_torch.kernels.quant_matmul import DECODE_M, K_ALIGN, _pad_to
from repro_torch.kernels.ternary_packed import n_align, pack_ternary
from repro_torch.models import _backend
from repro_torch.runtime.lower import _layer_weight, _walk_path
from repro_torch.runtime.plan import (KERNEL_FP, KERNEL_QUANT, KERNEL_SPLIT,
                                      KERNEL_SPLIT_TERNARY, KERNEL_TERNARY,
                                      ExecutionPlan, LayerPlan)

#: the N alignment the split kernels take at every M (their wgmma GEMM's;
#: the decode GEMM's 4 divides it)
SPLIT_N_ALIGN = n_align(DECODE_M + 1)


class ExecutionError(RuntimeError):
    """A planned layer cannot be executed as lowered."""


@dataclasses.dataclass
class PreparedLayer:
    """A `LayerPlan` bound to concrete tensors, ready to execute.  Every
    weight tensor holds ``k_pad`` rows (K zero-padded to `K_ALIGN`); the
    split kernels' also hold their N zero-padded to `SPLIT_N_ALIGN`."""
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
    conv_shape: Tuple[int, ...] | None = None  # HWIO shape of a conv weight
    k_in: int = 0                        # input features (kh*kw*C_in)
    k_pad: int = 0                       # k_in padded to K_ALIGN

    @property
    def kernel(self) -> str:
        return self.plan.kernel

    @property
    def conv_groups(self) -> int:
        return self.plan.groups


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


def _expand_grouped(w: torch.Tensor, groups: int) -> torch.Tensor:
    """Zero-embed a grouped conv weight ``(kh, kw, C_in/G, C_out)`` into the
    block-diagonal full matrix ``(kh, kw, C_in, C_out)``: input-channel
    block g only reaches output-channel block g (XLA's
    ``feature_group_count`` semantics), every other entry is exactly zero,
    which quantizes to code 0 in every domain."""
    kh, kw, cpg, c_out = (int(s) for s in w.shape)
    if c_out % groups:
        raise ExecutionError(f"{c_out} output channels do not divide into "
                             f"{groups} conv groups")
    opg = c_out // groups
    full = w.new_zeros((kh, kw, groups, cpg, groups, opg))
    g = torch.arange(groups, device=w.device)
    # (groups, kh, kw, cpg, opg) onto the diagonal blocks
    full[:, :, g, :, g, :] = w.reshape(kh, kw, cpg, groups, opg).permute(
        3, 0, 1, 2, 4)
    return full.reshape(kh, kw, groups * cpg, c_out)


def prepare_layer(lp: LayerPlan, w, b=None,
                  domain_bits: List[int] | None = None,
                  block_n: int = 128) -> PreparedLayer:
    """Bind ``lp`` to a 2-D ``(C_in, C_out)`` dense weight or a 4-D
    ``(kh, kw, C_in, C_out)`` HWIO conv weight (+ optional bias); a plan
    with ``groups > 1`` binds a grouped conv weight ``(kh, kw, C_in/G,
    C_out)``, zero-embedded block-diagonally (`_expand_grouped`).  Every
    plan kernel binds (`LayerPlan` admits no other)."""
    ndim = getattr(w, "ndim", 0)
    if ndim not in (2, 4):
        raise ExecutionError(f"{lp.name}: planned execution covers 2-D "
                             f"(dense) and 4-D (HWIO conv) weights, got "
                             f"shape {tuple(getattr(w, 'shape', ()))}")
    if int(w.shape[-1]) != lp.c_out:
        raise ExecutionError(f"{lp.name}: weight has {int(w.shape[-1])} "
                             f"output channels, plan expects {lp.c_out}")
    if lp.groups > 1:
        if ndim != 4:
            raise ExecutionError(f"{lp.name}: groups={lp.groups} needs a "
                                 f"4-D HWIO conv weight, got shape "
                                 f"{tuple(w.shape)}")
        w = _expand_grouped(w, lp.groups)
    conv_shape = tuple(int(s) for s in w.shape) if ndim == 4 else None
    w2 = w.reshape(-1, lp.c_out)
    k_in = int(w2.shape[0])
    if domain_bits is None:
        domain_bits = [8] * len(lp.counts)
    bn = int((lp.tuning or {}).get("bn", block_n))
    if bn < 1:
        raise ExecutionError(f"{lp.name}: invalid kernel tuning {lp.tuning}")
    dev = w.device
    # K zero-padded once here, so no kernel call pads (copies) a weight
    w_perm = _pad_to(torch.index_select(
        w2, 1, torch.from_numpy(lp.perm).to(dev)), K_ALIGN, 0)
    w_q = sw = w_t_packed = w_bf16 = act_scale = act_sx = None
    if lp.kernel != KERNEL_FP:
        w_q, sw = _per_column_quant(lp, w_perm.to(torch.float32),
                                    domain_bits)
        if lp.kernel in (KERNEL_SPLIT, KERNEL_SPLIT_TERNARY):
            # the split kernels take N in multiples of SPLIT_N_ALIGN: the
            # padded columns (code 0) fall away with the inverse
            # permutation
            w_q = _pad_to(w_q, SPLIT_N_ALIGN, 1)
            sw = _pad_to(sw, SPLIT_N_ALIGN, 0)
        if lp.kernel == KERNEL_SPLIT:
            w_bf16 = _pad_to(w_perm.to(torch.bfloat16), SPLIT_N_ALIGN, 1)
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
        bn=bn, conv_shape=conv_shape, k_in=k_in,
        k_pad=k_in + (-k_in) % K_ALIGN)


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
    ``x.dtype``.  ``x`` may carry the prepared K padding already (zeros:
    im2col patches do); otherwise it is padded here.  ``reference=True``
    runs the plain oracles instead."""
    lp = prep.plan
    if int(x.shape[-1]) not in (prep.k_in, prep.k_pad):
        raise ExecutionError(f"{lp.name}: input has {int(x.shape[-1])} "
                             f"features, weight expects {prep.k_in}")
    lead = x.shape[:-1]
    x2 = _pad_to(x.reshape(-1, x.shape[-1]), K_ALIGN, 1)
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


# --------------------------------------------------------------------------
# Conv execution: im2col onto the dense kernels
# --------------------------------------------------------------------------

def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int, int]:
    """(output size, pad before, pad after) of XLA's SAME padding: the odd
    pad goes after (bottom / right)."""
    out = -(-size // stride)
    pad = max((out - 1) * stride + k - size, 0)
    return out, pad // 2, pad - pad // 2


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
           padding: str = "SAME", width: int | None = None) -> torch.Tensor:
    """NHWC input -> ``(B, OH, OW, kh*kw*C)`` patches whose last axis
    matches a flattened HWIO conv weight ``w.reshape(kh*kw*C, C_out)``
    (row-major (kh, kw, C) order), with XLA's SAME / VALID padding
    semantics, so ``im2col(x) @ w_flat`` is the conv.  ``width`` (at least
    kh*kw*C) appends zero columns up to that many."""
    B, H, W, C = x.shape
    if padding == "SAME":
        oh, pt, pb = _same_pads(H, kh, stride)
        ow, pl, pr = _same_pads(W, kw, stride)
        if pt or pb or pl or pr:
            x = F.pad(x, (0, 0, pl, pr, pt, pb))
    elif padding == "VALID":
        oh = (H - kh) // stride + 1
        ow = (W - kw) // stride + 1
    else:
        raise ExecutionError(f"unsupported conv padding {padding!r}")
    if oh < 1 or ow < 1:
        raise ExecutionError(f"conv kernel ({kh}x{kw}) exceeds input "
                             f"({H}x{W}) under {padding} padding")
    cols = [x[:, i:i + (oh - 1) * stride + 1:stride,
              j:j + (ow - 1) * stride + 1:stride, :]
            for i in range(kh) for j in range(kw)]
    extra = (width or 0) - kh * kw * C
    if extra > 0:
        cols.append(x.new_zeros((B, oh, ow, extra)))
    return cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)


def execute_conv_layer(prep: PreparedLayer, x, stride: int = 1,
                       padding: str = "SAME", *,
                       reference: bool = False) -> torch.Tensor:
    """Run an NHWC input through a prepared conv layer: im2col the input to
    ``(B, OH, OW, kh*kw*C_in)`` patches (K-padded as the weights are) and
    execute them through the layer's planned dense kernel."""
    if prep.conv_shape is None:
        raise ExecutionError(f"{prep.plan.name}: not a conv layer (bound "
                             f"weight was 2-D)")
    kh, kw, ci, _ = prep.conv_shape
    if int(x.shape[-1]) != ci:
        raise ExecutionError(f"{prep.plan.name}: input has "
                             f"{int(x.shape[-1])} channels, conv weight "
                             f"expects {ci}")
    patches = im2col(x, kh, kw, stride=stride, padding=padding,
                     width=prep.k_pad)
    return execute_layer(prep, patches, reference=reference)


# --------------------------------------------------------------------------
# Prepared-buffer accounting
# --------------------------------------------------------------------------

#: PreparedLayer fields that hold tensors (the bind-time weight memory a
#: plan keeps alive)
_PREP_TENSOR_FIELDS = ("inv", "w_perm", "b", "w_q", "sw", "w_bf16",
                       "w_t_packed", "act_scale", "act_sx")


def _entry_tensors(entry):
    """Every tensor a bound entry (a prepared layer, or the per-repeat list
    of a stacked layer) keeps alive."""
    if isinstance(entry, list):
        for prep in entry:
            yield from _entry_tensors(prep)
        return
    for f in _PREP_TENSOR_FIELDS:
        t = getattr(entry, f)
        if t is not None:
            yield t


def prepared_nbytes(entries) -> int:
    """Total bytes of the UNIQUE storages held by ``entries``: a storage
    shared between entries (the `PlanSet` dedup) or between fields (the
    K-major ``w_q`` is a view of its own ``(N, K)`` copy) counts once."""
    seen, total = set(), 0
    for e in entries:
        for t in _entry_tensors(e):
            s = t.untyped_storage()
            key = (str(t.device), s.data_ptr())
            if s.nbytes() and key not in seen:
                seen.add(key)
                total += int(s.nbytes())
    return total


# --------------------------------------------------------------------------
# Name-keyed matmul backend over a bank of plans
# --------------------------------------------------------------------------

def _node_weight_ok(node) -> bool:
    w = _layer_weight(node)
    return isinstance(node, dict) and isinstance(w, torch.Tensor) \
        and w.dim() in (2, 4) and not w.is_meta


class _BoundPlan:
    """One `ExecutionPlan` variant bound to the owning `PlanSet`'s params:
    layers resolve in a handle's plan order, or by artifact layer name as
    params path, and every prepare goes through the owner's shared
    prepare cache, so identical (layer plan, weight, domain bits, block)
    tuples across variants bind to ONE set of prepared tensors."""

    def __init__(self, variant: str, plan: ExecutionPlan, params, handle,
                 owner: "PlanSet"):
        self.variant = variant
        self.plan = plan
        domain_bits = [int(d["weight_bits"]) for d in plan.domains]
        dsig = tuple(domain_bits)
        prep = lambda lp, node: prepare_layer(
            lp, _layer_weight(node), b=node.get("b"),
            domain_bits=domain_bits, block_n=plan.block_n)
        if handle is not None:
            dicts = handle.layers(params)
            if len(dicts) != len(plan.layers):
                raise ExecutionError(
                    f"handle resolves {len(dicts)} managed layers but the "
                    f"plan has {len(plan.layers)}")
            # node identity for the shared prepare cache: handle position
            resolved = [(lp, node, ("h", i))
                        for i, (lp, node) in enumerate(zip(plan.layers,
                                                           dicts))]
        else:
            resolved = [(lp, _walk_path(params, lp.name), ("p", lp.name))
                        for lp in plan.layers]
        self.by_name: Dict[str, Any] = {}
        self.bound: List[str] = []
        self.unbound: List[str] = []
        stacked: Dict[str, List[Tuple[int, LayerPlan, Any]]] = {}
        for lp, node, nkey in resolved:
            base, _, rep = lp.name.partition("@")
            if rep:
                stacked.setdefault(base, []).append((int(rep), lp, node))
                continue
            if not _node_weight_ok(node):
                self.unbound.append(lp.name)
                continue
            key = ("layer", nkey, owner._plan_sig(lp), dsig,
                   int(plan.block_n))
            self.by_name[lp.name] = owner._memo(
                key, variant, lp.name, lambda: prep(lp, node))
            self.bound.append(lp.name)
        for base, entries in sorted(stacked.items()):
            entries.sort(key=lambda e: e[0])
            reps = [r for r, _, _ in entries]
            if reps != list(range(len(reps))):
                raise ExecutionError(
                    f"{base}: stacked plan repeats {reps} are not the "
                    f"contiguous range 0..{len(reps) - 1}")
            stack_w = None if handle is not None else \
                _layer_weight(_walk_path(params, base))
            if getattr(stack_w, "ndim", 0) == 3 and \
                    int(stack_w.shape[0]) != len(reps):
                raise ExecutionError(
                    f"{base}: plan covers {len(reps)} repeats but the "
                    f"stacked weight carries {int(stack_w.shape[0])} -- the "
                    f"artifact does not match this model's layer stack")
            if not all(_node_weight_ok(node) for _, _, node in entries):
                self.unbound.extend(lp.name for _, lp, _ in entries)
                continue
            # stacks dedup at WHOLE-STACK granularity, as in the JAX
            # package (whose stacked containers hold fresh arrays): one
            # divergent repeat forks the whole stack for that base
            key = ("stack", "p", base,
                   tuple(owner._plan_sig(lp) for _, lp, _ in entries),
                   dsig, int(plan.block_n))
            self.by_name[base] = owner._memo(
                key, variant, base,
                lambda: [prep(lp, node) for _, lp, node in entries])
            self.bound.extend(lp.name for _, lp, _ in entries)


class PlanSet:
    """A precision bank: N `ExecutionPlan` variants of the SAME weights
    bound against one params dict, serving the name-keyed matmul-backend
    protocol (``backend(name, p, x, conv=None)``).

    The active variant is the key published by `_backend.plan_variant`
    (the transformer's ``variant=`` arguments publish it); calls outside
    any variant context execute ``default``.

    Prepared tensors DEDUPLICATE across variants: wherever a layer's
    (layer plan, resolved weight, domain bit-widths, block size) tuple
    coincides, the variants share one set of prepared tensors (per plain
    layer; per whole stack for stacked ``base@r`` entries, whose per-repeat
    lists are the eager counterpart of the JAX package's scan stacks).
    ``prepared_bytes()`` / ``memory_report()`` measure the dedup over
    unique storages: a two-variant bank stays strictly below two
    independent binds whenever any layer coincides.

    Layer resolution, coverage bookkeeping and the fail-loud
    `ExecutionError` semantics are those of the single-plan
    `PlannedBackend`, which is the one-variant case of this class.
    ``reference=True`` executes the plain oracles instead of the kernels
    (attribute; may be flipped between runs); it also selects the flash
    kernel's plain version in `attention.chunked_attention`.  Call sites
    declined at run time (a grouped conv whose plan was lowered without
    groups) are listed in ``runtime_declines`` with the reason, keyed
    ``variant:name`` in banks of more than one variant.
    """

    def __init__(self, variants: Dict[str, ExecutionPlan], params,
                 handle=None, *, default: str | None = None,
                 reference: bool = False):
        if not variants:
            raise ValueError("PlanSet needs at least one plan variant")
        for v in variants:
            if not isinstance(v, str) or not v:
                raise ValueError(f"variant names must be non-empty strings, "
                                 f"got {v!r}")
        self.reference = reference
        self.variant_names: Tuple[str, ...] = tuple(variants)
        self.default = self.variant_names[0] if default is None else default
        if self.default not in variants:
            raise ValueError(f"default variant {self.default!r} is not one "
                             f"of {list(self.variant_names)}")
        self.runtime_declines: Dict[str, str] = {}
        self._prep_cache: Dict[Any, Any] = {}
        self._share: Dict[Any, List[Tuple[str, str]]] = {}
        self._sig_cache: Dict[int, str] = {}
        self._variants: Dict[str, _BoundPlan] = {}
        for vname, plan in variants.items():
            self._variants[vname] = _BoundPlan(vname, plan, params, handle,
                                               self)

    # ---- shared prepare cache -------------------------------------------

    def _plan_sig(self, lp: LayerPlan) -> str:
        sig = self._sig_cache.get(id(lp))
        if sig is None:
            sig = json.dumps(lp.to_dict(), sort_keys=True)
            self._sig_cache[id(lp)] = sig
        return sig

    def _memo(self, key, variant: str, display_name: str, build):
        if key not in self._prep_cache:
            self._prep_cache[key] = build()
        self._share.setdefault(key, []).append((variant, display_name))
        return self._prep_cache[key]

    # ---- backend protocol -----------------------------------------------

    def _resolve_variant(self) -> _BoundPlan:
        v = _backend.current_plan_variant()
        if v is None:
            v = self.default
        bp = self._variants.get(v)
        if bp is None:
            raise ExecutionError(
                f"unknown plan variant {v!r}: this PlanSet binds "
                f"{list(self.variant_names)}")
        return bp

    def _decline_key(self, bp: _BoundPlan, name: str) -> str:
        # one-variant banks keep the bare-name key (the PlannedBackend
        # contract); multi-variant banks qualify it so variants don't alias
        return name if len(self._variants) == 1 else f"{bp.variant}:{name}"

    def __call__(self, name, p, x, *, conv=None):
        """Run the planned kernel of layer ``name`` in the ACTIVE variant
        (stacked layers: of the repeat published by `_backend.scan_slot`;
        conv call sites pass ``conv={"stride", "padding", "groups"}`` and
        run through `execute_conv_layer`), or return None for layers the
        variant does not cover."""
        if name is None:
            return None
        bp = self._resolve_variant()
        entry = bp.by_name.get(name)
        if entry is None:
            return None
        if isinstance(entry, list):
            r = _backend.current_scan_index()
            if r is None:
                raise ExecutionError(
                    f"{name}: stacked plan executed outside a scan_slot "
                    f"context (no repeat index to select the layer)")
            entry = entry[r]
        if conv is not None and entry.conv_shape is None:
            raise ExecutionError(
                f"{name}: conv call site but the plan bound a 2-D dense "
                f"weight -- the artifact does not match this model")
        if conv is None and entry.conv_shape is not None:
            raise ExecutionError(
                f"{name}: dense call site but the plan bound a conv weight "
                f"-- the artifact does not match this model")
        if conv is None:
            return execute_layer(entry, x, reference=self.reference)
        cg, pg = int(conv.get("groups", 1)), entry.conv_groups
        if cg != pg:
            if pg == 1:
                # a plan lowered without a groups record: declined, and
                # surfaced by serve's coverage check
                self.runtime_declines[self._decline_key(bp, name)] = (
                    f"grouped conv (groups={cg}) but the plan was lowered "
                    f"without groups; executed on the default path")
                return None
            raise ExecutionError(
                f"{name}: call site has groups={cg} but the plan was "
                f"lowered with groups={pg} -- the artifact does not match "
                f"this model")
        return execute_conv_layer(entry, x, conv["stride"], conv["padding"],
                                  reference=self.reference)

    # ---- coverage -------------------------------------------------------

    def variant(self, name: str) -> _BoundPlan:
        """The bound state of one variant (plan / bound / unbound)."""
        return self._variants[name]

    @property
    def fully_covered(self) -> bool:
        """True when EVERY variant bound every planned layer."""
        return all(not bp.unbound for bp in self._variants.values())

    def coverage(self) -> str:
        parts = []
        for v, bp in self._variants.items():
            s = (f"{len(bp.bound)}/{len(bp.plan.layers)} planned layers "
                 f"bound to weights, {len(bp.unbound)} unbound")
            parts.append(s if len(self._variants) == 1 else f"{v}: {s}")
        return "; ".join(parts)

    def coverage_diff(self) -> Dict[str, List[str]]:
        """Per-variant UNBOUND layer names (only variants with gaps)."""
        return {v: list(bp.unbound) for v, bp in self._variants.items()
                if bp.unbound}

    # ---- memory accounting ----------------------------------------------

    def prepared_bytes(self, variant: str | None = None) -> int:
        """Bytes of the unique prepared storages held by ``variant`` (or
        by the whole bank when None): storages shared across variants
        count once."""
        if variant is None:
            entries = [e for bp in self._variants.values()
                       for e in bp.by_name.values()]
        else:
            entries = list(self._variants[variant].by_name.values())
        return prepared_nbytes(entries)

    def shared_layers(self) -> Dict[str, Tuple[str, ...]]:
        """Display name -> variants whose prepared tensors coincide (>= 2
        variants sharing one prepare-cache entry)."""
        out: Dict[str, Tuple[str, ...]] = {}
        for users in self._share.values():
            vs = tuple(dict.fromkeys(v for v, _ in users))
            if len(vs) > 1:
                out[users[0][1]] = vs
        return out

    def memory_report(self) -> Dict[str, Any]:
        per_variant = {v: self.prepared_bytes(v) for v in self.variant_names}
        total = self.prepared_bytes()
        return {
            "variants": per_variant,
            "prepared_bytes": total,
            "sum_variant_bytes": sum(per_variant.values()),
            "dedup_saved_bytes": sum(per_variant.values()) - total,
            "shared_layers": self.shared_layers(),
        }


class PlannedBackend(PlanSet):
    """A one-plan `PlanSet` (variant ``"default"``): the single-mapping
    binding.  ``plan`` / ``bound`` / ``unbound`` / ``coverage()`` address
    the one variant, and ``runtime_declines`` keys stay bare layer
    names."""

    def __init__(self, plan: ExecutionPlan, params, handle=None, *,
                 reference: bool = False):
        super().__init__({"default": plan}, params, handle=handle,
                         reference=reference)

    @property
    def plan(self) -> ExecutionPlan:
        return self._variants["default"].plan

    @property
    def bound(self) -> List[str]:
        return self._variants["default"].bound

    @property
    def unbound(self) -> List[str]:
        return self._variants["default"].unbound

    @property
    def _by_name(self) -> Dict[str, Any]:
        return self._variants["default"].by_name
