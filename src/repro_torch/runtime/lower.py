"""`lower()`: compile a `MappingArtifact` onto the port's kernels
(``repro.runtime.lower`` counterpart; both give the same plan JSON).

The compiler takes the artifact (object or plain dict — this module never
imports `repro_torch.api`) plus, optionally, the model's params (and a
model handle that locates its layers), and emits
an `ExecutionPlan`:

  * reorg: `core.discretize.stable_perm` groups each layer's output channels
    by domain; `split_points` gives the cumulative boundaries; the
    `kernels.ops.align_boundary` rule rounds them up to the kernels' N-block.
  * validation: artifact channel counts vs actual weight shapes, boundary
    monotonicity/alignment, domain->kernel capability checks.
  * kernel selection per layer (see `select_kernel`, driven by the
    capability-keyed registry in `repro_torch.runtime.registry`):
      - one active >=16-bit domain            -> "fp"
      - one active <=8-bit domain             -> "quant_matmul" (2-bit:
                                                 "ternary_matmul")
      - int8-ish + identity domains, quant
        domain ordered first                  -> "split_precision"
      - int8-ish + ternary domains, int8
        domain ordered first                  -> "split_ternary" (DIANA)
      - anything else                         -> "fp" fallback, reason
                                                 (with layer name + bits
                                                 pair) in ``note``
                                                 (LoweringError if
                                                 ``strict=True``)
  * scales: artifact v2 per-layer scales win; otherwise the ODiMO state of
    the resolved layer dict; otherwise max-abs statistics of the concrete
    weight; otherwise None (v1 artifacts "lower without scales" — executors
    then derive scales from the weights they bind to).

Params are the port's nested dict of tensors; tensors on the ``meta``
device count as shapes only (no scale statistics are taken from them).
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np

import torch

from repro_torch.core import quant
from repro_torch.core.discretize import split_points, stable_perm
from repro_torch.kernels.ops import align_boundary
from repro_torch.runtime import registry
from repro_torch.runtime.plan import (ExecutionPlan, LayerPlan, LoweringError,
                                PLAN_SCHEMA_VERSION)


def _artifact_dict(artifact) -> dict:
    if hasattr(artifact, "to_dict"):
        artifact = artifact.to_dict()
    version = artifact.get("schema_version", 1)
    if version > PLAN_SCHEMA_VERSION:
        raise LoweringError(f"mapping artifact schema v{version} is newer "
                            f"than supported v{PLAN_SCHEMA_VERSION}")
    return artifact


def _index_stacked(node, r: int):
    """Repeat ``r`` of a scan-stacked param node: every tensor leaf loses
    its leading R axis (a view, no copy).  Returns None when the repeat is
    out of range."""
    def one(leaf):
        if getattr(leaf, "ndim", 0) >= 1:
            if r >= leaf.shape[0]:
                raise IndexError(r)
            return leaf[r]
        return leaf
    try:
        if isinstance(node, dict):
            return {k: one(v) for k, v in node.items()}
        return one(node)
    except (IndexError, TypeError):
        return None


def _walk_path(params, name: str):
    """Resolve a slash-separated layer name into the params pytree; returns
    None when any segment is missing.  A ``base@r`` name addresses repeat
    ``r`` of the scan-stacked node at ``base`` (leaves carry a leading R
    axis — the layer-stacking convention of `repro_torch.models.
    transformer`, shared with the JAX package's scan stacks)."""
    base, _, rep = name.partition("@")
    node = params
    for part in base.split("/"):
        try:
            if isinstance(node, (list, tuple)):
                node = node[int(part)]
            elif isinstance(node, dict):
                node = node[part]
            else:
                return None
        except (KeyError, IndexError, ValueError, TypeError):
            return None
    if rep:
        try:
            node = _index_stacked(node, int(rep))
        except ValueError:
            return None
    return node


def resolve_layer_params(artifact, params=None, handle=None):
    """Per artifact layer, the param node it names: a managed-layer dict
    (``{"w": ..., "b"?, "odimo"?, "act_log_scale"?}``), a bare weight leaf,
    or None when unresolvable / no params were given.

    With a ``handle`` (any object with ``layers(params)``, e.g. a
    `repro_torch.api.ModelHandle`), layers come back in plan order, which
    is artifact order by construction.  Otherwise artifact layer names are
    resolved as slash-separated paths into ``params`` (the
    `launch/train.emit_static_mapping` convention); ``base@r`` names
    address repeat ``r`` of a scan-stacked node (leaves with a leading R
    axis).
    """
    art = _artifact_dict(artifact)
    names = [l["name"] for l in art["layers"]]
    if handle is not None and params is not None:
        dicts = handle.layers(params)
        if len(dicts) != len(names):
            raise LoweringError(
                f"handle resolves {len(dicts)} managed layers but the "
                f"artifact has {len(names)}")
        return list(zip(names, dicts))
    if params is None:
        return [(n, None) for n in names]
    return [(n, _walk_path(params, n)) for n in names]


def _layer_weight(node) -> Any | None:
    """The weight tensor of a resolved param node."""
    if node is None:
        return None
    if isinstance(node, dict):
        w = node.get("w")
        return w if getattr(w, "ndim", 0) >= 2 else None
    return node if getattr(node, "ndim", 0) >= 2 else None


def _is_concrete(w) -> bool:
    return isinstance(w, torch.Tensor) and not w.is_meta


def select_kernel(counts: Sequence[int],
                  domain_bits: Sequence[int]) -> Tuple[str, str]:
    """(kernel, note) for a layer from its per-domain channel counts and the
    domains' weight bit-widths.  ``note`` is non-empty iff the layer fell
    back to fp for a capability reason.

    Delegates to the capability-keyed registry (`repro.runtime.registry`):
    the active domains' bit-widths, in plan order, look up the kernel — a
    new (bits, bits) pairing is one ``register_kernel`` call."""
    active = [i for i, c in enumerate(counts) if c > 0]
    return registry.kernel_for([domain_bits[i] for i in active])


def _layer_scales(art_layer: dict, node) -> Tuple[List[float] | None,
                                                  float | None]:
    """(w_log_scales, act_log_scale) by priority: artifact v2 scales ->
    ODiMO state of the resolved layer dict -> None (lower() then falls back
    to max-abs statistics of the concrete weight, when one is bound)."""
    sc = art_layer.get("scales")
    if sc:
        wls = sc.get("w_log_scales")
        als = sc.get("act_log_scale")
        return ([float(v) for v in wls] if wls is not None else None,
                float(als) if als is not None else None)
    if isinstance(node, dict) and "odimo" in node:
        wls = [float(v) for v in node["odimo"]["log_scales"]]
        als = node.get("act_log_scale")
        return wls, (float(als) if als is not None else None)
    return None, None


def lower(artifact, params=None, handle=None, *, block_n: int = 128,
          strict: bool = False, tuning=None) -> ExecutionPlan:
    """Compile ``artifact`` into an `ExecutionPlan`.

    ``params`` / ``handle`` enable shape validation and scale recovery
    (see `resolve_layer_params`); without them the plan is lowered from the
    artifact alone.  ``strict=True`` turns capability fallbacks (layers that
    would silently run fp) into `LoweringError`s; shape mismatches always
    raise.  ``tuning`` optionally maps a layer name (or ``"*"`` for every
    layer) to kernel block sizes ``{"bm", "bn", "bk"}``, recorded on each
    `LayerPlan`; a tuned ``bn`` becomes the layer's boundary-alignment
    block (the CUDA kernels fix their own tiles and read no other entry).
    """
    art = _artifact_dict(artifact)
    domains = [dict(d) for d in art["domains"]]
    domain_bits = [int(d["weight_bits"]) for d in domains]
    n_domains = len(domains)
    tuning = tuning or {}
    resolved = resolve_layer_params(art, params=params, handle=handle)

    layers: List[LayerPlan] = []
    for art_layer, (name, node) in zip(art["layers"], resolved):
        assign = np.asarray(art_layer["assignment"], dtype=np.int64)
        if assign.size and (assign.min() < 0 or assign.max() >= n_domains):
            raise LoweringError(
                f"layer {name!r}: assignment references domain "
                f"{int(assign.max())} but the artifact declares only "
                f"{n_domains} domains")
        counts = [int((assign == i).sum()) for i in range(n_domains)]
        art_counts = [int(c) for c in art_layer.get("counts", counts)]
        if art_counts != counts:
            raise LoweringError(
                f"layer {name!r}: stored counts {art_counts} disagree with "
                f"the assignment's {counts}")

        if params is not None and node is None:
            raise LoweringError(
                f"layer {name!r}: no param node at this path — the artifact "
                f"was produced for a different model/config")
        w = _layer_weight(node)
        c_out = int(assign.size)
        c_in = int(art_layer.get("c_in", 0))
        groups = int(art_layer.get("groups", 1))
        if groups > 1 and c_out % groups:
            raise LoweringError(
                f"layer {name!r}: {c_out} output channels do not divide "
                f"into {groups} conv groups")
        if w is not None:
            if int(w.shape[-1]) != c_out:
                raise LoweringError(
                    f"layer {name!r}: artifact assigns {c_out} output "
                    f"channels but the bound weight has shape "
                    f"{tuple(w.shape)} ({int(w.shape[-1])} channels) — "
                    f"the artifact does not match this model")
            if groups > 1 and getattr(w, "ndim", 0) != 4:
                raise LoweringError(
                    f"layer {name!r}: groups={groups} needs a 4-D HWIO conv "
                    f"weight, got shape {tuple(w.shape)}")
            # grouped convs execute zero-embedded over the FULL input
            # channels (kh*kw*c_in_per_group*groups) — record that K
            c_in = int(np.prod(w.shape[:-1])) * groups

        perm = stable_perm(assign)
        bounds = split_points(assign[perm], n_domains)
        layer_tuning = tuning.get(name, tuning.get("*"))
        # the ops clamp the N-block to min(bn, max(128, n)); align with the
        # SAME effective block so the plan records what actually executes
        bn = int((layer_tuning or {}).get("bn", block_n))
        bn_eff = min(bn, max(128, c_out)) if c_out else bn
        aligned = [min(align_boundary(b, bn_eff),
                       align_boundary(c_out, bn_eff)) for b in bounds]
        if any(b2 < b1 for b1, b2 in zip(aligned, aligned[1:])):
            raise LoweringError(f"layer {name!r}: aligned boundaries "
                                f"{aligned} are not monotone")

        kernel, note = select_kernel(counts, domain_bits)
        if note:
            # fallback reasons reach users via plan JSON / coverage reports
            # far from the artifact: carry the layer context in the string
            note = f"{name}: {note}"
        if strict and note:
            raise LoweringError(f"layer {note}")

        w_ls, act_ls = _layer_scales(art_layer, node)
        if w_ls is None and _is_concrete(w):
            ls = float(quant.init_log_scale(w))
            w_ls = [ls] * n_domains

        layers.append(LayerPlan(
            name=name, kernel=kernel, c_in=c_in, c_out=c_out, perm=perm,
            counts=counts, boundaries=[int(b) for b in bounds],
            aligned_boundaries=[int(b) for b in aligned],
            w_log_scales=w_ls, act_log_scale=act_ls,
            searchable=bool(art_layer.get("searchable", True)), note=note,
            tuning=(dict(layer_tuning) if layer_tuning else None),
            groups=groups))

    return ExecutionPlan(model=art.get("model", "unknown"), domains=domains,
                         layers=layers, platform=art.get("platform"),
                         block_n=block_n)


# --------------------------------------------------------------------------
# CLI: mapping.json -> plan.json
# --------------------------------------------------------------------------

def _lm_param_shapes(arch: str, reduce: bool):
    """An LM's params as ``meta`` tensors: shapes and dtypes only."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import transformer as T
    cfg = cfgbase.get(arch)
    if reduce:
        cfg = cfgbase.reduce_for_smoke(cfg)
    return T.param_shapes(cfg)


def main(argv=None):
    """``python -m repro_torch.runtime ARTIFACT [--out PLAN] [--arch A
    [--reduce]] [--block-n N] [--strict]``: print the plan's summary and
    one line per layer; exit 2 on a `LoweringError`.  Needs no device."""
    import argparse
    import json
    import sys
    from pathlib import Path

    ap = argparse.ArgumentParser(
        description="lower a mapping artifact to an execution plan")
    ap.add_argument("artifact", help="mapping artifact JSON")
    ap.add_argument("--out", default=None, help="plan JSON output path")
    ap.add_argument("--arch", default=None,
                    help="validate against this LM arch's weight shapes")
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--block-n", type=int, default=128)
    ap.add_argument("--strict", action="store_true",
                    help="fail on fp capability fallbacks")
    args = ap.parse_args(argv)

    artifact = json.loads(Path(args.artifact).read_text())
    params = (_lm_param_shapes(args.arch, args.reduce)
              if args.arch else None)
    try:
        plan = lower(artifact, params=params, block_n=args.block_n,
                     strict=args.strict)
    except LoweringError as e:
        print(f"[lower] ERROR: {e}", file=sys.stderr)
        sys.exit(2)
    print(f"[lower] {plan.summary()}")
    for lp in plan.layers:
        extra = f"  ({lp.note})" if lp.note else ""
        print(f"[lower]   {lp.name}: {lp.kernel} counts={lp.counts} "
              f"aligned={lp.aligned_boundaries}{extra}")
    if args.out:
        plan.save(args.out)
        print(f"[lower] wrote {args.out}")
    return plan
