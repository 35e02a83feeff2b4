"""Dry run of an (architecture x input shape) cell (``repro.launch.dryrun``
counterpart): what one step of the cell needs, FLOPs, memory and
collectives, before anything is allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
        --shape decode_32k [--variant kvwq8] [--mapping m.json] \\
        [--mesh single|production] [--multi-pod] [--device cuda|cpu] \\
        [--out build/dryrun_torch/<mesh>]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        [--mesh production] [--arch yi-9b]

On a one-device mesh (`mesh.single_gpu_mesh`, or `mesh.smoke_mesh` on
the CPU) `run_cell` builds the cell's step as the JAX package does (the
variant, `quantize_for_serve` for ``wq8``, the train / prefill / decode
step, no planned backend), materialises the params, the optimiser state,
the inputs and the caches as fake tensors on the mesh's device
(``FakeTensorMode``: no storage, no launch) and runs the step once under
`PeakTracker`: FLOPs by ``torch.utils.flop_counter``'s formulas, the live
bytes of every storage an op creates, at op granularity, as the caching
allocator's ``memory_allocated`` counts them, and the collectives.

On the production mesh (`mesh.fake_production_mesh`: (16, 16) or (2, 16,
16) over a ``"fake"`` process group of 256 / 512 ranks) the step is
partitioned as the JAX package's ``jit`` with ``in_shardings``
partitions it: every argument is a DTensor of fake local shards under
the JAX package's specs (`arg_specs`), `sharding.constrain` lays out the
activations as ``with_sharding_constraint`` does, and `PeakTracker`
counts one device's program (rank 0's): the local ops DTensor runs, at
local shapes, and the collectives of its redistributions.  The JAX
package parses collectives out of XLA's HLO text; the port has none, and
counts the collectives that run (count and output bytes per JAX op name),
all at top level: the port runs each repeat eagerly, with no scan.
There is no "bytes accessed" (the record's ``note`` says so); `repro_torch.
roofline.analysis.hlo_bytes` is the analytic count.  A decode step's
``index`` is the int ``seq - 1`` (the port's `decode_step` takes an int;
the production record counts JAX's int32 argument, `INDEX_BYTES`).  On
the card a prefill or train step past 2048 tokens reaches the flash
kernel, which cannot run on fake tensors: there it runs a stand-in
(`_flash_op`) that writes the kernel's output in place, allocates nothing
else, and counts the full masked square of scores and PV products, as
the roofline enumerator does; on the CPU it runs the chunked plain
attention.

On a production mesh shape (`mesh.production_shape`, a
`sharding.MeshShape` with no devices) the record is ``status:
"specs_only"``: the per-device argument bytes from the sharding specs
(each leaf's local shard), FLOPs, temp and collectives null: the
traced record's cross-check.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import weakref
from pathlib import Path

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import base as cfgbase
from repro_torch.core import tree as _tree
from repro_torch.distributed import sharding as sh
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import mesh_axes, production_shape
from repro_torch.models import transformer as T

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: the JAX name of a torch collective op (by its name without overload)
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather", "all_gather": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "alltoall_base_": "all-to-all", "send": "collective-permute",
    "recv_": "collective-permute", "permute_tensor": "collective-permute",
}

NO_BYTES_ACCESSED = ("no 'bytes accessed': the port has no compiled program "
                     "to read it from; roofline.analysis.hlo_bytes is the "
                     "analytic count")
SPECS_ONLY_REASON = ("specs only: the partitioned step over 256 / 512 "
                     "devices is traced on mesh.fake_production_mesh")


def scanned_repeats(cfg) -> int:
    """Trip count of the layer scan (collectives inside count this many x)."""
    period = len(cfg.pattern)
    r = cfg.n_layers // period
    if cfg.moe_first_dense and period == 1:
        r -= 1
    return r


VARIANTS = {
    "base": {},
    "kvq8": {"kv_cache_dtype": "int8"},
    "wq8": {"serve_weight_dtype": "int8"},
    "kvwq8": {"kv_cache_dtype": "int8", "serve_weight_dtype": "int8"},
}


def mapping_plan_report(cfg, mapping_path: str) -> dict:
    """Lower a mapping artifact against the arch's weight SHAPES (``meta``
    params, no concrete ones needed) and report the per-layer kernel
    selection the runtime would execute: the compile-time view of
    ``serve --mapping``.  A `LoweringError` gives ``{"error": ...}``
    (`main` exits 2 on it)."""
    from repro_torch.runtime import LoweringError, lower

    artifact = json.loads(Path(mapping_path).read_text())
    try:
        plan = lower(artifact, params=T.param_shapes(cfg))
    except LoweringError as e:
        # no traceback: the message IS the diagnostic (main exits 2 on it)
        print(f"[dryrun] mapping {mapping_path} does not lower onto "
              f"{cfg.name}: {e}")
        return {"error": str(e)}
    rec = {"kernels": plan.kernel_histogram(),
           "fallbacks": plan.fallback_reasons(),
           "layers": [{"name": lp.name, "kernel": lp.kernel,
                       "counts": lp.counts,
                       "aligned_boundaries": lp.aligned_boundaries,
                       **({"note": lp.note} if lp.note else {})}
                      for lp in plan.layers]}
    print(f"[dryrun] mapping {mapping_path}: {plan.summary()}")
    for line in plan.histogram_lines():
        print(f"[dryrun] {line}")
    try:  # registry introspection: what CAN this platform's domains fuse?
        from repro_torch.api import Platform
        caps = Platform.get(plan.platform).kernel_capabilities()
        for names, (kernel, note) in caps.items():
            extra = f"  ({note})" if note else ""
            print(f"[dryrun]   capability {'+'.join(names)}: "
                  f"{kernel}{extra}")
    except KeyError:
        pass  # unregistered platform name in the artifact
    for l in rec["layers"]:
        note = f"  ({l['note']})" if "note" in l else ""
        print(f"[dryrun]   {l['name']}: {l['kernel']} "
              f"counts={l['counts']}{note}")
    return rec


# ---------------------------------------------------------------- the cell

def cell_config(arch: str, variant: str = "base"):
    cfg = cfgbase.get(arch)
    if VARIANTS[variant]:
        cfg = dataclasses.replace(cfg, **VARIANTS[variant])
    return cfg


def cell_step(cfg, shape: str):
    """(step, argument tree of ``meta`` tensors) of the cell: train
    ``(params, opt_state, batch)``, prefill ``(params, tokens, caches[,
    frontend])``, decode ``(params, token, caches)`` (the step's
    ``index``, the int ``seq - 1``, is bound in ``step``).  Serving cells
    of ``serve_weight_dtype == "int8"`` get `quantize_for_serve`'s
    params."""
    meta = SP.SHAPES[shape]
    params = SP.param_specs(cfg)
    inputs = SP.input_specs(cfg, shape)
    if meta["kind"] == "train":
        return (SP.make_train_step(cfg),
                (params, SP.opt_specs(cfg), inputs["batch"]))
    params = T.quantize_for_serve(params, cfg)
    if meta["kind"] == "prefill":
        args = (params, inputs["tokens"], inputs["caches"])
        if cfg.frontend:
            args += (inputs["frontend"],)
        return SP.make_prefill_step(cfg), args
    serve, index = SP.make_serve_step(cfg), meta["seq"] - 1
    return ((lambda p, tok, c: serve(p, tok, c, index)),
            (params, inputs["token"], inputs["caches"]))


def concrete_args(cfg, shape: str, gen: torch.Generator):
    """`cell_step`'s arguments for a real run on ``gen.device``: params
    drawn from ``gen`` (`init_lm`; `quantize_for_serve` for a serving
    cell), the optimiser state of `adamw.init`, caches zeroed, tokens
    drawn from ``gen`` and a frontend of N(0, 1) rows in bfloat16."""
    from repro_torch.optim import adamw
    _, meta_args = cell_step(cfg, shape)
    kind = SP.SHAPES[shape]["kind"]
    dev = gen.device
    params = T.init_lm(gen, cfg)

    def draw(m):
        if m.dtype == torch.int32:
            return torch.randint(0, cfg.vocab, m.shape, generator=gen,
                                 device=dev, dtype=torch.int32)
        return torch.randn(m.shape, generator=gen, device=dev).to(m.dtype)
    if kind == "train":
        batch = {k: draw(m) for k, m in meta_args[2].items()}
        return (params, adamw.init(params, SP.opt_config(cfg)), batch)
    params = T.quantize_for_serve(params, cfg)
    meta = SP.SHAPES[shape]
    caches = T.init_cache(cfg, meta["batch"], meta["seq"], device=dev)
    return ((params, draw(meta_args[1]), caches) +
            tuple(draw(m) for m in meta_args[3:]))


def _local(t):
    """The local shard of a DTensor (one device's storage), else ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def _storages(tree):
    """{id: storage} of the (local) tensors of ``tree``, each storage
    once."""
    out = {}
    for leaf in _tree.leaves(tree):
        if isinstance(leaf, torch.Tensor):
            st = _local(leaf).untyped_storage()
            out[id(st)] = st
    return out


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages of ``tree``'s tensors (of each
    DTensor, its local shard)."""
    return sum(st.nbytes() for st in _storages(tree).values())


class PeakTracker(TorchDispatchMode):
    """One device's program, op by op: its FLOPs (``torch.utils.
    flop_counter``'s formulas, with ``FlopCounterMode``'s decompositions),
    the live bytes of storages and their peak (every storage an op creates
    counts from that op until it is freed; `track` adds storages that
    exist already, the arguments) and the collectives by JAX op name
    (count and output bytes; all top level: no scan).

    An op on DTensors is deferred (``NotImplemented``): DTensor then runs
    the op's local version on each shard, and a redistribution's
    ``_c10d_functional`` collectives, which come back here at local
    shapes.  The ops that DTensor's sharding propagator runs at global
    shapes to infer an output's metadata are not counted (`counting`
    marks them)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.flops = 0
        self._seen = {}
        self._paused = 0
        self.collective_bytes = {c: 0 for c in COLLECTIVES}
        self.collective_counts = {c: 0 for c in COLLECTIVES}

    def _add(self, st):
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.live -= self._seen.pop(key, 0)

    def track(self, tree):
        for st in _storages(tree).values():
            self._add(st)

    def _uncounted(self, fn, real=False):
        """``fn`` with counting paused (and, ``real``, fake tensors off)."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        def run(*args, **kwargs):
            self._paused += 1
            try:
                with (unset_fake_temporarily() if real
                      else contextlib.nullcontext()):
                    return fn(*args, **kwargs)
            finally:
                self._paused -= 1
        return run

    @contextlib.contextmanager
    def counting(self):
        """This mode on, with DTensor's own bookkeeping left out of every
        count: the sharding propagator's shape inference (each op run once
        at global shapes) and a strided shard's offsets (index tensors,
        computed on real ones: fake tensors cannot be read back).  A
        shard-to-shard redistribution on a CPU mesh runs the all-to-all
        that NCCL runs, not gloo's all-gather and chunk (which would count
        the whole gathered tensor)."""
        from torch.distributed import _functional_collectives as funcol
        from torch.distributed.tensor import placement_types
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP_

        def all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
            return torch.ops._dtensor.shard_dim_alltoall(
                input, gather_dim, shard_dim,
                funcol._resolve_group_name((mesh, mesh_dim)))
        strided = placement_types._StridedShard
        patched = [
            (SP_, "_propagate_tensor_meta_non_cached",
             lambda fn: self._uncounted(fn)),
            (strided, "local_shard_size_and_offset",
             lambda fn: self._uncounted(fn, real=True)),
            (placement_types, "shard_dim_alltoall", lambda fn: all_to_all)]
        saved = [getattr(owner, name) for owner, name, _ in patched]
        for (owner, name, wrap), fn in zip(patched, saved):
            setattr(owner, name, wrap(fn))
        try:
            with self:
                yield self
        finally:
            for (owner, name, _), fn in zip(patched, saved):
                setattr(owner, name, fn)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if self._paused:
            return func(*args, **kwargs)
        if func is not torch.ops.prim.device.default:
            # FlopCounterMode's rule: count an op's decomposition if it
            # has one
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        outs = [t for t in _tree.leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._add(t.untyped_storage())
        coll = _COLLECTIVE_OPS.get(packet.__name__)
        if coll is not None:
            self.collective_counts[coll] += 1
            self.collective_bytes[coll] += sum(
                t.untyped_storage().nbytes() for t in outs)
        return out


_FLASH_OP = []


def _flash_op():
    """The flash kernel's stand-in on fake tensors: a custom op that
    writes ``out`` in place (its fake version allocates nothing, as the
    kernel does not) and counts the full masked square of scores and PV
    products, ``2 B H Sq Sk (D + Dv)``: what the roofline enumerator and
    the kernel's plain version count (the kernel itself skips the tiles
    that the causal mask or the window leave empty).  On DTensors,
    `chunked_attention` calls it on each device's shards
    (`sharding.attention_shards`): it counts the local B and H."""
    if not _FLASH_OP:
        from torch.utils.flop_counter import register_flop_formula

        @torch.library.custom_op("repro_torch_dryrun::flash_attention",
                                 mutates_args=("out",))
        def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor) -> None:
            raise RuntimeError("the dry run's flash stand-in runs on fake "
                               "tensors only")

        @flash.register_fake
        def _(q, k, v, out):
            return None

        @register_flop_formula(torch.ops.repro_torch_dryrun.flash_attention)
        def _(q_shape, k_shape, v_shape, out_shape_arg, **kwargs):
            B, H, Sq, D = q_shape
            return 2 * B * H * Sq * k_shape[2] * (D + v_shape[-1])

        _FLASH_OP.append(flash)
    return _FLASH_OP[0]


@contextlib.contextmanager
def _flash_stand_in():
    """`attention.chunked_attention` calls the flash stand-in
    (`_flash_op`) in place of the kernel for the duration."""
    from repro_torch.models import attention as A
    op, kernel = _flash_op(), A.flash_attention

    def stand_in(q, k, v, *, causal=True, kv_len=None, window=None,
                 out=None):
        if out is None:
            out = q.new_empty(q.shape[:3] + (v.shape[-1],))
        op(q, k, v, out)
        return out
    A.flash_attention = stand_in
    try:
        yield
    finally:
        A.flash_attention = kernel


def long_attention(device_type: str) -> str:
    """The path of an attention past 2048 tokens on ``device_type``: the
    flash kernel (in a trace, `_flash_stand_in`) on the card, the chunked
    plain attention on the CPU."""
    return "flash" if device_type == "cuda" else "chunked plain"


def trace_step(step, make_args) -> dict:
    """Run ``step`` once on the fake tensors that ``make_args()`` builds
    (plain ones on one device, or DTensors of one shard each), the flash
    kernel through `_flash_stand_in` and plain tensors that meet DTensors
    taken as replicated; returns one device's FLOPs, memory record and
    collectives (`PeakTracker`) and the host time of the step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    with FakeTensorMode():
        args = make_args()
        arg_bytes = tree_bytes(args)
        tracker = PeakTracker()
        tracker.track(args)
        t0 = time.perf_counter()
        with _flash_stand_in(), implicit_replication(), tracker.counting():
            out = step(*args)
        trace_s = time.perf_counter() - t0
        outs, ins = _storages(out), _storages(args)
        out_bytes = sum(st.nbytes() for st in outs.values())
        alias = sum(st.nbytes() for k, st in outs.items() if k in ins)
        del out, outs
    return {
        "flops": float(tracker.flops),
        "memory_analysis": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": tracker.peak - arg_bytes,
            "alias_size_in_bytes": alias,
            "peak_bytes": tracker.peak},
        "collectives": {
            "bytes": {c: {"top": tracker.collective_bytes[c], "loop": 0}
                      for c in COLLECTIVES},
            "counts": {c: {"top": tracker.collective_counts[c], "loop": 0}
                       for c in COLLECTIVES}},
        "trace_s": trace_s,
    }


def arg_specs(mesh, shape, meta_args, dp, tp) -> list:
    """The spec of each leaf of ``meta_args`` (in `_tree.leaves` order)
    on ``mesh``, the JAX package's ``in_shardings``: params
    `sharding.param_spec`; the AdamW moments the param specs (the path's
    first key skipped), the step counter replicated; batch, tokens and
    frontend rows `sharding.batch_spec`; caches `sharding.cache_leaf_spec`."""
    kind = SP.SHAPES[shape]["kind"]

    def params(tree, skip=0):
        return [sh.param_spec(mesh, sh._path_str(path[skip:]),
                              tuple(leaf.shape), dp, tp)
                for path, leaf in _tree.leaves_with_paths(tree)]

    def each(tree, fn):
        return [fn(tuple(leaf.shape)) for leaf in _tree.leaves(tree)]
    batch = lambda s: sh.batch_spec(mesh, s, dp)
    cache = lambda s: sh.cache_leaf_spec(mesh, s, dp, tp)
    specs = params(meta_args[0])
    if kind == "train":
        return specs + params(meta_args[1], skip=1) + each(meta_args[2],
                                                           batch)
    specs += each(meta_args[1], batch) + each(meta_args[2], cache)
    for extra in meta_args[3:]:
        specs += each(extra, batch)
    return specs


#: the decode step's int32 ``index``, replicated: an argument of the JAX
#: package's step (the port's `decode_step` takes an int)
INDEX_BYTES = 4


def _specs_only_bytes(mesh, shape, meta_args, dp, tp) -> int:
    """Per-device argument bytes on a mesh shape with no devices: each
    leaf's local shard under `arg_specs`."""
    specs = arg_specs(mesh, shape, meta_args, dp, tp)
    total = sum(sh.local_bytes(mesh, leaf, spec)
                for leaf, spec in zip(_tree.leaves(meta_args), specs))
    return total + (INDEX_BYTES if SP.SHAPES[shape]["kind"] == "decode"
                    else 0)


def _traced_mesh(mesh, device_type: str):
    """The mesh the step is traced on, of ``device_type``: the multi-pod
    mesh (pod, data, model) with its pod and data axes flattened into one
    data axis of pod x data ranks, in the same rank order, so that each
    argument's local shard is the same.  XLA runs a collective over
    ("pod", "data") as one collective of that group; DTensor would run it
    as one per mesh axis, and plans each redistribution on a 3-D mesh by
    a search that costs seconds per op.  Any other mesh: itself, on
    ``device_type``."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = tuple(mesh.shape), tuple(mesh.mesh_dim_names)
    if mesh.ndim == 3:
        shape, names = (shape[0] * shape[1], shape[2]), ("data", "model")
    if shape == tuple(mesh.shape) and device_type == mesh.device_type:
        return mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def partitioned_args(mesh, shape, meta_args, dp, tp):
    """``meta_args`` as DTensors on ``mesh`` under `arg_specs`, each an
    uninitialised local shard on the mesh's device (called under
    ``FakeTensorMode``: fake shards) of the shape DTensor itself gives
    this rank: the specs-only record's `sharding.local_shape` is the
    independent count that the traced argument bytes are held to."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    dev = torch.device(mesh.device_type)

    def shard(m, spec):
        pl = sh.placements(mesh, spec)
        with unset_fake_temporarily():      # it computes offsets on tensors
            shape = compute_local_shape_and_global_offset(m.shape, mesh,
                                                          pl)[0]
        local = torch.empty(shape, dtype=m.dtype, device=dev)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=m.shape, stride=m.stride())
    return _tree.unflatten(meta_args, [
        shard(m, spec) for m, spec in zip(
            _tree.leaves(meta_args), arg_specs(mesh, shape, meta_args, dp,
                                               tp))])


def run_cell(arch: str, shape: str, mesh, out_dir: Path,
             variant: str = "base", mapping: str | None = None) -> dict:
    """The cell's record, written to ``out_dir`` (`_write`).  ``mesh``: a
    ``DeviceMesh``, of one device (the step traced on fake tensors on its
    device) or the production mesh of `mesh.fake_production_mesh` (the
    partitioned step traced on DTensors of fake shards, one device's
    program counted), or a `sharding.MeshShape` of the production mesh
    (specs only)."""
    cfg = cell_config(arch, variant)
    names = getattr(mesh, "mesh_dim_names", None) or mesh.names
    multi_pod = "pod" in names
    if not SP.cell_is_runnable(cfg, shape):
        rec = {"arch": arch, "shape": shape, "variant": variant,
               "multi_pod": multi_pod, "status": "skipped",
               "reason": "full-attention arch: long_500k requires "
                         "sub-quadratic sequence mixing"}
        _write(out_dir, rec)
        return rec
    dp, tp = mesh_axes(mesh)
    step, meta_args = cell_step(cfg, shape)
    rec = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
           "variant": variant}
    if isinstance(mesh, sh.MeshShape):
        sizes = list(mesh.sizes)
        rec.update({
            "status": "specs_only", "reason": SPECS_ONLY_REASON,
            "mesh": sizes, "n_devices": math.prod(sizes),
            "memory_analysis": {
                "argument_size_in_bytes": _specs_only_bytes(
                    mesh, shape, meta_args, dp, tp),
                "output_size_in_bytes": None, "temp_size_in_bytes": None,
                "alias_size_in_bytes": None, "peak_bytes": None},
            "cost_analysis": {"flops": None}, "collectives": None,
            "scan_repeats": scanned_repeats(cfg)})
        if mapping:
            rec["mapping_plan"] = mapping_plan_report(cfg, mapping)
        print(f"[dryrun] {arch} x {shape} ({'x'.join(map(str, sizes))}) "
              f"specs only: args="
              f"{rec['memory_analysis']['argument_size_in_bytes'] / 2**30:.2f}"
              f"GiB/dev; {SPECS_ONLY_REASON}")
        _write(out_dir, rec)
        return rec

    # a train step past 2048 tokens reaches the flash kernel on the card,
    # which has no backward: train cells trace on CPU fake tensors, whose
    # chunked plain attention autograd differentiates (as the JAX package
    # differentiates its jnp chunked attention).  Their temp and peak
    # bytes are that path's (its scores kept for the backward), which the
    # card never runs; the record names the device and the path
    kind = SP.SHAPES[shape]["kind"]
    device = torch.device("cpu" if kind == "train" else mesh.device_type)
    if kind == "train" and mesh.device_type == "cuda":
        print(f"[dryrun] {arch} x {shape}: a train cell, traced on CPU fake "
              f"tensors through the chunked plain attention (the flash "
              f"kernel has no backward)")
    traced_mesh = _traced_mesh(mesh, device.type)
    dp = mesh_axes(traced_mesh)[0]
    if mesh.size() > 1:
        make_args = lambda: partitioned_args(traced_mesh, shape, meta_args,
                                             dp, tp)
    else:
        make_args = lambda: tuple(_tree.tree_map(
            lambda m: torch.empty(m.shape, dtype=m.dtype, device=device), a)
            for a in meta_args)
    sh.set_mesh_axes(dp, tp, traced_mesh)
    try:
        traced = trace_step(step, make_args)
    finally:
        sh.clear_mesh_axes()
    mem = traced["memory_analysis"]
    if mesh.size() > 1 and kind == "decode":
        mem["argument_size_in_bytes"] += INDEX_BYTES
        mem["peak_bytes"] += INDEX_BYTES
    rec.update({
        "status": "ok",
        "mesh": list(tuple(mesh.shape)),
        "n_devices": mesh.size(),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "long_attention": long_attention(device.type),
        "memory_analysis": mem,
        "cost_analysis": {"flops": traced["flops"]},
        "collectives": traced["collectives"],
        "scan_repeats": scanned_repeats(cfg),
        "trace_s": traced["trace_s"],
        "note": NO_BYTES_ACCESSED})
    if mapping:
        rec["mapping_plan"] = mapping_plan_report(cfg, mapping)
    print(f"[dryrun] {arch} x {shape} ({variant}, "
          f"{'x'.join(map(str, rec['mesh']))} on {rec['device']}) OK  "
          f"trace={traced['trace_s']:.1f}s  "
          f"temp={mem['temp_size_in_bytes'] / 2**30:.2f}GiB/dev "
          f"args={mem['argument_size_in_bytes'] / 2**30:.2f}GiB/dev "
          f"peak={mem['peak_bytes'] / 2**30:.2f}GiB/dev "
          f"flops={traced['flops']:.4e}")
    print("  memory_analysis:", mem)
    _write(out_dir, rec)
    return rec


def _write(out_dir: Path, rec: dict):
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = "mp" if rec["multi_pod"] else "sp"
    if rec.get("variant", "base") != "base":
        tag = f"{tag}-{rec['variant']}"
    path = out_dir / f"{rec['arch']}__{rec['shape']}__{tag}.json"
    path.write_text(json.dumps(rec, indent=1))


def _mesh_for(kind: str, multi_pod: bool, device: str):
    from repro_torch.launch import mesh as M
    if kind == "production":
        return M.fake_production_mesh(multi_pod=multi_pod, device_type=device)
    if multi_pod:
        raise SystemExit("--multi-pod needs --mesh production")
    return M.single_gpu_mesh() if device == "cuda" else M.smoke_mesh()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="dry run of an (arch x shape) cell: FLOPs, memory and "
                    "collectives of one device's step, nothing allocated")
    ap.add_argument("--arch", default=None,
                    help="the arch (with --all: only this arch's cells)")
    ap.add_argument("--shape", default=None, choices=list(SP.SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell; on the production "
                         "mesh both the single- and the multi-pod one")
    ap.add_argument("--variant", default="base", choices=list(VARIANTS))
    ap.add_argument("--mesh", default="single",
                    choices=("single", "production"),
                    help="single: the step traced on one device; "
                         "production: the partitioned step on the (16, 16) "
                         "/ (2, 16, 16) mesh of a fake process group")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the mesh's device (fake tensors on it)")
    ap.add_argument("--out", default=None,
                    help="record directory (build/dryrun_torch/<mesh>)")
    ap.add_argument("--mapping", default=None,
                    help="mapping artifact JSON: report the per-layer "
                         "kernel selection the runtime would execute")
    ap.add_argument("--list-archs", action="store_true",
                    help="print the archs of --all, one per line, and exit")
    args = ap.parse_args(argv)
    if args.list_archs:
        cfgbase.load_all()
        print("\n".join(cfgbase.names()))
        return
    if args.device == "cuda" and not torch.cuda.is_available():
        print("[dryrun] ERROR: no CUDA device (pass --device cpu for the "
              "CPU's mesh)", file=sys.stderr)
        sys.exit(2)
    out = Path(args.out or f"build/dryrun_torch/{args.mesh}")

    cfgbase.load_all()
    if args.all:
        archs = [args.arch] if args.arch else cfgbase.names()
        for mp in ((False, True) if args.mesh == "production"
                   else (False,)):
            mesh = _mesh_for(args.mesh, mp, args.device)
            for arch in archs:
                for shape in SP.SHAPES:
                    run_cell(arch, shape, mesh, out)
        return
    if not args.arch or not args.shape:
        ap.error("--arch and --shape (or --all) are needed")
    rec = run_cell(args.arch, args.shape,
                   _mesh_for(args.mesh, args.multi_pod, args.device), out,
                   variant=args.variant, mapping=args.mapping)
    err = (rec or {}).get("mapping_plan", {}).get("error")
    if err:
        print(f"[dryrun] ERROR: {err}", file=sys.stderr)
        sys.exit(2)


if __name__ == "__main__":
    main()
