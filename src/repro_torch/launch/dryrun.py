"""Dry run of an (architecture x input shape) cell (``repro.launch.dryrun``
counterpart): what one step of the cell needs, FLOPs, memory and
collectives, before anything is allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
        --shape decode_32k [--variant kvwq8] [--mapping m.json] \\
        [--mesh single|production] [--multi-pod] [--device cuda|cpu] \\
        [--out build/dryrun_torch/<mesh>]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

On a one-device mesh (`mesh.single_gpu_mesh`, or `mesh.smoke_mesh` on
the CPU) `run_cell` builds the cell's step as the JAX package does (the
variant, `quantize_for_serve` for ``wq8``, the train / prefill / decode
step, no planned backend), materialises the params, the optimiser state,
the inputs and the caches as fake tensors on the mesh's device
(``FakeTensorMode``: no storage, no launch) and runs the step once under
``FlopCounterMode``, a memory tracker of this module's own
(`PeakTracker`: the live bytes of every storage an op creates, at op
granularity, as the caching allocator's ``memory_allocated`` counts them)
and ``CommDebugMode``.  The JAX package parses collectives out of XLA's
HLO text; the port has none, and counts the collectives that run
(``CommDebugMode``'s counts, `PeakTracker`'s bytes of their outputs), all
at top level: the port runs each repeat eagerly, with no scan.  There is
no "bytes accessed" (the record's ``note`` says so); `repro_torch.
roofline.analysis.hlo_bytes` is the analytic count.  A decode step's
``index`` is the int ``seq - 1`` (the port's `decode_step` takes an int).
On the card a prefill or train step past 2048 tokens reaches the flash
kernel, which cannot run on fake tensors: there it runs a stand-in
(`_flash_op`) that writes the kernel's output in place, allocates nothing
else, and counts the full masked square of scores and PV products, as
the roofline enumerator does.

On a production mesh shape (`mesh.production_shape`, a
`sharding.MeshShape` with no devices) the record is ``status:
"specs_only"``: the per-device argument bytes from the sharding specs
(each leaf's local shard), FLOPs, temp and collectives null.
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
from torch.utils._python_dispatch import TorchDispatchMode

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
    "alltoall_base_": "all-to-all", "send": "collective-permute",
    "recv_": "collective-permute", "permute_tensor": "collective-permute",
}

NO_BYTES_ACCESSED = ("no 'bytes accessed': the port has no compiled program "
                     "to read it from; roofline.analysis.hlo_bytes is the "
                     "analytic count")
SPECS_ONLY_REASON = "needs a partitioned step over 256 / 512 devices"


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


def _storages(tree):
    """{id: storage} of the tensors of ``tree``, each storage once."""
    out = {}
    for leaf in _tree.leaves(tree):
        if isinstance(leaf, torch.Tensor):
            st = leaf.untyped_storage()
            out[id(st)] = st
    return out


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages of ``tree``'s tensors."""
    return sum(st.nbytes() for st in _storages(tree).values())


class PeakTracker(TorchDispatchMode):
    """The live bytes of storages at op granularity, and their peak: every
    storage an op creates counts from that op until it is freed.  `track`
    adds storages that exist already (the arguments).  The bytes of the
    collectives' outputs are summed per JAX op name in ``collective_bytes``
    (all top-level: no scan)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen = {}
        self.collective_bytes = {c: 0 for c in COLLECTIVES}

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

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in _tree.leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._add(t.untyped_storage())
        coll = _COLLECTIVE_OPS.get(func._overloadpacket.__name__)
        if coll is not None:
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
    that the causal mask or the window leave empty)."""
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


def _fake_like(m, device):
    return torch.empty(m.shape, dtype=m.dtype, device=device)


def trace_step(step, meta_args, device) -> dict:
    """Run ``step`` once on fake tensors of ``meta_args`` on ``device``
    (the flash kernel through `_flash_stand_in`); returns the FLOPs, the
    memory record, the collectives and the host time of the step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode
    with FakeTensorMode():
        args = tuple(_tree.tree_map(lambda m: _fake_like(m, device), a)
                     for a in meta_args)
        arg_bytes = tree_bytes(args)
        tracker = PeakTracker()
        tracker.track(args)
        counter = FlopCounterMode(display=False)
        t0 = time.perf_counter()
        with _flash_stand_in(), CommDebugMode() as comm, counter, tracker:
            out = step(*args)
        trace_s = time.perf_counter() - t0
        outs, ins = _storages(out), _storages(args)
        out_bytes = sum(st.nbytes() for st in outs.values())
        alias = sum(st.nbytes() for k, st in outs.items() if k in ins)
        del out, outs
    counts = {c: 0 for c in COLLECTIVES}
    for op, n in comm.get_comm_counts().items():
        coll = _COLLECTIVE_OPS.get(getattr(op, "__name__", str(op)))
        if coll is not None:
            counts[coll] += n
    return {
        "flops": float(counter.get_total_flops()),
        "memory_analysis": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": tracker.peak - arg_bytes,
            "alias_size_in_bytes": alias,
            "peak_bytes": tracker.peak},
        "collectives": {
            "bytes": {c: {"top": tracker.collective_bytes[c], "loop": 0}
                      for c in COLLECTIVES},
            "counts": {c: {"top": counts[c], "loop": 0}
                       for c in COLLECTIVES}},
        "trace_s": trace_s,
    }


def _specs_only_bytes(mesh, shape, meta_args, dp, tp) -> int:
    """Per-device argument bytes on a mesh shape with no devices: each
    leaf's local shard under the JAX package's specs."""
    kind = SP.SHAPES[shape]["kind"]

    def param_bytes(tree, skip=0):
        return sum(sh.local_bytes(mesh, leaf, sh.param_spec(
            mesh, sh._path_str(path[skip:]), tuple(leaf.shape), dp, tp)
            if leaf.dim() > 1 else sh.P())
            for path, leaf in _tree.leaves_with_paths(tree))

    def spec_bytes(tree, fn):
        return sum(sh.local_bytes(mesh, leaf, fn(tuple(leaf.shape)))
                   for leaf in _tree.leaves(tree))
    batch = lambda s: sh.batch_spec(mesh, s, dp)
    cache = lambda s: sh.cache_leaf_spec(mesh, s, dp, tp)
    total = param_bytes(meta_args[0])
    if kind == "train":
        # moments share the param specs; step counter replicated
        return total + param_bytes(meta_args[1], skip=1) + \
            spec_bytes(meta_args[2], batch)
    total += spec_bytes(meta_args[1], batch) + spec_bytes(meta_args[2], cache)
    if len(meta_args) > 3:
        total += spec_bytes(meta_args[3], batch)
    if kind == "decode":
        total += 4      # the int32 index, replicated
    return total


def run_cell(arch: str, shape: str, mesh, out_dir: Path,
             variant: str = "base", mapping: str | None = None) -> dict:
    """The cell's record, written to ``out_dir`` (`_write`).  ``mesh``: a
    one-device ``DeviceMesh`` (the step traced on fake tensors on its
    device) or a `sharding.MeshShape` of the production mesh (specs
    only)."""
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

    sh.set_mesh_axes(dp, tp, mesh)
    try:
        device = torch.device(mesh.device_type)
        traced = trace_step(step, meta_args, device)
    finally:
        sh.clear_mesh_axes()
    mem = traced["memory_analysis"]
    rec.update({
        "status": "ok",
        "mesh": list(tuple(mesh.shape)),
        "n_devices": mesh.size(),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
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
        return production_shape(multi_pod=multi_pod)
    if multi_pod:
        raise SystemExit("--multi-pod needs --mesh production")
    return M.single_gpu_mesh() if device == "cuda" else M.smoke_mesh()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="dry run of an (arch x shape) cell: FLOPs, memory and "
                    "collectives of one step, nothing allocated")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SP.SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="base", choices=list(VARIANTS))
    ap.add_argument("--mesh", default="single",
                    choices=("single", "production"),
                    help="single: the step traced on one device; "
                         "production: the (16, 16) / (2, 16, 16) mesh's "
                         "specs only")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the single mesh's device")
    ap.add_argument("--out", default=None,
                    help="record directory (build/dryrun_torch/<mesh>)")
    ap.add_argument("--mapping", default=None,
                    help="mapping artifact JSON: report the per-layer "
                         "kernel selection the runtime would execute")
    args = ap.parse_args(argv)
    if args.mesh == "single" and args.device == "cuda" and \
            not torch.cuda.is_available():
        print("[dryrun] ERROR: no CUDA device (pass --device cpu for the "
              "CPU's single mesh)", file=sys.stderr)
        sys.exit(2)
    out = Path(args.out or f"build/dryrun_torch/{args.mesh}")

    cfgbase.load_all()
    if args.all:
        for arch in cfgbase.names():
            for shape in SP.SHAPES:
                for mp in ((False, True) if args.mesh == "production"
                           else (False,)):
                    run_cell(arch, shape,
                             _mesh_for(args.mesh, mp, args.device), out)
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
