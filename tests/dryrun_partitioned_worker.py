"""Subprocess side of ``tests/test_torch_dryrun_partitioned.py``: each mode
prints one JSON object on its last line.

    python tests/dryrun_partitioned_worker.py port CELLS   (fake group)
    python tests/dryrun_partitioned_worker.py jax CELLS    (512 host devices)
    python tests/dryrun_partitioned_worker.py matmul       (fake group)
    python tests/dryrun_partitioned_worker.py ranks PORT   (4 gloo ranks)

``CELLS`` is ``arch:shape:variant,...``; the reduced configs are
registered as ``tiny-<arch>`` and the tiny shapes put into ``SHAPES``, as
in the test's parent process.
"""
import dataclasses
import json
import os
import sys
import tempfile

TINY = {"tiny_train": dict(kind="train", seq=64, batch=32),
        "tiny_prefill": dict(kind="prefill", seq=64, batch=32),
        "tiny_decode": dict(kind="decode", seq=256, batch=32)}


def _register(cfgbase, specs, archs):
    cfgbase.load_all()
    specs.SHAPES.update(TINY)
    for arch in archs:
        red = cfgbase.reduce_for_smoke(cfgbase.get(arch))
        cfgbase._REGISTRY[f"tiny-{arch}"] = dataclasses.replace(
            red, name=f"tiny-{arch}")


def _cells(arg):
    return [tuple(c.split(":")) for c in arg.split(",")]


def _summary(rec):
    return {"status": rec["status"], "n_devices": rec["n_devices"],
            "mesh": rec["mesh"],
            "args": rec["memory_analysis"]["argument_size_in_bytes"],
            "temp": rec["memory_analysis"].get("temp_size_in_bytes"),
            "flops": rec["cost_analysis"].get("flops"),
            "counts": {op: s["top"] + s["loop"] for op, s in
                       (rec["collectives"] or {}).get("counts", {}).items()},
            "bytes": {op: s["top"] + s["loop"] for op, s in
                      (rec["collectives"] or {}).get("bytes", {}).items()}}


def port(cells):
    import torch
    torch.set_num_threads(2)
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as M
    from repro_torch.launch import specs as SP
    _register(cfgbase, SP, {a for a, _, _ in cells})
    out, tmp = {}, tempfile.mkdtemp()
    for mp in (False, True):
        mesh = M.fake_production_mesh(multi_pod=mp, device_type="cpu")
        for arch, shape, variant in cells:
            key = f"{arch}:{shape}:{variant}:{'mp' if mp else 'sp'}"
            rec = D.run_cell(f"tiny-{arch}", shape, mesh, tmp,
                             variant=variant)
            spec = D.run_cell(f"tiny-{arch}", shape,
                              M.production_shape(multi_pod=mp), tmp,
                              variant=variant)
            out[key] = {"traced": _summary(rec), "specs_only": _summary(spec),
                        "record": rec}
    return out


def jax_(cells):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    os.environ["JAX_PLATFORMS"] = "cpu"
    from pathlib import Path

    from repro.configs import base as jbase
    from repro.launch import dryrun as jd
    from repro.launch import specs as JSP
    _register(jbase, JSP, {a for a, _, _ in cells})
    out, tmp = {}, Path(tempfile.mkdtemp())
    for mp in (False, True):
        for arch, shape, variant in cells:
            key = f"{arch}:{shape}:{variant}:{'mp' if mp else 'sp'}"
            try:
                out[key] = _summary(jd.run_cell(f"tiny-{arch}", shape, mp,
                                                tmp, variant=variant))
            except Exception as e:      # noqa: BLE001 (reported to the test)
                out[key] = {"error": f"{type(e).__name__}: {e}"[:300]}
    return out


def matmul():
    """One sharded matmul on the 16 x 16 fake mesh: rows of x over data,
    columns of w over model, so each device runs one local mm and no
    collective.  Counted with the propagator's global-shape call left out
    (`counting`) and, on fresh shapes, with it in (the tracker entered
    directly), beside the propagator's calls seen."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as M
    mesh = M.fake_production_mesh(device_type="cpu")
    seen = []
    infer = ShardingPropagator._propagate_tensor_meta_non_cached

    def spy(prop, op_schema):
        seen.append(str(op_schema.op))
        return infer(prop, op_schema)
    ShardingPropagator._propagate_tensor_meta_non_cached = spy
    out = {}
    with FakeTensorMode():
        for how, rows in (("counting", 2048), ("direct", 4096)):
            x = DTensor.from_local(torch.empty(rows // 16, 4096), mesh,
                                   (Shard(0), Replicate()), run_check=False,
                                   shape=(rows, 4096), stride=(4096, 1))
            w = DTensor.from_local(torch.empty(4096, 64), mesh,
                                   (Replicate(), Shard(1)), run_check=False,
                                   shape=(4096, 1024), stride=(1024, 1))
            tracker = D.PeakTracker()
            before = len(seen)
            with (tracker.counting() if how == "counting" else tracker):
                y = x @ w
            out[how] = {"flops": tracker.flops, "rows": rows,
                        "propagated": seen[before:],
                        "local": list(y.to_local().shape),
                        "collectives": sum(tracker.collective_counts
                                           .values())}
    return out


def _rank(rank, port_, result_dir):
    """One of 4 gloo ranks: a (2, 2) mesh; reduced float32 yi-9b and
    zamba2 prefill then decode, partitioned (DTensor params and caches
    under the dry run's specs, `constrain` on) and unpartitioned (plain
    tensors, the same params), from one seed; rank 0 writes the largest
    differences of logits and written caches."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import base as cfgbase
    from repro_torch.core import tree as _tree
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import specs as SP
    from repro_torch.models import transformer as T
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port_}",
                            rank=rank, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    dp, tp = ("data",), "model"
    cfgbase.load_all()
    # float32 caches: a bfloat16 KV cache would round a sum that the
    # partition reorders to the other side of a bfloat16 step
    spec = T._block_cache_spec
    T._block_cache_spec = lambda *a: {
        key: (shape, torch.float32 if dt == torch.bfloat16 else dt)
        for key, (shape, dt) in spec(*a).items()}
    B, S, S_max = 4, 16, 32
    SP.SHAPES["ranks_prefill"] = dict(kind="prefill", seq=S_max, batch=B)
    res = {}
    for arch in ("yi-9b", "zamba2-1.2b"):
        cfg = dataclasses.replace(cfgbase.reduce_for_smoke(cfgbase.get(arch)),
                                  param_dtype="float32")
        params = T.init_lm(torch.Generator().manual_seed(0), cfg)
        caches = T.init_cache(cfg, B, S_max, "cpu")
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, (B, S)).astype(np.int32))
        with torch.no_grad():
            lg, want = T.prefill(params, cfg, tokens, _tree.tree_map(
                torch.clone, caches))
            tok = torch.argmax(lg, -1).to(torch.int32)
            lg2, want = T.decode_step(params, cfg, tok, want, S)
        specs = D.arg_specs(mesh, "ranks_prefill", (params, tokens, caches),
                            dp, tp)
        leaves = _tree.leaves((params, tokens, caches))
        dargs = _tree.unflatten((params, tokens, caches), [
            distribute_tensor(t, mesh, sh.placements(mesh, spec))
            for t, spec in zip(leaves, specs)])
        dparams, dtokens, dcaches = dargs
        sh.set_mesh_axes(dp, tp, mesh)
        try:
            with torch.no_grad(), implicit_replication():
                dlg, dcaches = T.prefill(dparams, cfg, dtokens, dcaches)
                dtok = distribute_tensor(tok, mesh, sh.placements(
                    mesh, sh.batch_spec(mesh, (B,), dp)))
                dlg2, dcaches = T.decode_step(dparams, cfg, dtok, dcaches, S)
        finally:
            sh.clear_mesh_axes()
        full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
        got = _tree.leaves(dcaches)
        res[arch] = {
            "prefill": float((full(dlg) - lg).abs().max()),
            "decode": float((full(dlg2) - lg2).abs().max()),
            "caches": max(float((full(a).float() - b.float()).abs().max())
                          for a, b in zip(got, _tree.leaves(want))),
            "n_cache_leaves": len(got),
            "sharded_leaves": sum(
                any(p.is_shard() for p in a.placements) for a in got),
            "scale": float(lg2.abs().max())}
    # a long prefill through the chunked attention on a (1, 4) mesh whose
    # model axis divides neither the 2 KV heads nor their 2 groups: each
    # rank attends with its block of 1 query head (`attention_shards`),
    # into a cache sharded on its sequence
    mesh14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(cfgbase.reduce_for_smoke(cfgbase.get("yi-9b")),
                              param_dtype="float32", n_kv_heads=2)
    B, S, S_max = 2, 2560, 3072
    SP.SHAPES["ranks_long"] = dict(kind="prefill", seq=S_max, batch=B)
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    caches = T.init_cache(cfg, B, S_max, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, S)).astype(np.int32))
    with torch.no_grad():
        lg, want = T.prefill(params, cfg, tokens, _tree.tree_map(
            torch.clone, caches))
    specs = D.arg_specs(mesh14, "ranks_long", (params, tokens, caches), dp,
                        tp)
    dparams, dtokens, dcaches = _tree.unflatten(
        (params, tokens, caches), [
            distribute_tensor(t, mesh14, sh.placements(mesh14, spec))
            for t, spec in zip(_tree.leaves((params, tokens, caches)),
                               specs)])
    sh.set_mesh_axes(dp, tp, mesh14)
    try:
        with torch.no_grad(), implicit_replication():
            dlg, dcaches = T.prefill(dparams, cfg, dtokens, dcaches)
    finally:
        sh.clear_mesh_axes()
    got = _tree.leaves(dcaches)
    res["yi-9b-long-1x4"] = {
        "prefill": float((dlg.full_tensor() - lg).abs().max()),
        "caches": max(float((a.full_tensor() - b).abs().max())
                      for a, b in zip(got, _tree.leaves(want))),
        "n_cache_leaves": len(got),
        "sharded_leaves": sum(
            any(p.is_shard() for p in a.placements) for a in got),
        "scale": float(lg.abs().max())}
    if rank == 0:
        with open(os.path.join(result_dir, "ranks.json"), "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def ranks(port_):
    import torch.multiprocessing as mp
    result_dir = tempfile.mkdtemp()
    mp.spawn(_rank, args=(port_, result_dir), nprocs=4, join=True)
    with open(os.path.join(result_dir, "ranks.json")) as f:
        return json.load(f)


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "port":
        result = port(_cells(sys.argv[2]))
    elif mode == "jax":
        result = jax_(_cells(sys.argv[2]))
    elif mode == "matmul":
        result = matmul()
    else:
        result = ranks(int(sys.argv[2]))
    print(json.dumps(result))
