"""The dry run's partitioned step on the production mesh
(`repro_torch.launch.mesh.fake_production_mesh`, `run_cell` on DTensors of
fake shards) against the JAX package's compiled production dry run, on
the CPU.

Every fake-group trace runs in a subprocess of its own
(``tests/dryrun_partitioned_worker.py``): a pytest worker may hold the
world-size-1 gloo group of `mesh.smoke_mesh` already.  For reduced cells
(yi decode, deepseek prefill kvwq8, zamba2 decode wq8, xlstm prefill, yi
train) on the (16, 16) and (2, 16, 16) meshes: ``status`` "ok", 256 / 512
devices, argument bytes equal to the specs-only record's and, bit for
bit, to JAX's record of the same cell (JAX on 512 host devices; its train
step fails in ``with_sharding_constraint`` under this JAX, so the train
cell is held to the specs only), per-device FLOPs below the (1, 1) mesh
record's and at least it times the devices, per-device FLOPs and temp
bytes within stated ratios of JAX's (`FLOPS_RATIO`, `TEMP_RATIO`),
collectives where JAX has them.  The traced argument shards take the
shape DTensor computes for the rank; the specs-only record counts them
with `sharding.local_shape`.  One sharded matmul counted at its local product, the propagator's
global-shape call left out.  A (2, 2) mesh of 4 gloo ranks runs reduced
yi-9b and zamba2 prefill and decode partitioned, and a (1, 4) mesh a
2560-token prefill through the chunked attention on blocks of query
heads, each within 1e-4 of the unpartitioned step (float32, caches
included).  `fake_production_mesh` refuses beside a gloo group, and
`analyze_cell` reads a production record, its collective term one
device's bytes over the link rate."""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.roofline import analysis as RA  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "dryrun_partitioned_worker.py"
CELLS = (("yi-9b", "tiny_decode", "base"),
         ("deepseek-v2-lite-16b", "tiny_prefill", "kvwq8"),
         ("zamba2-1.2b", "tiny_decode", "wq8"),
         ("xlstm-1.3b", "tiny_prefill", "base"),
         ("yi-9b", "tiny_train", "base"))
KEYS = [f"{a}:{s}:{v}:{m}" for m in ("sp", "mp") for a, s, v in CELLS]
SERVING = [k for k in KEYS if ":tiny_train:" not in k]
#: per-device FLOPs, the port's over JAX's compiled ``cost_analysis``:
#: XLA counts each ``lax.scan`` body once (the layer scan's 2 repeats
#: here) and the port every iteration, and the two partitions differ
#: (DTensor gathers heads that the 16 model ranks do not divide; JAX's
#: MoE dispatches by one-hot products).  Readings (CPU, torch 2.13, JAX
#: on 512 host devices), 16x16 / 2x16x16: yi decode 2.007 / 1.747,
#: deepseek prefill kvwq8 0.455 / 0.449, zamba2 decode wq8 0.694 / 0.560.
#: A factor 3 either way fails a 10x miscount in any of them (counting
#: the whole batch's attention on yi decode is ~30x).  xlstm's prefill
#: runs its sLSTM / mLSTM scans over time, which XLA also counts once:
#: 5.580 / 5.442, held to [1, 8] (the port counts every step)
FLOPS_RATIO = {"xlstm-1.3b": (1.0, 8.0)}
FLOPS_RATIO_DEFAULT = (1 / 3, 3.0)
#: temp bytes, the port's over JAX's: readings yi 3.849 / 2.536,
#: deepseek 0.413 / 0.412, xlstm 2.336 / 1.255; zamba2 wq8 decode 39.90 /
#: 44.52: its two remainder Mamba2 blocks hold unstacked (B, H, hd, N)
#: states, which the cache rule (JAX's) leaves unsharded on the batch and
#: shards over the model ranks on hd, and the port's scan on batch
#: shards gathers each over the 16 model ranks (a 1 MiB buffer per block
#: on one device; XLA's partition keeps it sharded)
TEMP_RATIO = {"zamba2-1.2b": (8.0, 64.0)}
TEMP_RATIO_DEFAULT = (1 / 4, 8.0)
TOL = 1e-4                  # the (2, 2) step, float32 (seen: ~6e-6)
TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, str(WORKER), *args], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(proc):
    out, err = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs():
    """The four workers, started together."""
    cells = ",".join(":".join(c) for c in CELLS)
    procs = {"port": _start("port", cells), "jax": _start("jax", cells),
             "matmul": _start("matmul"),
             "ranks": _start("ranks", str(_free_port()))}
    try:
        return {k: _result(p) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module")
def single():
    """The (1, 1) mesh's records of the cells (in this process)."""
    import dataclasses
    import tempfile
    cfgbase.load_all()
    saved = dict(SP.SHAPES)
    SP.SHAPES.update({"tiny_train": dict(kind="train", seq=64, batch=32),
                      "tiny_prefill": dict(kind="prefill", seq=64, batch=32),
                      "tiny_decode": dict(kind="decode", seq=256, batch=32)})
    added = []
    for arch, _, _ in CELLS:
        name = f"tiny-{arch}"
        if name not in cfgbase._REGISTRY:
            cfgbase._REGISTRY[name] = dataclasses.replace(
                cfgbase.reduce_for_smoke(cfgbase.get(arch)), name=name)
            added.append(name)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = tempfile.mkdtemp()
        return {f"{a}:{s}:{v}": D.run_cell(f"tiny-{a}", s, M.smoke_mesh(),
                                           out, variant=v)
                for a, s, v in CELLS}
    finally:
        torch.set_num_threads(threads)
        SP.SHAPES.clear()
        SP.SHAPES.update(saved)
        for name in added:
            del cfgbase._REGISTRY[name]
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("key", KEYS)
def test_traced_record_on_the_production_mesh(runs, single, key):
    got = runs["port"][key]
    rec, spec = got["traced"], got["specs_only"]
    mp = key.endswith(":mp")
    assert rec["status"] == "ok" and spec["status"] == "specs_only"
    assert rec["n_devices"] == (512 if mp else 256)
    assert rec["mesh"] == ([2, 16, 16] if mp else [16, 16])
    # one device's argument shards, as the specs give them
    assert rec["args"] == spec["args"] > 0
    for field in ("temp", "flops"):
        assert rec[field] is not None and rec[field] > 0
    one = single[key.rsplit(":", 1)[0]]
    assert one["status"] == "ok" and one["n_devices"] == 1
    whole = one["cost_analysis"]["flops"]
    assert rec["flops"] < whole <= rec["flops"] * rec["n_devices"]
    assert sum(rec["counts"].values()) > 0
    for op, n in rec["counts"].items():
        assert (n > 0) == (rec["bytes"][op] > 0)
    full = got["record"]
    assert full["device"] == "cpu"
    assert full["long_attention"] == "chunked plain"
    assert full["memory_analysis"]["peak_bytes"] >= rec["args"]
    assert set(full) >= {"arch", "shape", "multi_pod", "variant", "status",
                         "mesh", "n_devices", "memory_analysis",
                         "cost_analysis", "collectives", "scan_repeats",
                         "trace_s", "note"}


@pytest.mark.parametrize("key", KEYS)
def test_argument_bytes_equal_jax_compiled_record(runs, key):
    ours, theirs = runs["port"][key]["traced"], runs["jax"][key]
    if ":tiny_train:" in key:
        # JAX's train step does not compile under this JAX (its
        # with_sharding_constraint on the mesh's Explicit axes)
        assert "with_sharding_constraint" in theirs["error"]
        return
    assert ours["args"] == theirs["args"]
    assert ours["n_devices"] == theirs["n_devices"]
    # all-gathers and all-reduces where XLA's partition has them (DTensor
    # issues no collective-permute, and XLA's all-to-alls of MoE and
    # head resharding are gathers or all-to-alls here)
    for op in ("all-gather", "all-reduce"):
        if theirs["counts"][op]:
            assert ours["counts"][op] > 0, op


@pytest.mark.parametrize("key", SERVING)
def test_flops_and_temp_against_jax_compiled_record(runs, key):
    ours, theirs = runs["port"][key]["traced"], runs["jax"][key]
    arch = key.split(":")[0]
    for field, bands, default in (
            ("flops", FLOPS_RATIO, FLOPS_RATIO_DEFAULT),
            ("temp", TEMP_RATIO, TEMP_RATIO_DEFAULT)):
        lo, hi = bands.get(arch, default)
        ratio = ours[field] / theirs[field]
        assert lo <= ratio <= hi, (field, ours[field], theirs[field], ratio)


def test_sharded_matmul_counts_the_local_product(runs):
    got = runs["matmul"]
    counted, direct = got["counting"], got["direct"]
    # rows over 16 data ranks, w's 1024 columns over 16 model ranks
    assert counted["local"] == [2048 // 16, 64]
    assert counted["flops"] == 2 * (2048 // 16) * 4096 * 64
    assert counted["collectives"] == 0
    # the propagator did run the global mm, and only `counting` leaves it
    # out
    assert counted["propagated"] == ["aten.mm.default"]
    assert direct["propagated"] == ["aten.mm.default"]
    assert direct["flops"] == 2 * (4096 // 16) * 4096 * 64 + \
        2 * 4096 * 4096 * 1024


def test_real_ranks_partitioned_step_matches_unpartitioned(runs):
    for arch, got in runs["ranks"].items():
        assert got["sharded_leaves"] == got["n_cache_leaves"] > 0, arch
        for what in ("prefill", "decode", "caches"):
            assert got.get(what, 0.0) <= TOL, (arch, what, got[what])
    assert "yi-9b-long-1x4" in runs["ranks"]


def test_fake_production_mesh_refuses_beside_gloo():
    M.smoke_mesh()
    try:
        with pytest.raises(RuntimeError, match="process of its own"):
            M.fake_production_mesh(device_type="cpu")
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


def test_analyze_cell_reads_a_production_record(runs):
    cfgbase.load_all()
    # a reduced cell's record, read as the full cell's (whose config and
    # shape this process has registered)
    rec = dict(runs["port"]["yi-9b:tiny_decode:base:sp"]["record"],
               arch="yi-9b", shape="decode_32k")
    roof = RA.analyze_cell(rec)
    assert roof.chips == 256 and roof.collective_bytes > 0
    assert roof.t_compute > 0
    # one device's bytes over its link, not over 256 links
    assert roof.t_collective == roof.collective_bytes / RA.LINK_BW
    table = RA.markdown_table([roof])
    assert "| yi-9b | decode_32k |" in table
    rows = RA.records_table([rec]).splitlines()
    assert rows[2].startswith(
        "| yi-9b | decode_32k | 16x16 | ok | cpu, chunked plain |")
