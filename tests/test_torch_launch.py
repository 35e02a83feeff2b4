"""The port's dry-run tools (`repro_torch.launch.specs`, `.mesh`,
`.dryrun`) against the JAX package's on the CPU: ``SHAPES`` and
`cell_is_runnable`; `input_specs` / `param_specs` / `opt_specs` with the
shapes and dtypes of JAX's ``eval_shape`` on every cell; the prefill and
serve steps' logits within 1e-4 and the train step's loss within 1e-5 and
params after one step within 1e-4, float32 reduced yi-9b and zamba2 on
JAX's params; `run_cell` on small cells put into ``SHAPES`` on the CPU's
(1, 1) mesh (argument bytes exact, FLOPs equal to a real CPU run's
counter, the record's keys) and its ``specs_only`` record on the
production mesh shape; the production mesh's refusal with one rank;
`mapping_plan_report` equal to JAX's on one artifact, and the CLI's exit 2
on one that does not lower."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.launch import dryrun as jdry  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.launch.train import emit_static_mapping as j_emit  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.core import tree as _tree  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

ARCHS = ("arctic-480b", "command-r-35b", "deepseek-v2-lite-16b",
         "h2o-danube-3-4b", "llama-3.2-vision-11b", "nemotron-4-15b",
         "seamless-m4t-large-v2", "xlstm-1.3b", "yi-9b", "zamba2-1.2b")
TINY = {"tiny_train": dict(kind="train", seq=32, batch=2),
        "tiny_prefill": dict(kind="prefill", seq=32, batch=2),
        "tiny_decode": dict(kind="decode", seq=64, batch=2)}


@pytest.fixture(scope="module", autouse=True)
def _load():
    jbase.load_all()
    cfgbase.load_all()
    yield
    # the (1, 1) meshes start a world-size-1 process group: end it with
    # the module
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dt(a):
    return str(a.dtype).split(".")[-1]


def _jleaves(tree):
    return [leaf for _, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _same_specs(ours, theirs):
    a, b = _tree.leaves(ours), _jleaves(theirs)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.is_meta
        assert tuple(x.shape) == tuple(y.shape) and _dt(x) == _dt(y)


def test_shapes_and_runnable_equal_jax():
    assert SP.SHAPES == JSP.SHAPES
    for arch in ARCHS:
        for shape in SP.SHAPES:
            assert SP.cell_is_runnable(cfgbase.get(arch), shape) == \
                JSP.cell_is_runnable(jbase.get(arch), shape)
    assert D.VARIANTS == jdry.VARIANTS
    assert D.COLLECTIVES == jdry.COLLECTIVES
    for arch in ARCHS:
        assert D.scanned_repeats(cfgbase.get(arch)) == \
            jdry.scanned_repeats(jbase.get(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jax_eval_shape(arch):
    cfg, jcfg = cfgbase.get(arch), jbase.get(arch)
    _same_specs(SP.param_specs(cfg), JSP.param_specs(jcfg))
    _same_specs(SP.opt_specs(cfg), JSP.opt_specs(jcfg))
    assert SP.opt_config(cfg).moment_dtype == (
        torch.bfloat16 if arch == "arctic-480b" else torch.float32)
    for shape in SP.SHAPES:
        if SP.cell_is_runnable(cfg, shape):
            _same_specs(SP.input_specs(cfg, shape),
                        JSP.input_specs(jcfg, shape))


# ------------------------------------------------------------------ steps

def _reduced(arch):
    over = dict(param_dtype="float32")
    jcfg = dataclasses.replace(jbase.reduce_for_smoke(jbase.get(arch)),
                               **over)
    cfg = dataclasses.replace(cfgbase.reduce_for_smoke(cfgbase.get(arch)),
                              **over)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float32),
                               np.asarray(b, dtype=np.float32), atol=tol,
                               rtol=0)


@pytest.mark.parametrize("arch", ("yi-9b", "zamba2-1.2b"))
def test_prefill_and_serve_steps_equal_jax(arch):
    jcfg, cfg, jparams, params = _reduced(arch)
    B, S, S_max = 2, 8, 16
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    lg, caches = SP.make_prefill_step(cfg)(
        params, torch.from_numpy(tokens), T.init_cache(cfg, B, S_max, "cpu"))
    jlg, jcaches = JSP.make_prefill_step(jcfg)(
        jparams, jnp.asarray(tokens), JT.init_cache(jcfg, B, S_max))
    _close(lg.numpy(), jlg, 1e-4)
    tok = np.argmax(np.asarray(jlg), -1)
    serve, jserve = SP.make_serve_step(cfg), JSP.make_serve_step(jcfg)
    for i in range(2):
        lg, caches = serve(params, torch.from_numpy(tok), caches, S + i)
        jlg, jcaches = jserve(jparams, jnp.asarray(tok), jcaches,
                              jnp.int32(S + i))
        _close(lg.numpy(), jlg, 1e-4)
        tok = np.argmax(np.asarray(jlg), -1)


@pytest.mark.parametrize("arch", ("yi-9b", "zamba2-1.2b"))
def test_train_step_equals_jax(arch):
    jcfg, cfg, jparams, params = _reduced(arch)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    from repro.optim import adamw as jadamw
    jopt = jadamw.init(jparams, JSP.opt_config(jcfg))
    from repro_torch.optim import adamw
    opt = adamw.init(params, SP.opt_config(cfg))
    jp, _, jm = JSP.make_train_step(jcfg)(
        jparams, jopt, {"tokens": jnp.asarray(tokens),
                        "targets": jnp.asarray(targets)})
    p, _, m = SP.make_train_step(cfg)(
        params, opt, {"tokens": torch.from_numpy(tokens),
                      "targets": torch.from_numpy(targets)})
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
    got = _tree.leaves(p)
    want = _jleaves(jp)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a.detach().numpy(), b, 1e-4)


# ---------------------------------------------------------------- run_cell

@pytest.fixture()
def tiny(monkeypatch):
    """The tiny shapes in ``SHAPES`` and reduced configs registered as
    ``tiny-<arch>``."""
    for k, v in TINY.items():
        monkeypatch.setitem(SP.SHAPES, k, v)
    for arch in ("yi-9b", "zamba2-1.2b", "deepseek-v2-lite-16b",
                 "xlstm-1.3b"):
        red = cfgbase.reduce_for_smoke(cfgbase.get(arch))
        monkeypatch.setitem(cfgbase._REGISTRY, f"tiny-{arch}",
                            dataclasses.replace(red, name=f"tiny-{arch}"))


@pytest.mark.parametrize("arch,shape,variant", [
    ("yi-9b", "tiny_decode", "base"), ("yi-9b", "tiny_prefill", "kvwq8"),
    ("yi-9b", "tiny_train", "base"), ("zamba2-1.2b", "tiny_decode", "wq8"),
    ("deepseek-v2-lite-16b", "tiny_decode", "kvwq8"),
    ("xlstm-1.3b", "tiny_prefill", "base")])
def test_run_cell_equals_a_real_cpu_run(tiny, tmp_path, arch, shape,
                                        variant):
    arch = f"tiny-{arch}"
    rec = D.run_cell(arch, shape, M.smoke_mesh(), tmp_path, variant=variant)
    assert rec["status"] == "ok" and rec["mesh"] == [1, 1]
    assert rec["n_devices"] == 1 and rec["multi_pod"] is False
    cfg = D.cell_config(arch, variant)
    step, _ = D.cell_step(cfg, shape)
    args = D.concrete_args(cfg, shape, torch.Generator().manual_seed(0))
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == D.tree_bytes(args)
    assert mem["peak_bytes"] == mem["argument_size_in_bytes"] + \
        mem["temp_size_in_bytes"]
    with FlopCounterMode(display=False) as fc:
        out = step(*args)
    assert rec["cost_analysis"]["flops"] == fc.get_total_flops() > 0
    if SP.SHAPES[shape]["kind"] != "train":
        # the caches come back written in place
        assert mem["alias_size_in_bytes"] == D.tree_bytes(out[1])
    assert rec["collectives"]["counts"] == {
        c: {"top": 0, "loop": 0} for c in D.COLLECTIVES}
    assert rec["scan_repeats"] == D.scanned_repeats(cfg)
    tag = "sp" if variant == "base" else f"sp-{variant}"
    saved = json.loads((tmp_path / f"{arch}__{shape}__{tag}.json")
                       .read_text())
    assert saved == json.loads(json.dumps(rec))


def test_specs_only_record_on_the_production_mesh(tmp_path):
    cfg = cfgbase.get("yi-9b")
    for mp in (False, True):
        mesh = M.production_shape(multi_pod=mp)
        rec = D.run_cell("yi-9b", "decode_32k", mesh, tmp_path)
        assert rec["status"] == "specs_only"
        assert rec["mesh"] == list(mesh.sizes) and rec["multi_pod"] is mp
        assert rec["n_devices"] == (512 if mp else 256)
        assert rec["cost_analysis"]["flops"] is None
        assert rec["memory_analysis"]["temp_size_in_bytes"] is None
        assert rec["collectives"] is None
        assert "256 / 512 devices" in rec["reason"]
        # the local shards of every argument, summed
        dp, tp = M.mesh_axes(mesh)
        _, (params, token, caches) = D.cell_step(cfg, "decode_32k")
        want = sum(sh.local_bytes(mesh, leaf, sh.param_spec(
            mesh, sh._path_str(p), tuple(leaf.shape), dp, tp))
            for p, leaf in _tree.leaves_with_paths(params))
        want += sh.local_bytes(mesh, token,
                               sh.batch_spec(mesh, tuple(token.shape), dp))
        want += sum(sh.local_bytes(mesh, leaf, sh.cache_leaf_spec(
            mesh, tuple(leaf.shape), dp, tp)) for leaf in _tree.leaves(caches))
        assert rec["memory_analysis"]["argument_size_in_bytes"] == want + 4
        whole = D.tree_bytes((params, token, caches))
        assert want < whole / 100
    assert (tmp_path / "yi-9b__decode_32k__sp.json").exists()
    assert (tmp_path / "yi-9b__decode_32k__mp.json").exists()


def test_long_500k_skipped_for_full_attention(tmp_path):
    rec = D.run_cell("yi-9b", "long_500k", M.production_shape(), tmp_path)
    assert rec["status"] == "skipped"


def test_production_mesh_needs_its_ranks():
    with pytest.raises(RuntimeError, match="needs 256 ranks, have 1"):
        M.make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        M.make_production_mesh(multi_pod=True)
    assert M.mesh_axes(M.production_shape(multi_pod=True)) == \
        (("pod", "data"), "model")
    assert M.mesh_axes(M.smoke_mesh()) == (("data",), "model")


# ----------------------------------------------------------- mapping plan

def _artifact(tmp_path, arch="yi-9b"):
    jcfg = jbase.reduce_for_smoke(jbase.get(arch))
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    path = tmp_path / f"{arch}.json"
    j_emit(jparams, jcfg, "diana", path, max_cout=64, act_log_scale=2.0)
    return jcfg, path


def test_mapping_plan_report_equals_jax(tmp_path, capsys):
    jcfg, path = _artifact(tmp_path)
    cfg = cfgbase.reduce_for_smoke(cfgbase.get("yi-9b"))
    capsys.readouterr()
    want = jdry.mapping_plan_report(jcfg, str(path))
    jlines = capsys.readouterr().out
    got = D.mapping_plan_report(cfg, str(path))
    lines = capsys.readouterr().out
    assert "error" not in got and got["kernels"]
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert lines == jlines


def test_mapping_that_does_not_lower_exits_2(tiny, tmp_path, capsys):
    _, path = _artifact(tmp_path, "zamba2-1.2b")
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "tiny-yi-9b", "--shape", "tiny_decode",
                "--device", "cpu", "--mapping", str(path), "--out",
                str(tmp_path / "out")])
    assert e.value.code == 2
    captured = capsys.readouterr()
    assert "does not lower onto tiny-yi-9b" in captured.out
    assert "[dryrun] ERROR:" in captured.err


def test_flash_stand_in_counts_the_square_and_allocates_nothing():
    """The dry run's stand-in of the flash kernel (fake tensors only):
    ``out`` written in place, no storage allocated, the full masked
    square counted as the kernel's plain version counts it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models import attention as A
    B, H, KVH, Sq, Sk, hd, Dv = 2, 8, 2, 256, 384, 64, 32
    shapes = ((B, H, Sq, hd), (B, KVH, Sk, hd), (B, KVH, Sk, Dv))
    with FakeTensorMode():
        q, k, v = (torch.empty(s, dtype=torch.bfloat16) for s in shapes)
        out = torch.empty((B, H, Sq, Dv), dtype=torch.bfloat16)
        tracker = D.PeakTracker()
        tracker.track((q, k, v, out))
        before = tracker.peak
        with D._flash_stand_in(), tracker, \
                FlopCounterMode(display=False) as fc:
            got = A.flash_attention(q, k, v, causal=True, kv_len=Sk,
                                    out=out)
        assert got is out and tracker.peak == before
        assert fc.get_total_flops() == 2 * B * H * Sq * Sk * (hd + Dv)
        with FlopCounterMode(display=False) as plain:
            flash_attention_plain(q, k, v, causal=True, kv_len=Sk)
    assert plain.get_total_flops() == fc.get_total_flops()
    assert A.flash_attention is not None and \
        A.flash_attention.__name__ == "flash_attention"
