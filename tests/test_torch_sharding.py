"""The port's sharding rules (`repro_torch.distributed.sharding`) and int8
serving params against the JAX package's: `param_spec` as a tuple for
every leaf of every arch's full-width params, optimiser state and int8
serving params; `batch_spec` / `cache_leaf_spec` for every cell's inputs
and caches on the (1, 1), (16, 16) and (2, 16, 16) meshes (JAX's spec
functions read only ``mesh.shape``, so they get the same `MeshShape`);
`shardings_for_params` and `constrain` on the CPU's (1, 1) mesh;
`quantize_for_serve`'s trees (codes and scales bit for bit, ``meta``
shapes and dtypes), `dense` with ``w_q`` and the decode steps of
quantized float32 reduced yi-9b and deepseek (the MLA absorb's ``kv_b``
dequant) against JAX's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.core import tree as _tree  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCHS = ("arctic-480b", "command-r-35b", "deepseek-v2-lite-16b",
         "h2o-danube-3-4b", "llama-3.2-vision-11b", "nemotron-4-15b",
         "seamless-m4t-large-v2", "xlstm-1.3b", "yi-9b", "zamba2-1.2b")
MESHES = {"1x1": sh.MeshShape(("data", "model"), (1, 1)),
          "16x16": M.production_shape(),
          "2x16x16": M.production_shape(multi_pod=True)}


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


def _jleaves(tree):
    """[(port-style path, leaf)] of a JAX tree of ShapeDtypeStructs."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = []
        for p in path:
            if hasattr(p, "key"):
                parts.append(p.key)
            elif hasattr(p, "idx"):
                parts.append(p.idx)
            else:
                parts.append(p.name)
        out.append((tuple(parts), leaf))
    return out


def _jparams(arch):
    return jax.eval_shape(lambda k: JT.init_lm(k, jbase.get(arch)),
                          jax.random.PRNGKey(0))


def _check_param_specs(ours, theirs, skip=0):
    got = {p: leaf for p, leaf in _tree.leaves_with_paths(ours)}
    want = {p: leaf for p, leaf in _jleaves(theirs)}
    if skip:      # optimiser state: the port's named tuple by index
        got = {(("step", "mu", "nu")[p[0]],) + p[1:]: v
               for p, v in got.items()}
    assert got.keys() == want.keys()
    for mname, mesh in MESHES.items():
        dp, tp = M.mesh_axes(mesh)
        for path, leaf in got.items():
            jleaf = want[path]
            assert tuple(leaf.shape) == tuple(jleaf.shape), path
            ps = sh._path_str(path[skip:])
            a = sh.param_spec(mesh, ps, tuple(leaf.shape), dp, tp)
            b = jsh.param_spec(mesh, ps, jleaf.shape, dp, tp)
            assert tuple(a) == tuple(b), (mname, ps)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch):
    cfg = cfgbase.get(arch)
    _check_param_specs(T.param_shapes(cfg), _jparams(arch))
    # optimiser state: the param spec of the path below the moment
    _check_param_specs(SP.opt_specs(cfg), JSP.opt_specs(jbase.get(arch)),
                       skip=1)
    # int8 serving params (w_q / w_s leaves)
    q = dataclasses.replace(cfg, serve_weight_dtype="int8")
    jq = dataclasses.replace(jbase.get(arch), serve_weight_dtype="int8")
    _check_param_specs(T.quantize_for_serve(T.param_shapes(cfg), q),
                       JT.quantize_for_serve(_jparams(arch), jq))


@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_equal_jax(arch):
    """Every cell's inputs (batch_spec) and caches (cache_leaf_spec)."""
    cfg, jcfg = cfgbase.get(arch), jbase.get(arch)
    for shape in SP.SHAPES:
        if not SP.cell_is_runnable(cfg, shape):
            continue
        ours = SP.input_specs(cfg, shape)
        theirs = JSP.input_specs(jcfg, shape)
        caches = ours.pop("caches", None)
        jcaches = theirs.pop("caches", None)
        ours.pop("index", None)
        theirs.pop("index", None)
        for mesh in MESHES.values():
            dp, tp = M.mesh_axes(mesh)
            for (p, a), (q, b) in zip(_tree.leaves_with_paths(ours),
                                      _jleaves(theirs)):
                assert p == q and tuple(a.shape) == tuple(b.shape)
                assert tuple(sh.batch_spec(mesh, tuple(a.shape), dp)) == \
                    tuple(jsh.batch_spec(mesh, b.shape, dp)), (shape, p)
            if caches is None:
                continue
            got, want = _tree.leaves_with_paths(caches), _jleaves(jcaches)
            assert [p for p, _ in got] == [p for p, _ in want]
            for (p, a), (_, b) in zip(got, want):
                assert tuple(sh.cache_leaf_spec(mesh, tuple(a.shape), dp,
                                                tp)) == \
                    tuple(jsh.cache_leaf_spec(mesh, b.shape, dp, tp)), \
                    (shape, p)


def test_shardings_for_params_on_the_smoke_mesh():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = M.smoke_mesh()
    cfg = cfgbase.reduce_for_smoke(cfgbase.get("yi-9b"))
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    dp, tp = M.mesh_axes(mesh)
    pl = sh.shardings_for_params(mesh, params, dp, tp)
    leaves = _tree.leaves_with_paths(params)
    places = _tree.leaves(pl, is_leaf=lambda n: isinstance(n, tuple) and
                          n and not isinstance(n[0], (dict, tuple, list)))
    assert len(places) == len(leaves)
    by_path = dict(zip((sh._path_str(p) for p, _ in leaves), places))
    # (R, in, out) wq over (None, data, model); wo the other way round
    assert by_path["units/0/attn/wq/w"] == (Shard(1), Shard(2))
    assert by_path["units/0/attn/wo/w"] == (Shard(2), Shard(1))
    assert by_path["emb"] == (Shard(1), Shard(0))
    assert by_path["final_norm/scale"] == (Replicate(), Replicate())
    w = params["units"][0]["attn"]["wq"]["w"]
    d = distribute_tensor(w, mesh, by_path["units/0/attn/wq/w"])
    assert torch.equal(d.full_tensor(), w)
    # constrain: redistributes a DTensor under configured axes
    x = distribute_tensor(torch.randn(2, 4, 8), mesh,
                          (Replicate(), Replicate()))
    sh.set_mesh_axes(dp, tp, mesh)
    try:
        y = sh.constrain(x, "act")
        assert y.placements == (Shard(0), Shard(2))
        assert torch.equal(y.full_tensor(), x.full_tensor())
        plain = torch.randn(2, 4, 8)
        assert sh.constrain(plain, "act") is plain
    finally:
        sh.clear_mesh_axes()


def test_constrain_is_a_no_op_without_axes():
    assert not sh.axes_configured()
    x = torch.randn(2, 3, 4)
    for kind in ("act", "act_rep", "moe_grouped", "moe_expert"):
        assert sh.constrain(x, kind) is x


# ----------------------------------------------------------- int8 serving

def _reduced(arch):
    over = dict(param_dtype="float32", serve_weight_dtype="int8")
    jcfg = dataclasses.replace(jbase.reduce_for_smoke(jbase.get(arch)),
                               **over)
    cfg = dataclasses.replace(cfgbase.reduce_for_smoke(cfgbase.get(arch)),
                              **over)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


@pytest.mark.parametrize("arch", ("yi-9b", "deepseek-v2-lite-16b",
                                  "zamba2-1.2b", "xlstm-1.3b"))
def test_quantize_for_serve_equals_jax(arch):
    jcfg, cfg, jparams, params = _reduced(arch)
    ours = T.quantize_for_serve(params, cfg)
    theirs = JT.quantize_for_serve(jparams, jcfg)
    got, want = _tree.leaves_with_paths(ours), _jleaves(theirs)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert any(p[-1] == "w_q" for p, _ in got)
    for (p, a), (_, b) in zip(got, want):
        b = np.asarray(b)
        assert str(a.dtype).split(".")[-1] == str(b.dtype), p
        np.testing.assert_array_equal(a.numpy(), b, err_msg=str(p))
    # meta params: the same ops give meta codes and scales of JAX's
    # ShapeDtypeStructs
    meta = T.quantize_for_serve(T.param_shapes(cfg), cfg)
    jmeta = JT.quantize_for_serve(jax.eval_shape(
        lambda k: JT.init_lm(k, jcfg), jax.random.PRNGKey(0)), jcfg)
    for (p, a), (_, b) in zip(_tree.leaves_with_paths(meta),
                              _jleaves(jmeta)):
        assert a.is_meta and tuple(a.shape) == tuple(b.shape), p
        assert str(a.dtype).split(".")[-1] == str(b.dtype), p
    # another config leaves the params as they are
    assert T.quantize_for_serve(params, cfgbase.reduce_for_smoke(
        cfgbase.get(arch))) is params


def test_dense_with_int8_codes_equals_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 48, 40)).astype(np.float32)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    cfg = dataclasses.replace(cfgbase.get("yi-9b"), serve_weight_dtype="int8")
    jcfg = dataclasses.replace(jbase.get("yi-9b"), serve_weight_dtype="int8")
    p = T.quantize_for_serve({"emb": torch.zeros(1), "l": {
        "w": torch.from_numpy(w), "b": torch.ones(40)}}, cfg)["l"]
    jp = JT.quantize_for_serve({"emb": jnp.zeros(1), "l": {
        "w": jnp.asarray(w), "b": jnp.ones(40)}}, jcfg)["l"]
    assert set(p) == {"w_q", "w_s", "b"}
    got = L.dense(p, torch.from_numpy(x)).numpy()
    want = np.asarray(JL.dense(jp, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ("yi-9b", "deepseek-v2-lite-16b"))
def test_quantized_decode_equals_jax(arch):
    """One prefill and two decode steps on the int8 serving params: every
    projection through `dense`'s ``w_q`` branch, the head dequantized,
    deepseek's absorbed decode dequantizing ``kv_b``; logits within
    1e-4."""
    jcfg, cfg, jparams, params = _reduced(arch)
    qp = T.quantize_for_serve(params, cfg)
    jqp = JT.quantize_for_serve(jparams, jcfg)
    B, S, S_max = 2, 8, 16
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S))
    caches = T.init_cache(cfg, B, S_max, device="cpu")
    jcaches = JT.init_cache(jcfg, B, S_max)
    with torch.no_grad():
        lg, caches = T.prefill(qp, cfg, torch.from_numpy(tokens), caches)
    jlg, jcaches = JT.prefill(jqp, jcfg, jnp.asarray(tokens), jcaches)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4,
                               rtol=0)
    tok = np.argmax(np.asarray(jlg), -1)
    for i in range(2):
        with torch.no_grad():
            lg, caches = T.decode_step(qp, cfg, torch.from_numpy(tok),
                                       caches, S + i)
        jlg, jcaches = JT.decode_step(jqp, jcfg, jnp.asarray(tok), jcaches,
                                      S + i)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4,
                                   rtol=0)
        tok = np.argmax(np.asarray(jlg), -1)
