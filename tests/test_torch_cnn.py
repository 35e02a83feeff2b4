"""The port's conv execution against the JAX package: im2col, the
grouped-weight expansion, conv layers bound and executed on every plan
kernel (K and N held padded), the managed conv primitives, the backend's
mismatch errors and declines, the ``serve --arch cnn:...`` CLI, the
majority-dtype fall-back of ``serve``, and the kernel wrappers' guard on
int dimensions.  The JAX kernels run in interpret mode; the models
themselves are in `test_torch_cnn_models.py`."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.api import MappingArtifact as JArtifact  # noqa: E402
from repro.api.platforms import Platform as JPlatform  # noqa: E402
from repro.core import baselines as jbaselines  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import managed as jmg  # noqa: E402
from repro.runtime import execute as jex  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch.api import MappingArtifact  # noqa: E402
from repro_torch.launch.train import emit_static_mapping  # noqa: E402
from repro_torch.models import cnn as C  # noqa: E402
from repro_torch.models import managed as mg  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.runtime import execute as ex  # noqa: E402

MODELS = ("resnet20_tiny", "mobilenetv1_tiny")
PLATFORMS = ("diana", "gpu_tc_like")
BN16 = {"*": {"bn": 16}}
#: one-layer artifacts per plan kernel: domains and the assignment of C_out
#: channels (the split kernels' boundary falls inside the second 16-column
#: block under bn 16)
DIGITAL = {"name": "digital", "weight_bits": 8, "act_bits": 8}
KERNEL_DOCS = {
    "quant_matmul": ([DIGITAL], lambda co: [0] * co),
    "ternary_matmul": ([{"name": "aimc", "weight_bits": 2, "act_bits": 8}],
                       lambda co: [0] * co),
    "split_ternary": ([DIGITAL, {"name": "aimc", "weight_bits": 2,
                                 "act_bits": 8}],
                      lambda co: [0] * 9 + [1] * (co - 9)),
    "split_precision": ([DIGITAL, {"name": "bf16", "weight_bits": 16,
                                   "act_bits": 16}],
                        lambda co: [1] * 5 + [0] * 9 + [1] * (co - 14)),
    "fp": ([{"name": "bf16", "weight_bits": 16, "act_bits": 16}],
           lambda co: [0] * co),
}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# --------------------------------------------------------------------------
# im2col and the grouped expansion
# --------------------------------------------------------------------------

@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("kh,kw,H,W", [(3, 3, 7, 9), (1, 1, 6, 5),
                                       (3, 1, 8, 7), (3, 3, 4, 4)])
def test_im2col_matches_jax(kh, kw, H, W, stride, padding):
    """(kh, kw, C) patch order and XLA's SAME / VALID padding (the odd pad
    of SAME at the bottom and right); ``width`` appends zero columns."""
    x = np.random.default_rng(H * W + kh).normal(
        size=(2, H, W, 5)).astype(np.float32)
    want = np.asarray(jex.im2col(jnp.asarray(x), kh, kw, stride, padding))
    got = ex.im2col(_t(x), kh, kw, stride, padding)
    np.testing.assert_array_equal(got.numpy(), want)
    wide = ex.im2col(_t(x), kh, kw, stride, padding, width=want.shape[-1] + 3)
    np.testing.assert_array_equal(wide[..., :want.shape[-1]].numpy(), want)
    assert not wide[..., want.shape[-1]:].any()


def test_im2col_rejects_what_xla_rejects():
    x = torch.zeros((1, 2, 2, 3))
    with pytest.raises(ex.ExecutionError, match="exceeds"):
        ex.im2col(x, 3, 3, 1, "VALID")
    with pytest.raises(ex.ExecutionError, match="padding"):
        ex.im2col(x, 1, 1, 1, "FULL")


@pytest.mark.parametrize("kh,cpg,groups,opg", [(1, 2, 3, 2), (3, 1, 8, 1),
                                               (3, 2, 4, 3)])
def test_expand_grouped_matches_jax(kh, cpg, groups, opg):
    """Block-diagonal: input block g reaches output block g only; every
    other entry is exactly zero, as JAX's."""
    w = np.random.default_rng(groups).normal(
        size=(kh, kh, cpg, groups * opg)).astype(np.float32)
    want = np.asarray(jex._expand_grouped(jnp.asarray(w), groups))
    got = ex._expand_grouped(_t(w), groups).numpy()
    np.testing.assert_array_equal(got, want)
    for g in range(groups):
        blk = got[:, :, g * cpg:(g + 1) * cpg]
        np.testing.assert_array_equal(blk[..., g * opg:(g + 1) * opg],
                                      w[..., g * opg:(g + 1) * opg])
        off = np.delete(blk, np.s_[g * opg:(g + 1) * opg], axis=-1)
        assert (off == 0).all()
    with pytest.raises(ex.ExecutionError, match="divide"):
        ex._expand_grouped(_t(w[..., :-1]), groups)


# --------------------------------------------------------------------------
# conv layers on every plan kernel
# --------------------------------------------------------------------------

def _same_layer_plan(tl: dict, jl: dict):
    """Two plan layers' JSON equal, their weight log-scales within 1e-6
    (the two packages' max-abs rounds differently in the last bit)."""
    key = "w_log_scales"
    assert {k: v for k, v in tl.items() if k != key} == \
        {k: v for k, v in jl.items() if k != key}
    np.testing.assert_allclose(tl[key], jl[key], rtol=0, atol=1e-6)


def _conv_pair(kernel, kh, ci, co, groups, seed):
    """(JAX prepared layer, port prepared layer, JAX weight, bias) of a
    one-layer conv artifact lowered onto ``kernel`` (split kernels with bn
    16) in both packages."""
    domains, assign = KERNEL_DOCS[kernel]
    layer = {"name": "c", "searchable": True, "assignment": assign(co),
             "counts": [assign(co).count(d) for d in range(len(domains))]}
    if groups > 1:
        layer["groups"] = groups
    doc = {"schema_version": 2, "model": "conv", "domains": domains,
           "layers": [layer]}
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(kh, kh, ci // groups, co)) * 0.3).astype(
        np.float32)
    b = (rng.normal(size=(co,)) * 0.1).astype(np.float32)
    tuning = BN16 if kernel.startswith("split") else None
    jparams = {"c": {"w": jnp.asarray(w), "b": jnp.asarray(b)}}
    params = {"c": {"w": _t(w), "b": _t(b)}}
    jlp = jrt.lower(doc, params=jparams, tuning=tuning)["c"]
    lp = rt.lower(doc, params=params, tuning=tuning)["c"]
    assert lp.kernel == jlp.kernel == kernel
    _same_layer_plan(json.loads(json.dumps(lp.to_dict())),
                     json.loads(json.dumps(jlp.to_dict())))
    bits = [d["weight_bits"] for d in domains]
    jprep = jex.prepare_layer(jlp, jparams["c"]["w"], jparams["c"]["b"],
                              domain_bits=bits)
    prep = ex.prepare_layer(lp, params["c"]["w"], params["c"]["b"],
                            domain_bits=bits)
    return jprep, prep, w, b


#: (kernel size, C_in, C_out, groups): a stem-like conv (K 27 -> 32, N 24
#: off the split kernels' 16), a grouped one (K 72 -> 80) and a 1x1 conv
#: (K 8 -> 16)
CONV_SHAPES = [(3, 3, 24, 1), (3, 8, 24, 4), (1, 8, 24, 1)]


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=["stem", "grouped", "1x1"])
@pytest.mark.parametrize("kernel", sorted(KERNEL_DOCS))
def test_prepare_conv_layer_matches_jax(kernel, shape):
    """A 4-D (grouped: zero-embedded) weight binds as JAX's does: the same
    codes and steps (scales within 1e-6) in the first K x C_out entries;
    K is held zero-padded to 16 and the split kernels' N to 16, every int8
    kernel's codes K-major."""
    kh, ci, co, groups = shape
    jprep, prep, _, _ = _conv_pair(kernel, kh, ci, co, groups, seed=3)
    k = kh * kh * ci
    assert jprep.conv_shape == prep.conv_shape == (kh, kh, ci, co)
    assert prep.conv_groups == groups
    assert (prep.k_in, prep.k_pad) == (k, -(-k // 16) * 16)
    n_pad = -(-co // 16) * 16 if kernel.startswith("split") else co
    if kernel == "fp":
        assert prep.w_q is None and tuple(prep.w_perm.shape) == \
            (prep.k_pad, co)
        np.testing.assert_array_equal(prep.w_perm[:k].numpy(),
                                      np.asarray(jprep.w_perm))
        assert not prep.w_perm[k:].any()
        return
    assert tuple(prep.w_q.shape) == (prep.k_pad, n_pad)
    assert prep.w_q.stride() == (1, prep.k_pad)
    np.testing.assert_array_equal(prep.w_q[:k, :co].numpy(),
                                  np.asarray(jprep.w_q))
    assert not prep.w_q[k:].any() and not prep.w_q[:, co:].any()
    np.testing.assert_allclose(prep.sw[:co].numpy(), np.asarray(jprep.sw),
                               rtol=1e-6, atol=0)
    if kernel == "split_ternary":
        assert tuple(prep.w_t_packed.shape) == (prep.k_pad // 4, n_pad)
    if kernel == "split_precision":
        assert tuple(prep.w_bf16.shape) == (prep.k_pad, n_pad)
        np.testing.assert_array_equal(
            prep.w_bf16[:k, :co].float().numpy(),
            np.asarray(jprep.w_bf16.astype(jnp.float32)))


@pytest.mark.parametrize("case", [(3, 3, 24, 1, 1, "SAME"),
                                  (3, 3, 24, 1, 2, "SAME"),
                                  (3, 8, 24, 4, 2, "VALID"),
                                  (1, 8, 24, 1, 2, "SAME")],
                         ids=["stem", "stride2", "grouped", "proj"])
@pytest.mark.parametrize("kernel", sorted(KERNEL_DOCS))
def test_execute_conv_layer_matches_jax(kernel, case):
    """`execute_conv_layer` against JAX's on the interpreted Pallas
    kernel: the activation codes of the patches equal, outputs within
    1e-5."""
    kh, ci, co, groups, stride, padding = case
    jprep, prep, _, _ = _conv_pair(kernel, kh, ci, co, groups, seed=4)
    x = np.random.default_rng(5).normal(size=(2, 7, 9, ci)).astype(
        np.float32)
    want = np.asarray(jex.execute_conv_layer(jprep, jnp.asarray(x), stride,
                                             padding, interpret=True))
    got = ex.execute_conv_layer(prep, _t(x), stride, padding)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if kernel != "fp":
        jpatch = jex.im2col(jnp.asarray(x), kh, kh, stride, padding)
        jq, jsx = jex._act_quant(jpatch.reshape(-1, jpatch.shape[-1]), jprep)
        patch = ex.im2col(_t(x), kh, kh, stride, padding, width=prep.k_pad)
        q, sx = ex._act_quant(patch.reshape(-1, prep.k_pad), prep)
        np.testing.assert_array_equal(q[:, :prep.k_in].numpy(),
                                      np.asarray(jq))
        assert not q[:, prep.k_in:].any()
        assert float(sx) == pytest.approx(float(jsx), rel=1e-6)
    ref = ex.execute_conv_layer(prep, _t(x), stride, padding,
                                reference=True)
    np.testing.assert_allclose(ref.numpy(), want, rtol=0, atol=1e-5)


def test_dense_layer_with_k_off_the_alignment_matches_jax():
    """A 2-D layer whose K (20) is off 16 is held padded too; its input is
    padded per call."""
    w = np.random.default_rng(6).normal(size=(20, 24)).astype(np.float32)
    doc = {"schema_version": 2, "model": "d", "domains": [DIGITAL],
           "layers": [{"name": "d", "searchable": True,
                       "assignment": [0] * 24, "counts": [24]}]}
    jlp = jrt.lower(doc, params={"d": {"w": jnp.asarray(w)}})["d"]
    lp = rt.lower(doc, params={"d": {"w": _t(w)}})["d"]
    jprep = jex.prepare_layer(jlp, jnp.asarray(w))
    prep = ex.prepare_layer(lp, _t(w))
    assert prep.conv_shape is None and prep.k_pad == 32
    x = np.random.default_rng(7).normal(size=(3, 5, 20)).astype(np.float32)
    want = np.asarray(jex.execute_layer(jprep, jnp.asarray(x),
                                        interpret=True))
    np.testing.assert_allclose(ex.execute_layer(prep, _t(x)).numpy(), want,
                               rtol=0, atol=1e-5)
    with pytest.raises(ex.ExecutionError, match="features"):
        ex.execute_layer(prep, _t(x[..., :19]))


# --------------------------------------------------------------------------
# managed primitives
# --------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"),
                                            (2, "VALID")])
@pytest.mark.parametrize("kh", [1, 3])
def test_managed_conv_matches_lax(kh, stride, padding, groups):
    """`managed.conv2d` / `conv2d_linear` default path (F.conv2d with
    XLA's padding made explicit) against lax.conv_general_dilated and the
    JAX primitives, within 1e-5."""
    rng = np.random.default_rng(kh * 10 + stride + groups)
    x = rng.normal(size=(2, 9, 8, 8)).astype(np.float32)
    p = {"w": (rng.normal(size=(kh, kh, 8 // groups, 12)) * 0.3).astype(
        np.float32), "b": rng.normal(size=(12,)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    lin = jax.lax.conv_general_dilated(
        jnp.asarray(x), jp["w"], (stride, stride), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups) + jp["b"]
    got = mg.conv2d_linear(tp, _t(x), stride=stride, padding=padding,
                           groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(lin), rtol=0,
                               atol=1e-5)
    want = jmg.conv2d(jp, jnp.asarray(x), stride=stride, padding=padding,
                      groups=groups)
    got = mg.conv2d(tp, _t(x), stride=stride, padding=padding, groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_managed_search_modes_wait_for_the_search_side():
    """The managed layers' modes: a layer built without a spec stays in
    floats in every mode; one built with a spec carries the ODiMO state
    and runs every mode (the search, finetune and deploy modes held
    against the JAX package in tests/test_torch_search_core.py).  The name
    dates from when these modes waited for the search side, which now
    runs them; it is kept so that the test's record carries across."""
    from repro_torch.core.odimo import ODiMOSpec
    gen = torch.Generator().manual_seed(0)
    p = mg.init_conv(gen, 3, 3, 4, 8)
    assert tuple(p["w"].shape) == (3, 3, 4, 8) and not p["b"].any()
    assert set(p) == {"w", "b"}
    x = torch.randn((1, 4, 4, 4), generator=gen)
    fp = mg.conv2d(p, x)
    for mode in ("search", "finetune", "deploy"):
        assert torch.equal(mg.conv2d(p, x, mode=mode), fp)
    spec = ODiMOSpec()
    q = mg.init_dense(gen, 4, 8, spec=spec)
    assert tuple(q["odimo"]["alpha"].shape) == (2, 8)
    assert tuple(q["odimo"]["log_scales"].shape) == (2,)
    assert float(q["act_log_scale"]) == 1.0
    h = torch.randn((3, 4), generator=gen)
    for mode in ("search", "finetune", "deploy"):
        y = mg.dense(q, h, spec, mode, tau=0.5)
        assert y.shape == (3, 8) and bool(torch.isfinite(y).all())
        assert not torch.equal(y, mg.dense(q, h, spec, "fp"))


# --------------------------------------------------------------------------
# backend errors and declines
# --------------------------------------------------------------------------

def _one_layer_backend(w, groups=None):
    c = int(w.shape[-1])
    layer = {"name": "c", "searchable": True, "assignment": [0] * c,
             "counts": [c]}
    if groups:
        layer["groups"] = groups
    doc = {"schema_version": 2, "model": "m", "domains": [DIGITAL],
           "layers": [layer]}
    params = {"c": {"w": w, "b": torch.zeros(c)}}
    return rt.PlannedBackend(rt.lower(doc, params=params), params), params


def test_backend_rejects_mismatched_call_sites():
    """A conv call site on a dense-bound name, a dense call site on a
    conv-bound name and a groups mismatch raise JAX's ExecutionErrors."""
    conv = {"stride": 1, "padding": "SAME", "groups": 1}
    dense_be, dp = _one_layer_backend(torch.randn(8, 16))
    with pytest.raises(rt.ExecutionError, match="2-D dense weight"):
        dense_be("c", dp["c"], torch.randn(1, 4, 4, 8), conv=conv)
    conv_be, cp = _one_layer_backend(torch.randn(3, 3, 8, 16))
    with pytest.raises(rt.ExecutionError, match="conv weight"):
        conv_be("c", cp["c"], torch.randn(2, 72))
    grouped_be, gp = _one_layer_backend(torch.randn(3, 3, 2, 16), groups=4)
    with pytest.raises(rt.ExecutionError, match="groups=2"):
        grouped_be("c", gp["c"], torch.randn(1, 4, 4, 8),
                   conv=dict(conv, groups=2))
    y = grouped_be("c", gp["c"], torch.randn(1, 4, 4, 8),
                   conv=dict(conv, groups=4))
    assert tuple(y.shape) == (1, 4, 4, 16)


def test_grouped_call_site_on_an_ungrouped_plan_declines_with_reason():
    """A plan lowered without groups meets a depthwise call site: declined
    (the default path runs) and recorded with the reason, as JAX's."""
    w = torch.randn(3, 3, 1, 8)
    backend, params = _one_layer_backend(w)
    x = torch.randn(1, 6, 6, 8)
    with mg.matmul_backend(backend):
        y = mg.conv2d(params["c"], x, groups=8, name="c")
    np.testing.assert_array_equal(y.numpy(),
                                  mg.conv2d(params["c"], x, groups=8).numpy())
    assert "grouped conv (groups=8)" in backend.runtime_declines["c"]
    jw = jnp.asarray(w.numpy())
    jdoc = {"schema_version": 2, "model": "m", "domains": [DIGITAL],
            "layers": [{"name": "c", "searchable": True,
                        "assignment": [0] * 8, "counts": [8]}]}
    jp = {"c": {"w": jw, "b": jnp.zeros(8)}}
    jb = jrt.PlannedBackend(jrt.lower(jdoc, params=jp), jp, interpret=True)
    with jmg.matmul_backend(jb):
        jmg.conv2d(jp["c"], jnp.asarray(x.numpy()), groups=8, name="c")
    assert jb.runtime_declines == backend.runtime_declines


# --------------------------------------------------------------------------
# the serve CLI
# --------------------------------------------------------------------------

def _cnn_args(name, *extra):
    return ["--arch", f"cnn:{name}", "--device", "cpu", "--requests", "3",
            *extra]


@pytest.mark.parametrize("platform", PLATFORMS)
def test_serve_cnn_with_full_coverage(tmp_path, capsys, platform):
    """``serve --arch cnn:resnet20_tiny --mapping m.json
    --require-full-coverage`` on the CPU, the artifact emitted from the
    port's own params of the same seed."""
    from repro_torch.launch import serve
    cfg = C.get_config("resnet20_tiny")
    params = C.get_model(cfg)[0](torch.Generator().manual_seed(0), cfg)
    path = tmp_path / "m.json"
    emit_static_mapping(params, cfg, platform, path,
                        plan_hints=C.plan_hints(cfg))
    logits, stats = serve.main(_cnn_args("resnet20_tiny", "--mapping",
                                         str(path),
                                         "--require-full-coverage"))
    out = capsys.readouterr().out
    assert tuple(logits.shape) == (3, 10) and stats["forward_s"] > 0
    assert "22/22 planned layers bound to weights" in out
    assert "[serve] resnet20_tiny on cpu: 3 images in" in out
    plain, _ = serve.main(_cnn_args("resnet20_tiny"))
    assert tuple(plain.shape) == (3, 10)


def test_serve_cnn_refuses_engine_and_bad_artifacts(tmp_path):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as exc:
        serve.main(_cnn_args("resnet20_tiny", "--engine"))
    assert exc.value.code == 2
    cfg = C.get_config("mobilenetv1_tiny")
    params = C.get_model(cfg)[0](torch.Generator().manual_seed(0), cfg)
    path = tmp_path / "m.json"
    emit_static_mapping(params, cfg, "diana", path,
                        plan_hints=C.plan_hints(cfg))
    # a mobilenet artifact does not lower onto resnet20: exit 2, no
    # fall-back (as JAX's serve_cnn)
    with pytest.raises(SystemExit) as exc:
        serve.main(_cnn_args("resnet20_tiny", "--mapping", str(path)))
    assert exc.value.code == 2
    logits, _ = serve.main(_cnn_args("mobilenetv1_tiny", "--mapping",
                                     str(path), "--require-full-coverage"))
    assert tuple(logits.shape) == (3, 2)


# --------------------------------------------------------------------------
# the majority-dtype fall-back
# --------------------------------------------------------------------------

def test_apply_mapping_artifact_counts_searchable_votes_only():
    """Only searchable layers vote, as JAX's ``apply_mapping_artifact``;
    with none searchable every layer votes."""
    from repro.configs import base as jcfgbase
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch import serve
    jcfgbase.load_all()
    cfgbase.load_all()
    jcfg = jcfgbase.reduce_for_smoke(jcfgbase.get("yi-9b"))
    cfg = cfgbase.reduce_for_smoke(cfgbase.get("yi-9b"))
    spec = JPlatform.get("diana").spec()
    a_pinned = np.zeros(512, np.int64)
    cases = [([("pinned", None, False), ("chosen", None, True)],
              [a_pinned, np.ones(32, np.int64)]),
             ([("pinned", None, False)], [a_pinned]),
             ([("a", None, True), ("b", None, True)],
              [np.ones(8, np.int64), np.zeros(4, np.int64)])]
    for plan, assigns in cases:
        ja = JArtifact.from_search(
            "vote", spec, plan, assigns,
            jbaselines.counts_from_assignments(assigns, 2))
        ta = MappingArtifact.from_dict(ja.to_dict())
        jnew, jdom = jserve.apply_mapping_artifact(jcfg, ja)
        new, dom = serve.apply_mapping_artifact(cfg, ta)
        assert dom == jdom
        assert (new.serve_weight_dtype, new.kv_cache_dtype) == \
            (jnew.serve_weight_dtype, jnew.kv_cache_dtype)


def _lm_args(path, *extra):
    return ["--arch", "yi-9b", "--reduce", "--device", "cpu", "--requests",
            "1", "--prompt-len", "4", "--gen-len", "2", "--mapping",
            str(path), *extra]


@pytest.fixture(scope="module")
def lm_artifact(tmp_path_factory):
    """A diana artifact of reduced yi-9b (the port's params of seed 0) and
    a copy of it that does not lower (one assignment short)."""
    from repro_torch.configs import base as cfgbase
    cfgbase.load_all()
    cfg = cfgbase.reduce_for_smoke(cfgbase.get("yi-9b"))
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    d = tmp_path_factory.mktemp("lm")
    good = d / "good.json"
    art = emit_static_mapping(params, cfg, "diana", good, max_cout=64,
                              act_log_scale=2.0)
    doc = art.to_dict()
    doc["layers"][3]["assignment"] = doc["layers"][3]["assignment"][:-1]
    doc["layers"][3]["counts"][-1] -= 1
    bad = d / "bad.json"
    bad.write_text(json.dumps(doc))
    return good, bad


@pytest.mark.parametrize("case", ["does_not_lower", "mapping_fallback"])
def test_serve_falls_back_to_majority_dtypes(lm_artifact, capsys, case):
    """An artifact that fails to lower, or ``--mapping-fallback``, serves
    unplanned with the majority domain's dtypes (the searchable layers'
    majority on diana is the ternary domain: int8 weights and KV cache);
    ``--require-full-coverage`` exits 2."""
    from repro_torch.launch import serve
    good, bad = lm_artifact
    args = (_lm_args(bad) if case == "does_not_lower"
            else _lm_args(good, "--mapping-fallback"))
    tokens, _ = serve.main(args)
    out = capsys.readouterr().out
    assert tuple(tokens.shape) == (1, 2)
    assert "FALLBACK majority domain=aimc -> weights=int8 kv=int8" in out
    assert "per-layer planned execution" not in out
    with pytest.raises(SystemExit) as exc:
        serve.main(args + ["--require-full-coverage"])
    assert exc.value.code == 2


def test_kernel_wrappers_refuse_dims_that_overflow_int():
    """M past a C int is refused, not wrapped (expanded views: no memory)."""
    from repro_torch.kernels import ops
    x = torch.zeros((1, 16), dtype=torch.int8).expand(2**31, 16)
    w = torch.zeros((16, 4), dtype=torch.int8)
    sx, sw = torch.tensor(1.0), torch.ones(4)
    for call in (lambda: ops.quant_matmul_op(x, w, sx, sw),
                 lambda: ops.ternary_matmul_op(x, w, sx, sw),
                 lambda: ops.split_ternary_op(
                     x, w, torch.zeros((4, 4), dtype=torch.uint8), sx, sw,
                     2)):
        with pytest.raises(ValueError, match="C int"):
            call()
