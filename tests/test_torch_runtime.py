"""The port's mapping pipeline against the JAX package: cost models,
platforms, min-cost split, artifact emission (with and without a domain
bias), lowering (plan JSON) and planned layer execution, on a reduced
yi-9b whose parameters are the JAX package's, imported through numpy.

The mappings are the three the port serves: ``diana`` (split_ternary),
``gpu_tc_like`` (split_precision) and ``diana`` biased to ``("aimc",
1.0)`` (ternary_matmul).  Reduced yi-9b's searchable layers have 64 output
columns, which the default N-block (128) aligns entirely onto the int8
path; plans of ``gpu_tc_like`` are therefore also lowered with ``bn=16``,
the only way the reduced model reaches split_precision's bf16 columns."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcfgbase  # noqa: E402
from repro.core import baselines as jbaselines  # noqa: E402
from repro.api.platforms import Platform as JPlatform  # noqa: E402
from repro.core import cost_models as jcost  # noqa: E402
from repro.launch.train import emit_static_mapping as j_emit  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.api import Platform  # noqa: E402
from repro_torch.core import baselines, cost_models  # noqa: E402
from repro_torch.kernels.split_precision import (  # noqa: E402
    bf16_error_bound)
from repro_torch.launch.train import emit_static_mapping  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch.runtime.plan import ExecutionPlan  # noqa: E402

MAX_COUT = 64   # layers wider than this pin to int8: both kernels appear
#: the slice-2 mappings: platform and emission bias
MAPPINGS = {"gpu_tc_like": ("gpu_tc_like", None),
            "ternary": ("diana", ("aimc", 1.0))}
BN16 = {"*": {"bn": 16}}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    jcfgbase.load_all()
    jcfg = jcfgbase.reduce_for_smoke(jcfgbase.get("yi-9b"))
    cfg = cfgbase.reduce_for_smoke(cfgbase.get("yi-9b"))
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


@pytest.fixture(scope="module")
def artifacts(model, tmp_path_factory):
    jcfg, jparams, cfg, params = model
    d = tmp_path_factory.mktemp("art")
    ja = j_emit(jparams, jcfg, "diana", d / "jax.json", max_cout=MAX_COUT,
                act_log_scale=2.0)
    ta = emit_static_mapping(params, cfg, "diana", d / "torch.json",
                             max_cout=MAX_COUT, act_log_scale=2.0)
    return ja.to_dict(), ta.to_dict()


@pytest.fixture(scope="module")
def mappings(model, tmp_path_factory):
    """{key: (JAX artifact dict, port artifact dict)} of `MAPPINGS`."""
    jcfg, jparams, cfg, params = model
    d = tmp_path_factory.mktemp("maps")
    out = {}
    for key, (plat, bias) in MAPPINGS.items():
        ja = j_emit(jparams, jcfg, plat, d / f"j_{key}.json",
                    max_cout=MAX_COUT, act_log_scale=2.0, bias=bias)
        ta = emit_static_mapping(params, cfg, plat, d / f"t_{key}.json",
                                 max_cout=MAX_COUT, act_log_scale=2.0,
                                 bias=bias)
        out[key] = (ja.to_dict(), ta.to_dict())
    return out


def test_min_cost_full_width_kv_split():
    (a,) = baselines.min_cost(cost_models.DianaCostModel(),
                              [cost_models.LayerGeometry(4096, 512)])
    assert int((a == 1).sum()) == 505 and int((a == 0).sum()) == 7


def test_min_cost_matches_jax_on_small_geometries():
    shapes = [(64, 64), (64, 128), (300, 40), (1200, 33)]
    got = baselines.min_cost(cost_models.DianaCostModel(),
                             [cost_models.LayerGeometry(*s) for s in shapes],
                             searchable=[True, True, False, True])
    want = jbaselines.min_cost(jcost.DianaCostModel(),
                               [jcost.LayerGeometry(*s) for s in shapes],
                               searchable=[True, True, False, True])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_min_cost_full_width_gpu_tc_split():
    """gpu_tc_like prices int8 at twice the fp16 throughput: 342 int8 and
    170 fp16 columns balance (4096, 512)."""
    cm = Platform.get("gpu_tc_like").cost_model()
    (a,) = baselines.min_cost(cm, [cost_models.LayerGeometry(4096, 512)])
    assert int((a == 0).sum()) == 342 and int((a == 1).sum()) == 170


@pytest.mark.parametrize("name", ["diana_abstract", "diana_ideal_shutdown",
                                  "gpu_tc_like"])
def test_abstract_cost_model_matches_jax(name):
    cm, jcm = Platform.get(name).cost_model(), JPlatform.get(name).cost_model()
    geoms = [(4096, 512), (64, 64, 3, 3, 8, 8), (300, 40, 1, 1, 1, 1, 4)]
    for g in geoms:
        counts = np.asarray([7.0, 33.0], np.float32)
        np.testing.assert_array_equal(
            cm.latency(cost_models.LayerGeometry(*g), counts),
            np.asarray(jcm.latency(jcost.LayerGeometry(*g), counts)))
    np.testing.assert_array_equal(cm.p_act(), np.asarray(jcm.p_act()))
    np.testing.assert_array_equal(cm.p_idle(), np.asarray(jcm.p_idle()))
    shapes = [(64, 64), (64, 128), (300, 40), (1200, 33)]
    got = baselines.min_cost(cm, [cost_models.LayerGeometry(*s)
                                  for s in shapes])
    want = jbaselines.min_cost(jcm, [jcost.LayerGeometry(*s)
                                     for s in shapes])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw", [
    dict(p_act=(1.0, 2.0, 3.0)), dict(throughput=(1.0, 2.0, 3.0)),
    dict(p_act=(1.0,), throughput=(1.0,))])
def test_abstract_cost_model_rejects_mismatched_lengths(kw):
    with pytest.raises(ValueError) as want:
        jcost.AbstractCostModel(False, **kw)
    with pytest.raises(ValueError, match="must match 2 domains") as got:
        cost_models.AbstractCostModel(False, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["diana", "gpu_tc_like", "diana_abstract",
                                  "diana_ideal_shutdown"])
def test_kernel_capabilities_match_jax(name):
    p, jp = Platform.get(name), JPlatform.get(name)
    assert [dataclasses.astuple(d) for d in p.domains] == \
        [dataclasses.astuple(d) for d in jp.domains]
    assert p.kernel_capabilities() == jp.kernel_capabilities()


def _without_scales(a):
    """(artifact without weight scales, the scales)."""
    a = json.loads(json.dumps(a))
    scales = [l["scales"].pop("w_log_scales") for l in a["layers"]]
    return a, scales


def test_emit_static_mapping_matches_jax(artifacts):
    (ja, jscales), (ta, tscales) = map(_without_scales, artifacts)
    assert len(ta["layers"]) == len(ja["layers"]) == 15
    np.testing.assert_allclose(tscales, jscales, rtol=0, atol=1e-6)
    assert ta == ja
    kinds = {l["name"]: l["counts"] for l in ja["layers"]}
    assert kinds["units/0/attn/wk@1"] == [7, 57]
    assert kinds["head"] == [128, 0]


@pytest.mark.parametrize("key,wk_counts", [("gpu_tc_like", [43, 21]),
                                           ("ternary", [0, 64])])
def test_emit_new_mappings_match_jax(mappings, key, wk_counts):
    """Artifacts of gpu_tc_like and of the ternary-biased diana equal the
    JAX package's, JSON for JSON, weight scales within 1e-6."""
    (ja, jscales), (ta, tscales) = map(_without_scales, mappings[key])
    np.testing.assert_allclose(tscales, jscales, rtol=0, atol=1e-6)
    assert ta == ja
    counts = {l["name"]: l["counts"] for l in ta["layers"]}
    assert counts["units/0/attn/wk@1"] == wk_counts
    assert counts["head"] == [128, 0]


def test_emit_bias_rejects_unknown_domain_and_fraction(model, tmp_path):
    jcfg, jparams, cfg, params = model
    with pytest.raises(ValueError, match="not on platform"):
        emit_static_mapping(params, cfg, "gpu_tc_like", tmp_path / "a.json",
                            bias=("aimc", 1.0))
    for frac in (-0.1, 1.5):
        with pytest.raises(ValueError, match=r"\[0, 1\]"):
            emit_static_mapping(params, cfg, "diana", tmp_path / "b.json",
                                bias=("aimc", frac))


@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("dom", ["digital", "aimc"])
def test_emit_bias_splits_like_jax(model, tmp_path, dom, frac):
    jcfg, jparams, cfg, params = model
    ja = j_emit(jparams, jcfg, "diana", tmp_path / "j.json",
                max_cout=MAX_COUT, bias=(dom, frac))
    ta = emit_static_mapping(params, cfg, "diana", tmp_path / "t.json",
                             max_cout=MAX_COUT, bias=(dom, frac))
    assert [l["assignment"] for l in ta.to_dict()["layers"]] == \
        [l["assignment"] for l in ja.to_dict()["layers"]]


@pytest.mark.parametrize("tuning", [None, BN16], ids=["bn128", "bn16"])
@pytest.mark.parametrize("key,hist", [
    ("gpu_tc_like", {"quant_matmul": 5, "split_precision": 10}),
    ("ternary", {"quant_matmul": 5, "ternary_matmul": 10})])
def test_lower_new_mappings_identical_plan_json(model, mappings, key, hist,
                                                tuning):
    jcfg, jparams, cfg, params = model
    ja, _ = mappings[key]
    jplan = jrt.lower(ja, params=jparams, tuning=tuning)
    plan = rt.lower(ja, params=params, tuning=tuning)
    assert plan.to_json() == jplan.to_json()
    assert plan.kernel_histogram() == hist
    if key == "gpu_tc_like":
        want = [128, 128] if tuning is None else [48, 64]
        assert plan["units/0/attn/wk@0"].aligned_boundaries == want


def test_lower_gives_identical_plan_json(model, artifacts, tmp_path):
    jcfg, jparams, cfg, params = model
    ja, _ = artifacts
    jplan = jrt.lower(ja, params=jparams)
    plan = rt.lower(ja, params=params)
    assert plan.to_json() == jplan.to_json()
    assert plan.kernel_histogram() == {"quant_matmul": 5,
                                       "split_ternary": 10}
    # plan JSON written by the JAX package loads unchanged
    jplan.save(tmp_path / "plan.json")
    assert ExecutionPlan.load(tmp_path / "plan.json").to_json() == \
        jplan.to_json()


def test_v1_artifact_lowers_like_jax(model, artifacts):
    """A v1 artifact (no scales) lowers with max-abs weight scales in both
    packages: identical plans, scales within float32 log rounding."""
    jcfg, jparams, cfg, params = model
    doc = json.loads(json.dumps(artifacts[0]))
    doc["schema_version"] = 1
    for layer in doc["layers"]:
        layer.pop("scales")
    jd = jrt.lower(doc, params=jparams).to_dict()
    td = rt.lower(doc, params=params).to_dict()
    for jl, tl in zip(jd["layers"], td["layers"]):
        assert tl["act_log_scale"] is None
        np.testing.assert_allclose(tl.pop("w_log_scales"),
                                   jl.pop("w_log_scales"), atol=1e-6)
    assert td == jd


@pytest.mark.parametrize("layer", ["units/0/ffn/gate@1",   # quant_matmul
                                   "units/0/attn/wq@0"])   # split_ternary
@pytest.mark.parametrize("reference", [False, True])
@pytest.mark.parametrize("static_act", [True, False])
def test_execute_layer_bit_identical_to_jax(model, artifacts, layer,
                                            reference, static_act):
    jcfg, jparams, cfg, params = model
    doc = json.loads(json.dumps(artifacts[0]))
    if not static_act:
        for l in doc["layers"]:
            l["scales"]["act_log_scale"] = None
    jlp, lp = jrt.lower(doc, params=jparams)[layer], \
        rt.lower(doc, params=params)[layer]
    base, r = layer.split("@")
    node_j = jparams["units"][0]
    node_t = params["units"][0]
    for part in base.split("/")[2:]:
        node_j, node_t = node_j[part], node_t[part]
    bits = [8, 2]
    jprep = jrt.prepare_layer(jlp, node_j["w"][int(r)], domain_bits=bits)
    prep = rt.prepare_layer(lp, node_t["w"][int(r)], domain_bits=bits)
    x = np.random.default_rng(3).normal(0, 2.5, (2, 3, lp.c_in))
    x = x.astype(np.float32)
    want = np.asarray(jrt.execute_layer(jprep, jnp.asarray(x),
                                        reference=reference))
    got = rt.execute_layer(prep, torch.from_numpy(x), reference=reference)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _prepared_pair(model, doc, layer, bits, tuning=None):
    """(JAX prepared layer, port prepared layer, port LayerPlan) of
    ``layer`` (a stacked ``name@r``) of the lowered ``doc``."""
    jcfg, jparams, cfg, params = model
    jlp = jrt.lower(doc, params=jparams, tuning=tuning)[layer]
    lp = rt.lower(doc, params=params, tuning=tuning)[layer]
    base, r = layer.split("@")
    node_j, node_t = jparams["units"][0], params["units"][0]
    for part in base.split("/")[2:]:
        node_j, node_t = node_j[part], node_t[part]
    jprep = jrt.prepare_layer(jlp, node_j["w"][int(r)], domain_bits=bits)
    prep = rt.prepare_layer(lp, node_t["w"][int(r)], domain_bits=bits)
    return jprep, prep, lp


@pytest.mark.parametrize("reference", [False, True])
@pytest.mark.parametrize("static_act", [True, False])
def test_execute_ternary_layer_bit_identical_to_jax(model, mappings,
                                                    reference, static_act):
    doc = json.loads(json.dumps(mappings["ternary"][0]))
    if not static_act:
        for l in doc["layers"]:
            l["scales"]["act_log_scale"] = None
    jprep, prep, lp = _prepared_pair(model, doc, "units/0/attn/wv@1",
                                     [8, 2])
    assert lp.kernel == "ternary_matmul" and prep.w_perm is None
    x = np.random.default_rng(7).normal(0, 2.5, (2, 3, lp.c_in))
    x = x.astype(np.float32)
    want = np.asarray(jrt.execute_layer(jprep, jnp.asarray(x),
                                        reference=reference))
    got = rt.execute_layer(prep, torch.from_numpy(x), reference=reference)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("reference", [False, True])
@pytest.mark.parametrize("tuning", [None, BN16], ids=["bn128", "bn16"])
def test_execute_split_precision_layer_matches_jax(model, mappings,
                                                   reference, tuning):
    """Columns below the aligned boundary bit for bit, the bf16 columns
    (16 of 64 at bn=16, none at bn=128) within the float32 summation
    bound; the bf16 operand is the input rounded to bf16."""
    doc = mappings["gpu_tc_like"][0]
    jprep, prep, lp = _prepared_pair(model, doc, "units/0/attn/wk@0",
                                     [8, 16], tuning)
    assert lp.kernel == "split_precision" and prep.w_q is not None
    assert prep.w_bf16.dtype == torch.bfloat16
    x = np.random.default_rng(8).normal(0, 2.5, (2, 3, lp.c_in))
    x = x.astype(np.float32)
    want = np.asarray(jrt.execute_layer(jprep, jnp.asarray(x),
                                        reference=reference))
    got = rt.execute_layer(prep, torch.from_numpy(x), reference=reference)
    b_al = min(lp.aligned_boundaries[0], lp.c_out)
    assert b_al == (48 if tuning else 64)
    # planned (domain-contiguous) column order
    got_p = got.numpy().reshape(-1, lp.c_out)[:, lp.perm]
    want_p = want.reshape(-1, lp.c_out)[:, lp.perm]
    np.testing.assert_array_equal(got_p[:, :b_al], want_p[:, :b_al])
    xb = torch.from_numpy(x.reshape(-1, lp.c_in)).to(torch.bfloat16)
    bound = bf16_error_bound(xb, prep.w_bf16,
                             torch.from_numpy(np.array(want_p))).numpy()
    err = np.abs(got_p.astype(np.float64) - want_p)
    assert np.all(err[:, b_al:] <= bound[:, b_al:])


def test_backend_rejects_kernels_of_later_slices(model, artifacts):
    """Every plan kernel binds now; what waits is grouped (and conv)
    execution: a layer with ``groups > 1`` is refused at bind time."""
    jcfg, jparams, cfg, params = model
    plan = rt.lower(artifacts[0], params=params)
    plan["units/0/ffn/up@0"].groups = 2
    with pytest.raises(rt.ExecutionError, match="later slice"):
        rt.PlannedBackend(plan, params)


def test_prepare_layer_rejects_conv_weights(model, artifacts):
    jcfg, jparams, cfg, params = model
    lp = rt.lower(artifacts[0], params=params)["units/0/attn/wk@0"]
    w4 = torch.zeros((3, 3, lp.c_in, lp.c_out))
    with pytest.raises(rt.ExecutionError, match="later slice"):
        rt.prepare_layer(lp, w4)


def test_backend_rejects_repeat_count_mismatch(model, artifacts):
    jcfg, jparams, cfg, params = model
    doc = json.loads(json.dumps(artifacts[0]))
    doc["layers"] = [l for l in doc["layers"] if not l["name"].endswith("@1")]
    plan = rt.lower(doc, params=params)
    with pytest.raises(rt.ExecutionError, match="repeats"):
        rt.PlannedBackend(plan, params)


def test_quant_primitives_match_jax():
    from repro.core import quant as jquant
    from repro_torch.core import quant
    x = np.random.default_rng(5).normal(0, 1.5, (7, 33)).astype(np.float32)
    for bits in (2, 8):
        np.testing.assert_array_equal(
            quant.quantize_int(torch.from_numpy(x), 0.5, bits).numpy(),
            np.asarray(jquant.quantize_int(jnp.asarray(x), 0.5, bits)))
    np.testing.assert_allclose(
        float(quant.init_log_scale(torch.from_numpy(x))),
        float(jquant.init_log_scale(jnp.asarray(x))), atol=1e-6)
    assert quant.qlevels(2) == jquant.qlevels(2) == 1


def _serve_args(path, *extra):
    return ["--arch", "yi-9b", "--reduce", "--device", "cpu", "--requests",
            "1", "--prompt-len", "4", "--gen-len", "2", "--mapping",
            str(path), *extra]


def test_serve_exits_2_when_the_artifact_does_not_lower(artifacts,
                                                        tmp_path):
    from repro_torch.launch import serve
    doc = json.loads(json.dumps(artifacts[0]))
    doc["layers"][3]["assignment"] = doc["layers"][3]["assignment"][:-1]
    doc["layers"][3]["counts"][-1] -= 1
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    with pytest.raises(SystemExit) as exc:
        serve.main(_serve_args(bad))
    assert exc.value.code == 2


@pytest.mark.parametrize("key", sorted(MAPPINGS))
def test_serve_new_mappings_with_full_coverage(mappings, key, tmp_path):
    from repro_torch.launch import serve
    path = tmp_path / f"{key}.json"
    path.write_text(json.dumps(mappings[key][1]))
    tokens, stats = serve.main(_serve_args(path, "--require-full-coverage"))
    assert tuple(tokens.shape) == (1, 2)


def test_serve_planned_runs_with_full_coverage(artifacts, tmp_path):
    from repro_torch.launch import serve
    good = tmp_path / "good.json"
    good.write_text(json.dumps(artifacts[0]))
    tokens, stats = serve.main(_serve_args(good, "--require-full-coverage"))
    assert tuple(tokens.shape) == (1, 2)


@pytest.mark.parametrize("flag", [["--engine"], ["--kv-layout", "paged"],
                                  ["--check-spec-parity"]])
def test_serve_engine_flags_wait_for_slice_2(flag, artifacts, tmp_path):
    from repro_torch.launch import serve
    good = tmp_path / "good.json"
    good.write_text(json.dumps(artifacts[0]))
    with pytest.raises(NotImplementedError, match="slice 2"):
        serve.main(_serve_args(good, *flag))


def test_v1_plan_json_from_jax_loads(model, artifacts):
    """A plan document of schema v1 (no ``tuning``/``groups`` fields) loads
    in both packages to the same plan."""
    jcfg, jparams, cfg, params = model
    doc = jrt.lower(artifacts[0], params=jparams).to_dict()
    doc["schema_version"] = 1
    for layer in doc["layers"]:
        del layer["tuning"], layer["groups"]
    text = json.dumps(doc)
    want = jrt.ExecutionPlan.from_json(text)
    got = ExecutionPlan.from_json(text)
    assert got.schema_version == 1
    assert got.to_json() == want.to_json()


@pytest.mark.parametrize("key,layer,kernel,bits", [
    ("diana", "units/0/ffn/gate@1", "quant_matmul", [8, 2]),
    ("diana", "units/0/attn/wq@0", "split_ternary", [8, 2]),
    ("ternary", "units/0/attn/wv@1", "ternary_matmul", [8, 2]),
    ("gpu_tc_like", "units/0/attn/wk@0", "split_precision", [8, 16])])
def test_prepare_layer_lays_out_codes_per_kernel(model, artifacts, mappings,
                                                 key, layer, kernel, bits):
    """Every int8 kernel's layer holds its codes as the (K, N) transposed
    view of a contiguous (N, K) tensor, the layout the kernels read (one
    copy); split_precision's bf16 weight stays row-major.  Shape and values
    are the JAX package's."""
    doc = artifacts[0] if key == "diana" else mappings[key][0]
    tuning = BN16 if key == "gpu_tc_like" else None
    jprep, prep, lp = _prepared_pair(model, doc, layer, bits, tuning)
    assert lp.kernel == kernel
    k, n = lp.c_in, lp.c_out
    assert tuple(prep.w_q.shape) == (k, n) and prep.w_q.dtype == torch.int8
    assert prep.w_q.stride() == (1, k) and prep.w_q.t().is_contiguous()
    if kernel == "split_precision":
        assert prep.w_bf16.stride() == (n, 1)
    np.testing.assert_array_equal(prep.w_q.numpy(), np.asarray(jprep.w_q))


def _bind_planned(tmp_path, platform="diana", bias=None, tuning=None):
    """(plan, backend) of reduced yi-9b (float32 parameters, int8 KV cache)
    planned on ``platform``, after checking that the planned prefill
    logits equal the JAX package's within the 1e-4 that
    `test_torch_model.py` holds."""
    from repro.models.managed import matmul_backend
    from repro_torch.models import _backend
    jcfgbase.load_all()
    over = dict(param_dtype="float32", kv_cache_dtype="int8")
    jcfg = dataclasses.replace(
        jcfgbase.reduce_for_smoke(jcfgbase.get("yi-9b")), **over)
    cfg = dataclasses.replace(
        cfgbase.reduce_for_smoke(cfgbase.get("yi-9b")), **over)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    art = j_emit(jparams, jcfg, platform, tmp_path / "m.json",
                 max_cout=MAX_COUT, act_log_scale=2.0, bias=bias)
    plan = rt.lower(art.to_dict(), params=params, tuning=tuning)
    backend = rt.PlannedBackend(plan, params)
    jbackend = jrt.PlannedBackend(jrt.lower(art, params=jparams,
                                            tuning=tuning), jparams,
                                  reference=True)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, (2, 8),
                                                dtype=np.int32)
    jc = JT.init_cache(jcfg, 2, 9)
    tc = T.init_cache(cfg, 2, 9, device="cpu")
    with matmul_backend(jbackend), _backend.use(backend):
        jl, _ = JT.prefill(jparams, jcfg, jnp.asarray(prompts), jc)
        tl, _ = T.prefill(params, cfg, torch.from_numpy(prompts).long(), tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-4)
    return plan, backend


@pytest.fixture(scope="module")
def bound_diana(tmp_path_factory):
    """(plan, backend) of a bound diana plan of reduced yi-9b (float32
    parameters, int8 KV cache), its prefill logits checked against the
    JAX package's (`_bind_planned`)."""
    return _bind_planned(tmp_path_factory.mktemp("bound"))


def _bound_layers(bound, kernel):
    """The prepared layers of ``kernel`` (stacked or not) of `bound_diana`."""
    plan, backend = bound
    layers = [p for entry in backend._by_name.values()
              for p in (entry if isinstance(entry, list) else [entry])
              if p.plan.kernel == kernel]
    assert len(layers) == plan.kernel_histogram()[kernel] > 0
    return layers


def test_planned_backend_binds_quant_layers_k_major(bound_diana):
    """Every quant_matmul layer of a bound diana plan (stacked or not) is
    K-major, and the planned reduced yi-9b (float32 parameters, int8 KV
    cache) still gives the JAX package's prefill logits within the 1e-4
    that `test_torch_model.py` holds."""
    quant = _bound_layers(bound_diana, "quant_matmul")
    assert all(p.w_q.t().is_contiguous() for p in quant)


def test_planned_backend_binds_split_ternary_layers_k_major(bound_diana):
    """Every split_ternary layer of a bound diana plan holds its codes as
    the (K, N) transposed view of a contiguous (N, K) tensor (strides
    (1, K)) beside its row-major packed stream, and the planned prefill
    logits stay the JAX package's."""
    split = _bound_layers(bound_diana, "split_ternary")
    for p in split:
        k = p.plan.c_in
        assert p.w_q.stride() == (1, k) and p.w_q.t().is_contiguous()
        assert p.w_t_packed.is_contiguous()
        assert tuple(p.w_t_packed.shape) == (-(-k // 4), p.plan.c_out)


@pytest.mark.parametrize("key,kernel", [("gpu_tc_like", "split_precision"),
                                        ("ternary", "ternary_matmul")])
def test_planned_backend_binds_new_mappings_k_major(key, kernel, tmp_path):
    """Every split_precision layer of a bound gpu_tc_like plan (bn 16, so
    that bf16 columns exist) and every ternary_matmul layer of a bound
    diana_ternary plan holds its codes as the (K, N) transposed view of a
    contiguous (N, K) tensor (strides (1, K)), split_precision's bf16
    weight row-major, and the planned prefill logits stay the JAX
    package's."""
    plat, bias = MAPPINGS[key]
    bound = _bind_planned(tmp_path, plat, bias,
                          BN16 if key == "gpu_tc_like" else None)
    for p in _bound_layers(bound, kernel):
        k, n = p.plan.c_in, p.plan.c_out
        assert p.w_q.stride() == (1, k) and p.w_q.t().is_contiguous()
        if kernel == "split_precision":
            assert p.w_bf16.stride() == (n, 1)


@pytest.mark.parametrize("shape,strides,aligned,route", [
    ((64, 48), (1, 64), True, "k_major"),     # (N, K).t(), K % 16 == 0
    ((64, 48), (48, 1), True, "transpose"),   # row-major
    ((60, 48), (1, 60), True, "pad"),         # K-major, K % 16 != 0
    ((64, 48), (1, 64), False, "pad"),        # K-major, misaligned base
    ((64, 48), (1, 80), True, "transpose"),   # K-major rows with a gap
    ((64, 1), (1, 1), True, "k_major"),       # one column
    ((1, 48), (48, 1), True, "pad"),          # one K row is K-major
    ((32, 16), (16, 1), True, "transpose")])
def test_quant_matmul_weight_route_from_strides(shape, strides, aligned,
                                                route):
    from repro_torch.kernels.quant_matmul import weight_route
    assert weight_route(shape, strides, aligned) == route


def test_quant_matmul_k_major_copy_counts_transposes():
    """On CPU tensors: the K-major operand has the weight's values with K
    zero-padded to 16; a row-major weight counts one transposed copy, the
    prepared K-major layout none and is not copied."""
    from repro_torch.kernels import quant_matmul as qm
    rng = np.random.default_rng(11)
    w = torch.from_numpy(rng.integers(-127, 128, (40, 24), dtype=np.int8))
    before = qm.quant_matmul.transposed_copies
    row = qm._k_major(w)
    assert qm.quant_matmul.transposed_copies == before + 1
    assert tuple(row.shape) == (24, 48) and row.is_contiguous()
    np.testing.assert_array_equal(row[:, :40].numpy(), w.t().numpy())
    assert not row[:, 40:].any()
    w48 = torch.from_numpy(rng.integers(-127, 128, (48, 24), dtype=np.int8))
    col = w48.t().contiguous().t()
    got = qm._k_major(col)
    assert qm.quant_matmul.transposed_copies == before + 1
    assert got.data_ptr() == col.data_ptr() and got.is_contiguous()
    assert tuple(got.shape) == (24, 48)


@pytest.mark.parametrize("shape,strides,m,aligned,route", [
    ((64, 512), (1, 64), 512, True, "k_major"),    # prepared, N % 16 == 0
    ((64, 512), (512, 1), 512, True, "transpose"),  # row-major
    ((64, 130), (1, 64), 4, False, "pad"),         # misaligned base
    ((64, 132), (1, 64), 4, True, "k_major"),      # decode: N % 4 == 0
    ((64, 132), (1, 64), 17, True, "pad"),         # wgmma: N % 16 != 0
    ((60, 512), (1, 60), 512, True, "pad"),        # K % 16 != 0
    ((64, 512), (1, 80), 300, True, "transpose"),  # rows with a gap
    ((64, 1), (1, 1), 16, True, "pad")])           # one column, N % 4
def test_split_ternary_weight_route_from_strides(shape, strides, m, aligned,
                                                 route):
    from repro_torch.kernels.split_ternary import weight_route
    assert weight_route(shape, strides, m, aligned) == route


@pytest.mark.parametrize("m", [4, 300])
def test_split_ternary_kernel_operands_count_weight_copies(m):
    """On CPU tensors: the prepared layout (K-major codes, N % 16 == 0)
    reaches the kernel uncopied; a row-major w_q counts one copy; at N off
    the alignment of M (16 for the wgmma GEMM, 4 at decode) both streams
    are padded with zeros, one count each."""
    from repro_torch.kernels import split_ternary as st
    from repro_torch.kernels.ternary_packed import pack_ternary
    rng = np.random.default_rng(m)
    k = 40

    def ops_for(n):
        w = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
        w_p = pack_ternary(torch.from_numpy(
            rng.integers(-1, 2, (k, n), dtype=np.int8)))
        x = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
        return x, w, w_p, torch.ones(n)

    x, w, w_p, sw = ops_for(64)
    col = w.t().contiguous().t()
    before = st.split_ternary.transposed_copies
    xq, wk, wp, swp = st.kernel_operands(x, col, w_p, sw)
    assert st.split_ternary.transposed_copies == before + 1   # K 40 -> 48
    assert tuple(xq.shape) == (m, 48) and tuple(wk.shape) == (64, 48)
    assert wp.data_ptr() == w_p.data_ptr() and swp.data_ptr() == \
        sw.data_ptr()
    np.testing.assert_array_equal(wk[:, :k].numpy(), w.t().numpy())
    assert not wk[:, k:].any() and not xq[:, k:].any()
    x, w, w_p, sw = ops_for(48)
    w48 = torch.from_numpy(rng.integers(-127, 128, (48, 48), dtype=np.int8))
    x48 = torch.from_numpy(rng.integers(-127, 128, (m, 48), dtype=np.int8))
    before = st.split_ternary.transposed_copies
    got = st.kernel_operands(x48, w48.t().contiguous().t(),
                             pack_ternary(w48.clamp(-1, 1)), sw)[1]
    assert st.split_ternary.transposed_copies == before
    st.kernel_operands(x48, w48, pack_ternary(w48.clamp(-1, 1)), sw)
    assert st.split_ternary.transposed_copies == before + 1   # row-major
    assert got.is_contiguous() and tuple(got.shape) == (48, 48)
    x, w, w_p, sw = ops_for(12)
    before = st.split_ternary.transposed_copies
    xq, wk, wp, swp = st.kernel_operands(x, w, w_p, sw)
    n_pad = 16 if m > 16 else 12
    assert st.split_ternary.transposed_copies == before + 1 + (m > 16)
    assert tuple(wk.shape) == (n_pad, 48) and tuple(wp.shape) == (10, n_pad)
    assert tuple(swp.shape) == (n_pad,) and not swp[12:].any()
    np.testing.assert_array_equal(wp[:, :12].numpy(), w_p.numpy())


def test_quant_matmul_k_major_copy_counts_pads():
    """A K-major weight whose K is off the multiple of 16 is copied
    zero-padded, and that copy is counted as a transposed one is."""
    from repro_torch.kernels import quant_matmul as qm
    rng = np.random.default_rng(12)
    w = torch.from_numpy(rng.integers(-127, 128, (24, 40), dtype=np.int8))
    col = w.t()                           # (K 40, N 24), K-major
    before = qm.quant_matmul.transposed_copies
    got = qm._k_major(col)
    assert qm.quant_matmul.transposed_copies == before + 1
    assert tuple(got.shape) == (24, 48) and got.is_contiguous()
    np.testing.assert_array_equal(got[:, :40].numpy(), w.numpy())
    assert not got[:, 40:].any()


@pytest.mark.parametrize("shape,strides,aligned,route", [
    ((64, 512), (1, 64), True, "k_major"),    # prepared layout
    ((64, 512), (512, 1), True, "transpose"),  # row-major
    ((60, 512), (1, 60), True, "pad"),         # K % 16 != 0
    ((64, 130), (1, 64), True, "k_major"),     # any N
    ((64, 512), (1, 64), False, "pad"),        # misaligned base
    ((64, 512), (1, 80), True, "transpose")])  # rows with a gap
def test_ternary_matmul_weight_route_from_strides(shape, strides, aligned,
                                                  route):
    from repro_torch.kernels.ternary_matmul import weight_route
    assert weight_route(shape, strides, aligned) == route


@pytest.mark.parametrize("shape,strides,m,aligned,route", [
    ((64, 512), (1, 64), 4, True, "k_major"),      # prepared, decode
    ((64, 512), (1, 64), 512, True, "k_major"),    # prepared, wgmma
    ((64, 512), (512, 1), 4, True, "transpose"),   # row-major
    ((64, 132), (1, 64), 4, True, "k_major"),      # decode: N % 4 == 0
    ((64, 132), (1, 64), 17, True, "pad"),         # wgmma: N % 16 != 0
    ((64, 130), (1, 64), 16, True, "pad"),         # decode: N % 4 != 0
    ((40, 512), (1, 40), 300, True, "pad"),        # K % 16 != 0
    ((64, 512), (1, 64), 8, False, "pad")])        # misaligned base
def test_split_precision_weight_route_from_strides(shape, strides, m,
                                                   aligned, route):
    from repro_torch.kernels.split_precision import weight_route
    assert weight_route(shape, strides, m, aligned) == route


def test_ternary_matmul_kernel_operands_count_weight_copies():
    """On CPU tensors: the prepared K-major codes reach the kernel
    uncopied; a row-major weight, or a K-major one with K off 16, counts
    one copy, zero-padded in K, with the weight's values."""
    from repro_torch.kernels import ternary_matmul as tm
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.integers(-127, 128, (3, 48), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-1, 2, (48, 20), dtype=np.int8))
    before = tm.ternary_matmul.transposed_copies
    col = w.t().contiguous().t()
    xq, wk = tm.kernel_operands(x, col)
    assert tm.ternary_matmul.transposed_copies == before
    assert wk.data_ptr() == col.data_ptr() and tuple(wk.shape) == (20, 48)
    xq, wk = tm.kernel_operands(x, w)
    assert tm.ternary_matmul.transposed_copies == before + 1
    np.testing.assert_array_equal(wk.numpy(), w.t().numpy())
    x40, w40 = x[:, :40], w[:40].t().contiguous().t()
    xq, wk = tm.kernel_operands(x40, w40)
    assert tm.ternary_matmul.transposed_copies == before + 2
    assert tuple(xq.shape) == (3, 48) and tuple(wk.shape) == (20, 48)
    assert not wk[:, 40:].any() and not xq[:, 40:].any()


@pytest.mark.parametrize("m", [4, 20])
def test_split_precision_kernel_operands_count_weight_copies(m):
    """On CPU tensors: the prepared layout (K-major codes, contiguous bf16
    weight, K % 16 == 0, N on the alignment of M) reaches the kernel
    uncopied; a row-major w_q counts one copy; at N off the alignment (16
    for the wgmma GEMM at M 20, 4 for the decode GEMM at M 4) and K off 16
    both weights are copied zero-padded, one count each."""
    from repro_torch.kernels import split_precision as sp
    rng = np.random.default_rng(m)

    def ops_for(k, n):
        w = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
        wb = torch.from_numpy(rng.normal(0, 0.05, (k, n)).astype(
            np.float32)).to(torch.bfloat16)
        x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(
            np.float32)).to(torch.bfloat16)
        xq = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
        return x, xq, wb, w, torch.ones(n)

    x, xq, wb, w, sw = ops_for(48, 64)
    col = w.t().contiguous().t()
    before = sp.split_precision.transposed_copies
    xb_, xq_, wb_, wk_, sw_ = sp.kernel_operands(x, xq, wb, col, sw)
    assert sp.split_precision.transposed_copies == before
    assert wk_.data_ptr() == col.data_ptr() and wb_.data_ptr() == \
        wb.data_ptr()
    sp.kernel_operands(x, xq, wb, w, sw)
    assert sp.split_precision.transposed_copies == before + 1
    x, xq, wb, w, sw = ops_for(40, 12)
    before = sp.split_precision.transposed_copies
    xb_, xq_, wb_, wk_, sw_ = sp.kernel_operands(x, xq, wb,
                                                 w.t().contiguous().t(), sw)
    n_pad = 16 if m > 16 else 12
    assert sp.split_precision.transposed_copies == before + 1 + 1
    assert tuple(wk_.shape) == (n_pad, 48) and tuple(wb_.shape) == (48, n_pad)
    assert tuple(xb_.shape) == (m, 48) and tuple(xq_.shape) == (m, 48)
    assert tuple(sw_.shape) == (n_pad,) and not sw_[12:].any()
    np.testing.assert_array_equal(wk_[:12, :40].numpy(), w.t().numpy())
    np.testing.assert_array_equal(wb_[:40, :12].float().numpy(),
                                  wb.float().numpy())
    assert not wk_[:, 40:].any() and not wb_[40:].float().any()
