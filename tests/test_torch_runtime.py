"""The port's mapping pipeline against the JAX package: min-cost split,
artifact emission, lowering (plan JSON) and planned layer execution, on a
reduced yi-9b whose parameters are the JAX package's, imported through
numpy."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcfgbase  # noqa: E402
from repro.core import baselines as jbaselines  # noqa: E402
from repro.core import cost_models as jcost  # noqa: E402
from repro.launch.train import emit_static_mapping as j_emit  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.core import baselines, cost_models  # noqa: E402
from repro_torch.launch.train import emit_static_mapping  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch.runtime.plan import ExecutionPlan  # noqa: E402

MAX_COUT = 64   # layers wider than this pin to int8: both kernels appear


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


def test_emit_static_mapping_matches_jax(artifacts):
    ja, ta = json.loads(json.dumps(artifacts))
    for a in (ja, ta):
        for layer in a["layers"]:
            layer["w_scales"] = layer["scales"].pop("w_log_scales")
    assert len(ta["layers"]) == len(ja["layers"]) == 15
    np.testing.assert_allclose(
        [l["w_scales"] for l in ta["layers"]],
        [l["w_scales"] for l in ja["layers"]], rtol=0, atol=1e-6)
    for a in (ja, ta):
        for layer in a["layers"]:
            del layer["w_scales"]
    assert ta == ja
    kinds = {l["name"]: l["counts"] for l in ja["layers"]}
    assert kinds["units/0/attn/wk@1"] == [7, 57]
    assert kinds["head"] == [128, 0]


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


def test_backend_rejects_kernels_of_later_slices(model, artifacts):
    jcfg, jparams, cfg, params = model
    plan = rt.lower(artifacts[0], params=params)
    lp = plan["units/0/ffn/up@0"]
    lp.kernel = "ternary_matmul"
    with pytest.raises(rt.ExecutionError, match="later slice"):
        rt.PlannedBackend(plan, params)


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
