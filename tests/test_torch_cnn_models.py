"""The paper's CNNs in the port against the JAX package: ResNet20 and
MobileNetV1-0.25x (reduced, and at full width for the emission) with JAX's
parameters carried across through numpy: emitted artifacts (plan hints,
depthwise groups), lowered plans, and the forwards, fp and planned on
``diana`` and ``gpu_tc_like`` (the JAX package's planned backend on its
interpreted kernels) within 1e-4."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro.launch.train import emit_static_mapping as j_emit  # noqa: E402
from repro.models import cnn as JC  # noqa: E402
from repro.models import managed as jmg  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch.launch.train import emit_static_mapping  # noqa: E402
from repro_torch.models import cnn as C  # noqa: E402
from repro_torch.models import managed as mg  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

MODELS = ("resnet20_tiny", "mobilenetv1_tiny")
PLATFORMS = ("diana", "gpu_tc_like")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _same_layer_plan(tl: dict, jl: dict):
    """Two plan layers' JSON equal, their weight log-scales within 1e-6
    (the two packages' max-abs rounds differently in the last bit)."""
    key = "w_log_scales"
    assert {k: v for k, v in tl.items() if k != key} == \
        {k: v for k, v in jl.items() if k != key}
    np.testing.assert_allclose(tl[key], jl[key], rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def models():
    """{name: (JAX cfg, JAX params, port cfg, port params)}, the port's
    params carried across from JAX's."""
    out = {}
    for name in MODELS:
        jcfg, cfg = JC.get_config(name), C.get_config(name)
        jparams = JC.get_model(jcfg)[0](jax.random.PRNGKey(0), jcfg, None)
        params = T.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
        out[name] = (jcfg, jparams, cfg, params)
    return out


@pytest.fixture(scope="module")
def artifacts(models, tmp_path_factory):
    """{(model, platform): (JAX artifact, port artifact)}, emitted with the
    models' plan hints."""
    d = tmp_path_factory.mktemp("cnn_art")
    out = {}
    for name, (jcfg, jparams, cfg, params) in models.items():
        hints = {n: (g, s) for n, g, s in JC.get_model(jcfg)[2](jcfg)}
        for plat in PLATFORMS:
            out[name, plat] = (
                j_emit(jparams, jcfg, plat, d / f"j_{name}_{plat}.json",
                       plan_hints=hints),
                emit_static_mapping(params, cfg, plat,
                                    d / f"t_{name}_{plat}.json",
                                    plan_hints=C.plan_hints(cfg)))
    return out


def _same_artifact(ja, ta):
    """Names, counts, assignments, groups, searchable flags equal; scales
    within 1e-6."""
    jd, td = ja.to_dict(), ta.to_dict()
    assert [l["name"] for l in td["layers"]] == \
        [l["name"] for l in jd["layers"]]
    for jl, tl in zip(jd["layers"], td["layers"]):
        for key in ("assignment", "counts", "searchable"):
            assert tl[key] == jl[key], (tl["name"], key)
        assert tl.get("groups", 1) == jl.get("groups", 1)
        np.testing.assert_allclose(tl["scales"]["w_log_scales"],
                                   jl["scales"]["w_log_scales"], rtol=0,
                                   atol=1e-6)


#: the kernel histograms of the JAX lowering of the tiny configs
TINY_HIST = {("resnet20_tiny", "diana"): {"ternary_matmul": 19,
                                          "split_ternary": 3},
             ("resnet20_tiny", "gpu_tc_like"): {"split_precision": 22},
             ("mobilenetv1_tiny", "diana"): {"quant_matmul": 15,
                                             "split_ternary": 12,
                                             "ternary_matmul": 1},
             ("mobilenetv1_tiny", "gpu_tc_like"): {"quant_matmul": 14,
                                                   "split_precision": 14}}


@pytest.mark.parametrize("platform", PLATFORMS)
@pytest.mark.parametrize("name", MODELS)
def test_cnn_artifacts_and_plans_match_jax(models, artifacts, name,
                                           platform):
    """Emitted artifacts equal JAX's (depthwise layers emitted with their
    groups and pinned), and lower to the same plan JSON."""
    jcfg, jparams, cfg, params = models[name]
    ja, ta = artifacts[name, platform]
    _same_artifact(ja, ta)
    dw = [l for l in ta.layers if l.get("groups", 1) > 1]
    assert len(dw) == (13 if name.startswith("mobilenet") else 0)
    assert not any(l["searchable"] for l in dw)
    jplan = jrt.lower(ja, params=jparams)
    plan = rt.lower(ta.to_dict(), params=params)
    assert plan.kernel_histogram() == jplan.kernel_histogram() == \
        TINY_HIST[name, platform]
    for jl, tl in zip(json.loads(jplan.to_json())["layers"],
                      json.loads(plan.to_json())["layers"]):
        _same_layer_plan(tl, jl)


@pytest.mark.parametrize("name", ["resnet20", "mobilenetv1_025"])
def test_full_width_cnn_artifacts_match_jax(name, tmp_path):
    """At full width on diana too (params carried across): the artifact
    equals JAX's, and its histogram is the JAX lowering's."""
    jcfg, cfg = JC.get_config(name), C.get_config(name)
    jparams = JC.get_model(jcfg)[0](jax.random.PRNGKey(0), jcfg, None)
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    hints = {n: (g, s) for n, g, s in JC.get_model(jcfg)[2](jcfg)}
    ja = j_emit(jparams, jcfg, "diana", tmp_path / "j.json",
                plan_hints=hints)
    ta = emit_static_mapping(params, cfg, "diana", tmp_path / "t.json",
                             plan_hints=C.plan_hints(cfg))
    _same_artifact(ja, ta)
    hist = rt.lower(ta.to_dict(), params=params).kernel_histogram()
    assert hist == {"resnet20": {"ternary_matmul": 19, "split_ternary": 3},
                    "mobilenetv1_025": {"quant_matmul": 15,
                                        "ternary_matmul": 5,
                                        "split_ternary": 8}}[name]


def _forwards(models, artifacts, name, mapping):
    """(JAX logits, port logits, port backend) of ``name`` on the same
    images: fp, or planned on ``mapping`` (JAX: interpreted kernels)."""
    jcfg, jparams, cfg, params = models[name]
    x = np.random.default_rng(8).normal(
        size=(2, *cfg.img_hw, cfg.in_ch)).astype(np.float32)
    japply, tapply = JC.get_model(jcfg)[1], C.get_model(cfg)[1]
    jbackend = backend = None
    if mapping != "fp":
        ja, ta = artifacts[name, mapping]
        jbackend = jrt.PlannedBackend(jrt.lower(ja, params=jparams), jparams,
                                      interpret=True)
        backend = rt.PlannedBackend(rt.lower(ta.to_dict(), params=params),
                                    params)
        assert not backend.unbound
    fwd = jax.jit(lambda p, xb: japply(p, xb, jcfg, None, "fp", 1.0))
    with jmg.matmul_backend(jbackend):
        want = np.asarray(fwd(jparams, jnp.asarray(x)))
    with mg.matmul_backend(backend):
        got = tapply(params, _t(x), cfg).numpy()
    return want, got, backend


@pytest.mark.parametrize("mapping", ("fp",) + PLATFORMS)
@pytest.mark.parametrize("name", MODELS)
def test_cnn_forward_matches_jax(models, artifacts, name, mapping):
    """Logits within 1e-4 of JAX's (float32), fp and planned; the planned
    run declines nothing, and its plain-version run (``reference=True``)
    gives the same logits."""
    want, got, backend = _forwards(models, artifacts, name, mapping)
    assert got.shape == (2, models[name][2].n_classes)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if backend is not None:
        assert not backend.runtime_declines
        backend.reference = True
        jcfg, jparams, cfg, params = models[name]
        x = np.random.default_rng(8).normal(
            size=(2, *cfg.img_hw, cfg.in_ch)).astype(np.float32)
        with mg.matmul_backend(backend):
            ref = C.get_model(cfg)[1](params, _t(x), cfg).numpy()
        np.testing.assert_allclose(ref, got, rtol=0, atol=1e-5)


def test_managed_layer_dicts_follow_the_plan(models):
    jcfg, jparams, cfg, params = models["mobilenetv1_tiny"]
    dicts = C.managed_layer_dicts(params, cfg)
    jdicts = JC.managed_layer_dicts(jparams, jcfg)
    assert [tuple(d["w"].shape) for d in dicts] == \
        [tuple(d["w"].shape) for d in jdicts]
    assert [(n, s) for n, _, s in C.get_model(cfg)[2](cfg)] == \
        [(n, s) for n, _, s in JC.get_model(jcfg)[2](jcfg)]
    with pytest.raises(ValueError, match="unknown CNN config"):
        C.get_config("vgg")
