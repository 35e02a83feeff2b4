"""The paper's deployment and experiments on the port against the JAX
package, on the CPU:

* `ops.odimo_deployed_dense` against JAX's (its Pallas kernel in interpret
  mode) on the same numpy x, w, assignment and log-scales: the columns the
  aligned boundary runs int8 bit for bit, the bf16 ones within
  `bf16_error_bound`, at N <= 128 (every column int8 after alignment) and
  N > 128, all-int8, all-bf16 and random assignments, boundaries off the
  128-column block and a sort with many ties.  The int8 steps are
  ``exp(log_scale) / 127`` in float32, which XLA and torch round apart in
  the last bit for ~10 % of arguments (ROADMAP Queue 3); the bit-for-bit
  cases take the numpy log-scale nudged by ulps to one both round alike
  (`_shared_log_scale`), and `test_deploy_where_the_steps_part` holds a
  log-scale where they part: codes identical, int8 columns within 4
  float32 ulps.
* the public members the port had lacked (`DianaCostModel.cycles_to_ms`
  / ``energy_uj``, `LayerGeometry.macs`, `Platform.unregister`,
  `PrecisionDomain.is_identity`, `PreparedLayer.kernel`) against JAX's.
* the experiments script (``examples/torch_paper_experiments.py``): each
  fixed baseline's counts, latency, energy and AIMC share against
  ``repro.core.baselines`` and JAX's cost models on resnet20_tiny,
  resnet20, mobilenetv1_025 (its pinned depthwise layers) and
  resnet18_small; `table1` rows against the rows computed here with JAX's
  `DianaCostModel`; the script end to end at 2 steps per stage (the
  presets patched) with ``--only fig4`` and ``--only crossplat``, its JSON
  holding JAX's record keys."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.api import platforms as jplatforms  # noqa: E402
from repro.core import baselines as jbl  # noqa: E402
from repro.core import cost_models as jcost  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import cnn as JC  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro.runtime.lower import select_kernel as j_select  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch.api import platforms  # noqa: E402
from repro_torch.core import cost_models, quant  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.split_precision import (  # noqa: E402
    bf16_error_bound, split_precision)
from repro_torch.runtime.lower import select_kernel  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

#: JAX's record keys, by kind (``benchmarks/paper_experiments.py``)
RECORD_KEYS = {
    "baseline": {"kind", "model", "name", "accuracy", "latency", "energy",
                 "aimc_ch", "wall_s"},
    "odimo": {"kind", "model", "objective", "lam", "accuracy", "latency",
              "energy", "aimc_ch", "counts", "wall_s"},
    "crossplat": {"kind", "model", "platform", "lam", "objective",
                  "accuracy", "latency", "energy", "domain_fractions",
                  "counts", "wall_s"},
    "table1": {"kind", "model", "objective", "lam", "acc", "lat_ms",
               "energy", "dig_util", "aimc_util", "aimc_ch"},
}
#: 2 steps per stage, one evaluation batch of 8
TINY_PRESET = dict(pretrain=2, search=2, finetune=2, batch=8, evalb=1)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def exps(monkeypatch):
    """``examples/torch_paper_experiments.py`` as a module, its presets
    restored after the test."""
    spec = importlib.util.spec_from_file_location(
        "torch_paper_experiments",
        ROOT / "examples" / "torch_paper_experiments.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "PRESETS", {k: dict(v) for k, v in
                                         mod.PRESETS.items()})
    return mod


# ------------------------------------------------------------ deploy op

def _steps_agree(log_scale) -> bool:
    ls = np.float32(log_scale)
    return np.float32(jnp.exp(jnp.float32(ls))) == \
        np.float32(torch.exp(torch.tensor(ls)).item())


def _shared_log_scale(a):
    """float32 log(max |a|), nudged up by ulps to the first value whose
    exp both packages round alike."""
    ls = np.float32(np.log(np.abs(a).max()))
    while not _steps_agree(ls):
        ls = np.nextafter(ls, np.float32(np.inf))
    return ls


def _assignment(n, kind, rng):
    if kind == "int8":
        return np.zeros(n, np.int64)
    if kind == "bf16":
        return np.ones(n, np.int64)
    if kind == "random":
        return (rng.random(n) < 0.5).astype(np.int64)
    # "ties": long runs of equal domains, so the sort's order of ties
    # decides most columns' places
    a = np.zeros(n, np.int64)
    a[rng.choice(n, n // 3, replace=False)] = 1
    return a


def _deploy_pair(x, w, assign, wls, xls):
    want = np.asarray(jops.odimo_deployed_dense(
        jnp.asarray(x), jnp.asarray(w), assign, jnp.float32(wls),
        jnp.float32(xls), interpret=True))
    before = split_precision.launches
    got = ops.odimo_deployed_dense(torch.from_numpy(x), torch.from_numpy(w),
                                   assign, torch.tensor(wls),
                                   torch.tensor(xls))
    assert split_precision.launches == before     # the plain version
    return got.numpy(), want


def _int8_columns(assign, n):
    """Original columns that the aligned boundary runs on the int8 path."""
    perm = np.argsort(assign, kind="stable")
    b_al = min(ops.align_boundary(int((assign == 0).sum()),
                                  ops.block_n(128, n)), n)
    return np.argsort(perm) < b_al


#: (M, K, N, assignment): N <= 128 (aligned to all int8), N > 128 with both
#: domains live (boundaries 144-ish, 172-ish: off the block), one domain
#: only, many ties
DEPLOY_CASES = [(4, 64, 10, "random"), (5, 96, 300, "random"),
                (16, 128, 384, "random"), (3, 40, 200, "int8"),
                (3, 40, 200, "bf16"), (2, 64, 257, "ties"),
                (1, 72, 130, "ties")]


@pytest.mark.parametrize("m,k,n,kind", DEPLOY_CASES)
def test_deploy_matches_jax(m, k, n, kind):
    rng = np.random.default_rng(m * 1000 + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    assign = _assignment(n, kind, rng)
    wls, xls = _shared_log_scale(w), _shared_log_scale(x)
    got, want = _deploy_pair(x, w, assign, wls, xls)
    assert got.shape == (m, n) and got.dtype == np.float32
    int8 = _int8_columns(assign, n)
    boundary = int((assign == 0).sum())
    if kind == "random" and n > 128:
        assert boundary % 128 and 0 < boundary < n and not int8.all()
    np.testing.assert_array_equal(got[:, int8], want[:, int8])
    bound = bf16_error_bound(torch.from_numpy(x).bfloat16(),
                             torch.from_numpy(w).bfloat16(),
                             torch.from_numpy(want.copy())).numpy()
    err = np.abs(got.astype(np.float64) - want)
    assert np.all(err[:, ~int8] <= bound[:, ~int8])
    if kind == "bf16":
        assert not int8.any()
    # the original column order: each column's own product
    ref = x.astype(np.float64) @ w.astype(np.float64)
    assert np.abs(got - ref).max() < 0.05 * np.abs(ref).max()


def test_deploy_where_the_steps_part():
    """A weight log-scale whose exp XLA and torch round apart: the codes
    are identical, the int8 columns within 4 float32 ulps (one step ulp,
    twice rounded)."""
    rng = np.random.default_rng(11)
    m, k, n = 3, 48, 200
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    assign = _assignment(n, "random", rng)
    wls = np.float32(np.log(np.abs(w).max()))
    while _steps_agree(wls):
        wls = np.nextafter(wls, np.float32(np.inf))
    xls = _shared_log_scale(x)
    got, want = _deploy_pair(x, w, assign, wls, xls)
    np.testing.assert_array_equal(
        quant.quantize_int(torch.from_numpy(w), torch.tensor(wls), 8).numpy(),
        np.asarray(jquant.quantize_int(jnp.asarray(w), jnp.float32(wls), 8)))
    int8 = _int8_columns(assign, n)
    np.testing.assert_allclose(got[:, int8], want[:, int8], rtol=2.0**-21,
                               atol=0)
    bound = bf16_error_bound(torch.from_numpy(x).bfloat16(),
                             torch.from_numpy(w).bfloat16(),
                             torch.from_numpy(want.copy())).numpy()
    err = np.abs(got.astype(np.float64) - want)
    assert np.all(err[:, ~int8] <= bound[:, ~int8])


def test_deploy_takes_a_tensor_assignment_and_keeps_order():
    """A torch assignment gives the numpy one's output; column c of the
    output depends only on column c of w."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 140)).astype(np.float32))
    a = _assignment(140, "random", rng)
    wls, xls = quant.init_log_scale(w), quant.init_log_scale(x)
    out = ops.odimo_deployed_dense(x, w, a, wls, xls)
    assert torch.equal(ops.odimo_deployed_dense(x, w, torch.from_numpy(a),
                                                wls, xls), out)
    w2 = w.clone()
    w2[:, 7] = 0.0
    out2 = ops.odimo_deployed_dense(x, w2, a, wls, xls)
    assert torch.equal(out2[:, 7], torch.zeros(4))
    assert torch.equal(torch.cat([out2[:, :7], out2[:, 8:]], 1),
                       torch.cat([out[:, :7], out[:, 8:]], 1))


# --------------------------------------------------------- class members

GEOMS = [cost_models.LayerGeometry(16, 32, 3, 3, 8, 8),
         cost_models.LayerGeometry(64, 10),
         cost_models.LayerGeometry(32, 32, 3, 3, 16, 16, groups=32)]


def _jgeom(g):
    return jcost.LayerGeometry(g.c_in, g.c_out, g.fx, g.fy, g.ox, g.oy,
                               g.groups)


@pytest.mark.parametrize("g", GEOMS, ids=lambda g: f"{g.c_in}x{g.c_out}")
def test_layer_geometry_macs_matches_jax(g):
    for c in (0, 1, 7.5, g.c_out):
        assert g.macs(c) == _jgeom(g).macs(c)


def test_diana_cycles_to_ms_and_energy_uj_match_jax():
    cm, jcm = cost_models.DianaCostModel(), jcost.DianaCostModel()
    cycles = [0.0, 1.0, 123457.0, 7.5e6, 3.3e9]
    np.testing.assert_array_equal(cm.cycles_to_ms(cycles).numpy(),
                                  np.asarray(jcm.cycles_to_ms(cycles)))
    assert float(cm.cycles_to_ms(123457.0)) == \
        float(jcm.cycles_to_ms(123457.0))
    for g in GEOMS:
        for counts in ([g.c_out, 0], [0, g.c_out], [g.c_out // 3,
                                                    g.c_out - g.c_out // 3]):
            c = np.asarray(counts, np.float32)
            lat = cm.latency(g, c)
            jlat = jcm.latency(_jgeom(g), jnp.asarray(c))
            np.testing.assert_array_equal(lat.numpy(), np.asarray(jlat))
            got = float(cm.energy_uj(lat, lat.max()))
            want = float(jcm.energy_uj(jlat, jnp.max(jlat)))
            np.testing.assert_allclose(got, want, rtol=1e-6)


def test_precision_domain_is_identity_matches_jax():
    for name in platforms.Platform.names():
        doms = platforms.Platform.get(name).domains
        jdoms = jplatforms.Platform.get(name).domains
        assert [d.is_identity for d in doms] == \
            [d.is_identity for d in jdoms]
    assert quant.TPU_BF16.is_identity and not quant.DIANA_AIMC.is_identity


def test_platform_unregister_matches_jax():
    for P in (platforms.Platform, jplatforms.Platform):
        base = P.get("diana")
        names = list(P.names())
        P.register(P(name="unregister_probe", domains=base.domains,
                     cost_model_factory=base.cost_model_factory))
        assert "unregister_probe" in P.names()
        P.unregister("unregister_probe")
        P.unregister("unregister_probe")     # unknown: a no-op
        assert list(P.names()) == names
    assert list(platforms.Platform.names()) == \
        list(jplatforms.Platform.names())


@pytest.mark.parametrize("bits,counts", [([8, 2], [24, 0]), ([8, 2], [0, 24]),
                                         ([8, 2], [10, 14]),
                                         ([8, 16], [10, 14]),
                                         ([16, 16], [24, 0])])
def test_prepared_layer_kernel_matches_jax(bits, counts):
    rng = np.random.default_rng(sum(counts) + bits[1])
    w = rng.standard_normal((16, 24)).astype(np.float32)
    assign = np.repeat(np.arange(2), counts)
    rng.shuffle(assign)
    perm = np.argsort(assign, kind="stable")
    bounds = list(np.cumsum(counts)[:-1])
    preps = []
    for select, runtime, wt in ((j_select, jrt, jnp.asarray(w)),
                                (select_kernel, rt, torch.from_numpy(w))):
        kernel = select(counts, bits)[0]
        lp = runtime.LayerPlan(
            name="probe", kernel=kernel, c_in=16, c_out=24, perm=perm,
            counts=list(counts), boundaries=bounds, aligned_boundaries=[
                min(ops.align_boundary(b, 128), 24) for b in bounds],
            w_log_scales=[float(np.log(np.abs(w).max()))] * 2,
            act_log_scale=2.0)
        preps.append(runtime.prepare_layer(lp, wt, domain_bits=bits))
    assert preps[1].kernel == preps[0].kernel == preps[1].plan.kernel


# ---------------------------------------------------- baselines, table1

def _jax_cost(platform, model, assigns):
    """(counts, latency, energy, aimc share) of a fixed mapping by the JAX
    package's cost model."""
    cfg = JC.get_config(model)
    geoms = [g for (_, g, _) in JC.get_model(cfg)[2](cfg)]
    cm = jplatforms.Platform.get(platform).cost_model()
    counts = jbl.counts_from_assignments(assigns, 2)
    lat = float(jlosses.exact_latency(cm, geoms, counts))
    en = float(jlosses.exact_energy(cm, geoms, counts))
    aimc = sum(int(c[1]) for c in counts) / sum(int(c.sum()) for c in counts)
    return counts, lat, en, aimc


def _jax_baselines(model):
    """JAX's five baselines of ``model`` on diana, pinned layers digital
    (the JAX script's rule)."""
    cfg = JC.get_config(model)
    plan = JC.get_model(cfg)[2](cfg)
    geoms = [g for (_, g, _) in plan]
    searchable = [s for (_, _, s) in plan]
    cm = jplatforms.Platform.get("diana").cost_model()
    defs = {"all_8bit": jbl.all_8bit(geoms),
            "all_ternary": jbl.all_ternary(geoms),
            "io8_backbone_ternary": jbl.io8_backbone_ternary(geoms),
            "min_cost_lat": jbl.min_cost(cm, geoms, "latency", searchable),
            "min_cost_en": jbl.min_cost(cm, geoms, "energy", searchable)}
    for assigns in defs.values():
        for li, s in enumerate(searchable):
            if not s:
                assigns[li][:] = 0
    return defs


@pytest.mark.parametrize("model", ["resnet20_tiny", "resnet20",
                                   "mobilenetv1_025", "resnet18_small"])
def test_baselines_match_jax_cost_models(exps, model):
    """`run_baselines` at no training step and one evaluation batch of 2
    images: every record's latency, energy and AIMC share equal JAX's
    cost model on JAX's baseline counts (rtol 1e-6), and the script's
    assignments equal JAX's."""
    exps.PRESETS["quick"].update(pretrain=0, finetune=0, batch=2, evalb=1)
    ours = exps.baseline_assignments(model, "diana")
    jax_defs = _jax_baselines(model)
    assert list(ours) == list(jax_defs) == list(exps.BASELINES)
    for name in ours:
        for a, ja in zip(ours[name], jax_defs[name]):
            np.testing.assert_array_equal(a, ja)
    recs = []
    exps.run_baselines(model, "quick", "diana", recs, device="cpu")
    assert [r["name"] for r in recs] == list(exps.BASELINES)
    for rec in recs:
        assert set(rec) == RECORD_KEYS["baseline"]
        counts, lat, en, aimc = _jax_cost("diana", model,
                                          jax_defs[rec["name"]])
        np.testing.assert_allclose(rec["latency"], lat, rtol=1e-6)
        np.testing.assert_allclose(rec["energy"], en, rtol=1e-6)
        np.testing.assert_allclose(rec["aimc_ch"], aimc, rtol=1e-6)
        if model == "mobilenetv1_025" and rec["name"] == "all_ternary":
            assert 0.0 < rec["aimc_ch"] < 1.0     # depthwise pinned


def test_table1_matches_jax_diana_cost_model(exps):
    """`table1` over fixed records (two models' searched-like counts, a
    baseline and a crossplat record it must skip) against the rows the
    JAX script's formula gives with JAX's `DianaCostModel`."""
    rng = np.random.default_rng(2)
    recs = [dict(kind="baseline", model="resnet20", name="all_8bit",
                 accuracy=0.5, latency=1.0, energy=1.0, aimc_ch=0.0,
                 wall_s=0.0),
            dict(kind="crossplat", model="resnet20", platform="diana",
                 lam=1e-7, objective="latency", accuracy=0.5, latency=1.0,
                 energy=1.0, domain_fractions={}, counts=[], wall_s=0.0)]
    for model, obj, lam in (("resnet20_tiny", "latency", 3e-7),
                            ("resnet20", "energy", 1e-6),
                            ("resnet20", "latency", 1e-5)):
        cfg = JC.get_config(model)
        geoms = [g for (_, g, _) in JC.get_model(cfg)[2](cfg)]
        counts = []
        for g in geoms:
            d = int(rng.integers(0, g.c_out + 1))
            counts.append([d, g.c_out - d])
        _, lat, en, aimc = _jax_cost("diana", model, [
            np.repeat([0, 1], c) for c in counts])
        recs.append(dict(kind="odimo_diana", model=model, objective=obj,
                         lam=lam, accuracy=float(rng.random()), latency=lat,
                         energy=en, aimc_ch=aimc, counts=counts, wall_s=0.0))
    out = [dict(r) for r in recs]
    exps.table1(out)
    rows = out[len(recs):]
    assert len(rows) == 3
    jcm = jcost.DianaCostModel()
    for r, row in zip(recs[2:], rows):
        assert set(row) == RECORD_KEYS["table1"]
        cfg = JC.get_config(r["model"])
        geoms = [g for (_, g, _) in JC.get_model(cfg)[2](cfg)]
        dig = aimc = tot = 0.0
        for g, c in zip(geoms, r["counts"]):
            lat = jcm.latency(g, np.asarray(c, np.float32))
            dig += float(lat[0])
            aimc += float(lat[1])
            tot += float(max(lat))
        want = dict(kind="table1", model=r["model"], objective=r["objective"],
                    lam=r["lam"], acc=r["accuracy"],
                    lat_ms=float(jcm.cycles_to_ms(r["latency"])),
                    energy=r["energy"], dig_util=dig / max(tot, 1e-9),
                    aimc_util=aimc / max(tot, 1e-9), aimc_ch=r["aimc_ch"])
        for key, v in want.items():
            if isinstance(v, float):
                np.testing.assert_allclose(row[key], v, rtol=1e-6)
            else:
                assert row[key] == v
        assert row["dig_util"] + row["aimc_util"] >= 1.0


# --------------------------------------------------- the script end to end

@pytest.mark.parametrize("only", ["fig4", "crossplat", "table1,crossplat"])
def test_experiments_end_to_end(exps, tmp_path, only):
    """``table1,crossplat``: a list of parts; Table I without the same
    call's fig4 records has no row."""
    exps.PRESETS["quick"].update(TINY_PRESET)
    results = exps.main(["--preset", "quick", "--device", "cpu", "--only",
                           only, "--out", str(tmp_path)])
    doc = json.loads((tmp_path / "results_quick.json").read_text())
    assert doc == json.loads(json.dumps(results))
    stages = json.loads((tmp_path / "stages_quick.json").read_text())
    assert len(stages) == len(doc)
    kinds = [r["kind"] for r in doc]
    if only == "fig4":
        assert kinds == ["baseline"] * 5 + ["odimo_diana"] * 6
        for s in stages[5:]:
            assert {"pretrain", "search", "finetune", "evaluate"} <= \
                set(s["stages"])
            assert s["stages"]["search"]["steps"] == 2
    else:
        assert kinds == ["crossplat"] * 4
        assert [r["platform"] for r in doc] == ["diana", "gap9_like",
                                                "tpu_v5e", "gpu_tc_like"]
        assert len(doc[1]["domain_fractions"]) == 3
        for r in doc:
            np.testing.assert_allclose(sum(r["domain_fractions"].values()),
                                       1.0, rtol=1e-9)
    for r in doc:
        key = "odimo" if r["kind"].startswith("odimo") else r["kind"]
        assert set(r) == RECORD_KEYS[key]
        assert np.isfinite(r["latency"]) and r["latency"] > 0
        assert 0.0 <= r["accuracy"] <= 1.0


def test_experiments_refuses_an_unknown_part(exps, capsys):
    with pytest.raises(SystemExit) as e:
        exps.main(["--only", "fig4,fig6", "--device", "cpu"])
    assert e.value.code == 2 and "fig6" in capsys.readouterr().err


def test_experiments_refuses_cuda_without_a_card(exps, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        exps.main(["--preset", "quick"])
    assert e.value.code != 0
    assert "--device cpu" in capsys.readouterr().err
