"""`SearchPipeline` in the port against the JAX package, on JAX's init
and JAX's batches (the two packages' random streams differ), with the
JAX package's TINY search config (3 / 5 / 2 steps, batch 8):

* the MLP end to end: stage histories within 1e-4, params within 1e-4 /
  1e-5, assignments, counts, exact latency and energy, accuracy and the
  artifact's layers equal;
* ResNet20_tiny in float64 on both sides, where no fake-quant rounding
  goes the other way under another summation order (in float32 one does
  within a few steps, see `test_torch_search_core`'s flip readings, and
  AdamW carries it on): every train step of JAX's run repeated by the
  port from JAX's state (loss, task and regularizer within 1e-6, each
  leaf group's update within 1e-4 relative L2), `Discretize` and
  `Evaluate` from JAX's state, and the port's own run end to end from
  JAX's init with the MLP's tolerances (histories, params, assignments,
  counts, exact latency and energy, accuracy and the artifact);
* the fixed-mapping flow (``io8_backbone_ternary``), ``with_assignments``,
  ``lower(handle=)`` + ``PlannedBackend(handle=)`` in deploy mode against
  JAX's lowering and its planned backend on its interpreted kernels
  (``tpu_v5e``: split_precision 2 + quant_matmul 1), ``gpu_tc_like``'s
  searched lowering without fall-back notes, ``gap9_like``'s 3 domains,
  and the pipeline's device and checkpoint contract."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as JA  # noqa: E402
from repro import runtime as jrt  # noqa: E402
from repro.api import pipeline as JP  # noqa: E402
from repro.core import baselines as jbl  # noqa: E402
from repro.data.pipeline import ImageTaskConfig as JTask  # noqa: E402
from repro.data.pipeline import image_batch as j_image_batch  # noqa: E402
from repro.models import cnn as JC  # noqa: E402
from repro.models import facades as jfacades  # noqa: E402
from repro_torch import api as A  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch.api import pipeline as P  # noqa: E402
from repro_torch.core import baselines as bl  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.data.pipeline import ImageTaskConfig, image_batch  # noqa: E402
from repro_torch.models import cnn as C  # noqa: E402
from repro_torch.models import facades  # noqa: E402
from repro_torch.models import managed as mg  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

TINY = dict(lam=1e-6, objective="latency", pretrain_steps=3, search_steps=5,
            finetune_steps=2, batch=8, eval_batches=2)
GAP = 1e-4      # top-2 alpha gap / logit margin below which ties may break


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _data(n_classes, img_hw, dtype=np.float32):
    """(JAX data_fn, port data_fn): the port's batches are JAX's, their
    images cast to ``dtype``."""
    task, cache = JTask(n_classes=n_classes, img_hw=img_hw), {}

    def batch(step, n):
        if (step, n) not in cache:
            x, y = j_image_batch(task, step, n)
            cache[step, n] = (np.asarray(x, dtype), np.asarray(y))
        return cache[step, n]

    def jdata(step, n):
        x, y = batch(step, n)
        return jnp.asarray(x), jnp.asarray(y)

    def tdata(step, n):
        x, y = batch(step, n)
        return torch.from_numpy(x), torch.from_numpy(y.astype(np.int64))
    return jdata, tdata


def _params_close(got, want, rtol=1e-4, atol=1e-5):
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = T.leaves(got)
    assert len(wl) == len(gl)
    for (path, w), g in zip(wl, gl):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def _updates_close(new, old, jnew, rtol):
    """The port's update ``new - old`` against JAX's ``jnew - old``, by
    leaf group (the leaves' last key: w, b, alpha, log_scales,
    act_log_scale): each group's relative L2 difference below ``rtol``,
    and a group that JAX leaves still (the alphas in mode fp) left still;
    returns the readings."""
    groups = {}
    for (path, o), n, j in zip(T.leaves_with_paths(old), T.leaves(new),
                               jax.tree.leaves(jnew)):
        o = o.numpy() if torch.is_tensor(o) else np.asarray(o)
        g = groups.setdefault(path[-1], ([], []))
        g[0].append((n.detach().numpy() - o).ravel())
        g[1].append((np.asarray(j) - o).ravel())
    rel = {}
    for key, (a, b) in groups.items():
        a, b = np.concatenate(a), np.concatenate(b)
        if not b.any():
            assert not a.any(), key
            continue
        rel[key] = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        assert rel[key] < rtol, (key, rel[key])
    return rel


def _assignments_equal(handle, params, got, want):
    """Assignments equal but on channels whose top-2 alpha gap is below
    `GAP`; returns how many such channels there were."""
    near = 0
    for d, s, a, b in zip(handle.layers(params), handle.searchable(), got,
                          want):
        a, b = np.asarray(a), np.asarray(b)
        if s and "odimo" in d:
            al = np.sort(d["odimo"]["alpha"].numpy(), axis=0)
            tie = (al[-1] - al[-2]) < GAP
            near += int(tie.sum())
            np.testing.assert_array_equal(a[~tie], b[~tie])
        else:
            np.testing.assert_array_equal(a, b)
    print(f"channels within {GAP} of a tie: {near}")
    return near


def _artifact_equal(got, want):
    """Two artifacts' dicts equal, their weight log-scales within 1e-6."""
    got, want = got.to_dict(), want.to_dict()
    gl, wl = got.pop("layers"), want.pop("layers")
    gm, wm = got.pop("metrics"), want.pop("metrics")
    assert got == want
    assert gm.keys() == wm.keys()
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        sa, sb = a.pop("scales", None), b.pop("scales", None)
        assert a == b
        assert (sa is None) == (sb is None)
        if sa is not None:
            np.testing.assert_allclose(sa["w_log_scales"], sb["w_log_scales"],
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(sa["act_log_scale"],
                                       sb["act_log_scale"], rtol=0,
                                       atol=1e-6)


def _accuracy_equal(th, tp, jh, jp, spec, jspec, tdata, jdata, scfg):
    """`Evaluate`'s accuracy, sample by sample: the port's correct answers
    equal JAX's on every sample whose JAX top-2 logit margin is at least
    `GAP`."""
    near = 0
    japply = jax.jit(lambda p, x: jh.apply(p, x, jspec, "finetune", 1.0))
    x64 = jax.tree.leaves(jp)[0].dtype == np.float64
    for b in range(scfg["eval_batches"]):
        x, y = jdata(P.EVAL_DATA_OFFSET + b, scfg["batch"])
        tx, _ = tdata(P.EVAL_DATA_OFFSET + b, scfg["batch"])
        with jax.enable_x64(x64):
            jl = np.asarray(japply(jp, x))
        with torch.no_grad():
            tl = th.apply(tp, tx, spec, "finetune", 1.0).numpy()
        top2 = np.sort(jl, -1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) >= GAP
        near += int((~sure).sum())
        y = np.asarray(y)
        np.testing.assert_array_equal((tl.argmax(-1) == y)[sure],
                                      (jl.argmax(-1) == y)[sure])
    print(f"eval samples within {GAP} of a tie: {near}")


# --------------------------------------------------------------------------
# the MLP, end to end
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mlp_runs():
    mk = dict(in_dim=48, widths=(24,), n_classes=10)
    jh, th = JA.mlp_handle(**mk), A.mlp_handle(**mk)
    jdata, tdata = _data(10, (4, 4))
    jres = JA.SearchPipeline(jh, "diana", config=JA.SearchConfig(**TINY),
                             data_fn=jdata).run()
    jp0 = jh.init(jax.random.PRNGKey(0), JA.Platform.get("diana").spec())
    tres = A.SearchPipeline(th, "diana", config=A.SearchConfig(**TINY),
                            data_fn=tdata, device="cpu").run(
        init_params=params_from_jax(_np(jp0), "cpu"))
    return jh, jres, th, tres, jdata, tdata


def test_mlp_search_histories_and_params(mlp_runs):
    jh, jres, th, tres, *_ = mlp_runs
    assert jres.history.keys() == tres.history.keys()
    for stage in jres.history:
        np.testing.assert_allclose(np.asarray(tres.history[stage]),
                                   np.asarray(jres.history[stage]),
                                   rtol=1e-4, err_msg=stage)
    _params_close(tres.params, _np(jres.params))


def test_mlp_search_mapping_and_metrics(mlp_runs):
    jh, jres, th, tres, jdata, tdata = mlp_runs
    _assignments_equal(th, tres.params, tres.assignments, jres.assignments)
    for a, b in zip(tres.counts, jres.counts):
        np.testing.assert_array_equal(a, b)
    assert tres.latency == jres.latency and tres.energy == jres.energy
    _accuracy_equal(th, tres.params, jh, jres.params,
                    A.Platform.get("diana").spec(),
                    JA.Platform.get("diana").spec(), tdata, jdata, TINY)
    assert tres.accuracy == jres.accuracy
    _artifact_equal(tres.artifact, jres.artifact)
    assert tres.artifact.metrics == pytest.approx(jres.artifact.metrics)


# --------------------------------------------------------------------------
# ResNet20_tiny in float64: step by step, stage by stage, end to end
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def r20():
    """JAX's run of ResNet20_tiny in float64 (JAX's init cast up, its
    batches too) with every train step recorded (inputs and outputs) and
    the state at each stage's start, and the port's own float64 run from
    the same init.  AdamW computes in float32 on both sides, as in the
    float32 run."""
    jh, th = JA.cnn_handle(JC.RESNET20_TINY), A.cnn_handle(C.RESNET20_TINY)
    jdata, tdata = _data(10, (16, 16), np.float64)
    jp0 = jax.tree.map(lambda a: np.asarray(a, np.float64),
                       jh.init(jax.random.PRNGKey(0),
                               JA.Platform.get("diana").spec()))
    steps, starts = [], {}
    with jax.enable_x64(True):
        jpipe = JA.SearchPipeline(jh, "diana", config=JA.SearchConfig(**TINY),
                                  data_fn=jdata)
        jctx = jpipe._build_context()

        def recording(params, opt, batch, tau, lr, mode):
            out = jctx.train_step(params, opt, batch, tau, lr, mode)
            steps.append((_np(params), _np(opt), tau, lr, mode, _np(out)))
            return out
        ctx = dataclasses.replace(jctx, train_step=recording)
        state = JP.PipelineState(params=jax.tree.map(jnp.asarray, jp0))
        for stage in jpipe.stages:
            starts[stage.name] = (_np(state.params), state.counts)
            stage.run(ctx, state)
        state.params = _np(state.params)
    tres = A.SearchPipeline(th, "diana", config=A.SearchConfig(**TINY),
                            data_fn=tdata, device="cpu").run(
        init_params=params_from_jax(jp0, "cpu"))
    return jh, jctx, state, steps, starts, th, tres, jdata, tdata


def test_r20_train_steps_from_jax_state(r20):
    """Each of JAX's 10 train steps repeated by the port's train step on
    JAX's params, AdamW state, batch, tau and lr: the loss, task and
    regularizer within 1e-6 relative, and each leaf group's update within
    1e-4 relative L2 of JAX's (readings ~1e-7: AdamW's float32 bias
    corrections round otherwise in the last bit; a skipped step reads 1, a
    step at half the rate 0.5)."""
    jh, jctx, _, steps, _, th, _, jdata, tdata = r20
    tctx = A.SearchPipeline(th, "diana", config=A.SearchConfig(**TINY),
                            data_fn=tdata, device="cpu")._build_context()
    modes = [s[4] for s in steps]
    assert modes == ["fp"] * 3 + ["search"] * 5 + ["finetune"] * 2
    offsets = {"fp": 0, "search": P.SEARCH_DATA_OFFSET,
               "finetune": P.FINETUNE_DATA_OFFSET}
    seen, worst = {}, {}
    for params, opt, tau, lr, mode, out in steps:
        i = seen.setdefault(mode, 0)
        seen[mode] += 1
        topt = adamw.AdamWState(
            torch.tensor(int(opt.step), dtype=torch.int32),
            params_from_jax(opt.mu, "cpu"), params_from_jax(opt.nu, "cpu"))
        tp = params_from_jax(params, "cpu")
        new, nopt, l, task, reg = tctx.train_step(
            tp, topt, tdata(offsets[mode] + i, TINY["batch"]), tau, lr, mode)
        jnew, jopt, jl, jtask, jreg = out
        for a, b in ((l, jl), (task, jtask), (reg, jreg)):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6,
                                       err_msg=f"{mode} step {i}")
        assert int(nopt.step) == int(jopt.step)
        for key, r in _updates_close(new, tp, jnew, 1e-4).items():
            worst[key] = max(worst.get(key, 0.0), r)
    print("worst update relative L2 by leaf group:",
          {k: f"{v:.3g}" for k, v in worst.items()})


def test_r20_discretize_from_jax_state(r20):
    jh, jctx, jstate, _, starts, th, *_ = r20
    tctx = A.SearchPipeline(th, "diana", config=A.SearchConfig(**TINY),
                            data_fn=None, device="cpu")._build_context()
    params, _ = starts["discretize"]
    state = P.PipelineState(params=params_from_jax(params, "cpu"))
    P.Discretize().run(tctx, state)
    with jax.enable_x64(True):
        jst = JP.PipelineState(params=jax.tree.map(jnp.asarray, params))
        JP.Discretize().run(jctx, jst)
    for a, b in zip(state.assignments, jst.assignments):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(state.counts, jst.counts):
        np.testing.assert_array_equal(a, b)
    _artifact_equal(state.artifact, jst.artifact)


def test_r20_evaluate_from_jax_state(r20):
    jh, jctx, jstate, _, starts, th, _, jdata, tdata = r20
    tctx = A.SearchPipeline(th, "diana", config=A.SearchConfig(**TINY),
                            data_fn=tdata, device="cpu")._build_context()
    params, counts = starts["evaluate"]
    state = P.PipelineState(params=params_from_jax(params, "cpu"),
                            counts=counts)
    P.Evaluate().run(tctx, state)
    assert state.latency == jstate.latency
    assert state.energy == jstate.energy
    _accuracy_equal(th, state.params, jh, params,
                    A.Platform.get("diana").spec(),
                    JA.Platform.get("diana").spec(), tdata, jdata, TINY)


def test_r20_end_to_end_from_jax_init(r20):
    """The port's own run from JAX's init against JAX's, with the MLP's
    tolerances: stage histories within 1e-4, params within 1e-4 / 1e-5,
    assignments equal (channels within `GAP` of a tie printed), the counts,
    exact latency and energy equal, accuracy equal up to near-tied samples,
    and the artifact's layers equal."""
    jh, _, jstate, _, _, th, tres, jdata, tdata = r20
    assert tres.history.keys() == jstate.history.keys()
    for stage in jstate.history:
        np.testing.assert_allclose(np.asarray(tres.history[stage]),
                                   np.asarray(jstate.history[stage]),
                                   rtol=1e-4, err_msg=stage)
    _params_close(tres.params, jstate.params)
    _assignments_equal(th, tres.params, tres.assignments, jstate.assignments)
    for a, b in zip(tres.counts, jstate.counts):
        np.testing.assert_array_equal(a, b)
    assert tres.latency == jstate.latency and tres.energy == jstate.energy
    _accuracy_equal(th, tres.params, jh, jstate.params,
                    A.Platform.get("diana").spec(),
                    JA.Platform.get("diana").spec(), tdata, jdata, TINY)
    assert tres.accuracy == jstate.accuracy
    _artifact_equal(tres.artifact, jstate.artifact)


# --------------------------------------------------------------------------
# fixed mappings and handles
# --------------------------------------------------------------------------

def test_fixed_mapping_io8_backbone_ternary():
    """`SearchPipeline.fixed_mapping` on ResNet20_tiny: the artifact holds
    JAX's io8_backbone_ternary mapping, the alphas stay its one-hot, and
    the exact latency / energy are JAX's for those counts."""
    th = A.cnn_handle(C.RESNET20_TINY)
    geoms = th.geometries()
    assigns = bl.io8_backbone_ternary(geoms)
    jgeoms = JA.cnn_handle(JC.RESNET20_TINY).geometries()
    for a, b in zip(assigns, jbl.io8_backbone_ternary(jgeoms)):
        np.testing.assert_array_equal(a, b)
    task = ImageTaskConfig(n_classes=10, img_hw=(16, 16))
    res = A.SearchPipeline.fixed_mapping(
        th, assigns, "diana", train_steps=2, config=A.SearchConfig(**TINY),
        data_fn=lambda s, b: image_batch(task, s, b, device="cpu"),
        device="cpu").run()
    assert [l["assignment"] for l in res.artifact.layers] == \
        [a.tolist() for a in assigns]
    for d, a in zip(th.layers(res.params), assigns):
        np.testing.assert_array_equal(
            d["odimo"]["alpha"].argmax(0).numpy(), a)
    assert len(res.history["finetune_fixed"]) == 2
    jcm = JA.Platform.get("diana").cost_model()
    from repro.core import losses as jlosses
    assert res.latency == float(jlosses.exact_latency(jcm, jgeoms,
                                                      res.counts))
    assert res.energy == float(jlosses.exact_energy(jcm, jgeoms, res.counts))
    legacy = engine.evaluate_fixed_mapping(
        C.get_model(C.RESNET20_TINY), C.RESNET20_TINY,
        A.Platform.get("diana").spec(),
        A.Platform.get("diana").cost_model(), A.SearchConfig(**TINY),
        lambda s, b: image_batch(task, s, b, device="cpu"), assigns,
        train_steps=2, device="cpu")
    assert legacy.latency == res.latency and legacy.accuracy == res.accuracy


def test_with_assignments_is_functional():
    th = A.cnn_handle(C.RESNET20_TINY)
    spec = A.Platform.get("diana").spec()
    params = th.init(torch.Generator().manual_seed(0), spec)
    before = th.layers(params)[0]["odimo"]["alpha"].clone()
    assigns = bl.all_ternary(th.geometries())
    mapped = th.with_assignments(params, assigns, spec.n_domains)
    assert torch.equal(th.layers(params)[0]["odimo"]["alpha"], before)
    np.testing.assert_array_equal(
        th.layers(mapped)[0]["odimo"]["alpha"].argmax(0).numpy(), assigns[0])
    assert th.layers(mapped)[0]["w"] is th.layers(params)[0]["w"]
    with pytest.raises(ValueError, match="assignments"):
        th.with_assignments(params, assigns[:-1], spec.n_domains)
    copies = A.ModelHandle.from_legacy(
        C.get_model(C.RESNET20_TINY), C.RESNET20_TINY,
        managed_fn=lambda p: [{"odimo": {"alpha": d["odimo"]["alpha"]
                                         .clone()}, "w": d["w"]}
                              for d in th.layers(p)])
    with pytest.raises(ValueError, match="not leaves"):
        copies.with_assignments(params, assigns, spec.n_domains)


# --------------------------------------------------------------------------
# lowering a searched mapping with the handle
# --------------------------------------------------------------------------

def test_lower_with_handle_deploys_like_jax():
    """JAX's tests/test_runtime.py planned-MLP case in the port: a
    tpu_v5e fixed mapping lowered with ``handle=`` (split_precision 2 +
    quant_matmul 1), bound at full coverage by ``PlannedBackend(handle=)``;
    the plan's JSON equals JAX's lowering of the same artifact and params,
    and the deploy logits JAX's planned backend on its interpreted kernels
    within 1e-4 (and the fp logits within JAX's 0.15 relative)."""
    mk = dict(in_dim=48, widths=(160, 144), n_classes=10)
    th, jh = A.mlp_handle(**mk), JA.mlp_handle(**mk)
    task = ImageTaskConfig(n_classes=10, img_hw=(4, 4))
    assigns = [np.array([0] * 96 + [1] * 64), np.array([0] * 80 + [1] * 64),
               np.zeros(10, np.int64)]
    res = A.SearchPipeline.fixed_mapping(
        th, assigns, "tpu_v5e", train_steps=2, config=A.SearchConfig(**TINY),
        data_fn=lambda s, b: image_batch(task, s, b, device="cpu"),
        device="cpu").run()
    art = res.artifact
    assert art.schema_version == 2
    assert art.layers[0]["scales"]["w_log_scales"] is not None
    plan = rt.lower(art, params=res.params, handle=th)
    assert plan.kernel_histogram() == {rt.KERNEL_SPLIT: 2,
                                       rt.KERNEL_QUANT: 1}
    backend = rt.PlannedBackend(plan, res.params, handle=th)
    assert backend.bound == [lp.name for lp in plan.layers]
    assert backend.fully_covered

    jparams = jax.tree.map(jnp.asarray, _np(T.tree_map(
        lambda t: t.numpy(), res.params)))
    jplan = jrt.lower(art.to_dict(), params=jparams, handle=jh)
    for a, b in zip(plan.to_dict()["layers"], jplan.to_dict()["layers"]):
        wa, wb = a.pop("w_log_scales"), b.pop("w_log_scales")
        assert a == b
        np.testing.assert_allclose(wa, wb, rtol=0, atol=1e-6)
    spec, jspec = A.Platform.get("tpu_v5e").spec(), JA.Platform.get(
        "tpu_v5e").spec()
    x, _ = image_batch(task, 0, 8, device="cpu")
    with torch.no_grad():
        y_dep = facades.mlp_apply(res.params, x, th.config, spec,
                                  mode="deploy", backend=backend)
        y_fp = facades.mlp_apply(res.params, x, th.config, spec, mode="fp")
        y_fb = facades.mlp_apply(res.params, x, th.config, spec,
                                 mode="deploy")
    jbackend = jrt.PlannedBackend(jplan, jparams, handle=jh, interpret=True)
    y_jax = jfacades.mlp_apply(jparams, jnp.asarray(x.numpy()), jh.config,
                               jspec, mode="deploy", backend=jbackend)
    np.testing.assert_allclose(y_dep.numpy(), np.asarray(y_jax), rtol=0,
                               atol=1e-4)
    assert float((y_dep - y_fp).norm() / y_fp.norm()) < 0.15
    assert bool(torch.isfinite(y_fb).all())


def test_lower_with_handle_checks_the_layer_count():
    th = A.mlp_handle(in_dim=8, widths=(6,), n_classes=3)
    spec = A.Platform.get("diana").spec()
    params = th.init(torch.Generator().manual_seed(0), spec)
    assigns = [np.zeros(6, np.int64), np.zeros(3, np.int64)]
    art = A.MappingArtifact.from_search(
        "m", spec, th.plan(), assigns,
        bl.counts_from_assignments(assigns, 2))
    short = dataclasses.replace(th, managed_layers=lambda p: th.layers(p)[:1])
    with pytest.raises(rt.LoweringError, match="managed layers"):
        rt.lower(art, params=params, handle=short)
    plan = rt.lower(art, params=params, handle=th)
    with pytest.raises(rt.ExecutionError, match="managed layers"):
        rt.PlannedBackend(plan, params, handle=short)
    # managed dicts (odimo state, act scale) bind as plain ones do
    backend = rt.PlannedBackend(plan, params, handle=th)
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(1))
    with mg.matmul_backend(backend), torch.no_grad():
        y = facades.mlp_apply(params, x, th.config, spec, mode="deploy")
    assert y.shape == (4, 3) and backend.fully_covered


# --------------------------------------------------------------------------
# other platforms, and the pipeline's contract
# --------------------------------------------------------------------------

def _tiny_search(platform):
    th = A.mlp_handle(in_dim=48, widths=(24,), n_classes=10)
    task = ImageTaskConfig(n_classes=10, img_hw=(4, 4))
    res = A.SearchPipeline(
        th, platform, config=A.SearchConfig(**TINY),
        data_fn=lambda s, b: image_batch(task, s, b, device="cpu"),
        device="cpu").run()
    return th, res


def test_gpu_tc_search_lowers_executably():
    th, res = _tiny_search("gpu_tc_like")
    plan = rt.lower(res.artifact, params=res.params, handle=th)
    for lp in plan.layers:
        assert lp.kernel in (rt.KERNEL_QUANT, rt.KERNEL_SPLIT, rt.KERNEL_FP)
        assert not lp.note


def test_gap9_search_and_lowering():
    plat = A.Platform.get("gap9_like")
    assert [d.name for d in plat.domains] == ["ne16", "analog",
                                              "cluster_fp16"]
    assert plat.spec().n_domains == 3 and plat.spec().act_bits == 7
    th, res = _tiny_search("gap9_like")
    assert all(len(c) == 3 for c in res.counts)
    assert len(res.artifact.domains) == 3
    plan = rt.lower(res.artifact, params=res.params, handle=th)
    for lp in plan.layers:
        if len(lp.active_domains()) > 2:
            assert lp.kernel == rt.KERNEL_FP and lp.note


def test_platform_registry_matches_jax():
    assert list(A.Platform.names()) == list(JA.Platform.names())
    for name in A.Platform.names():
        p, jp = A.Platform.get(name), JA.Platform.get(name)
        assert [dataclasses.astuple(d) for d in p.domains] == \
            [dataclasses.astuple(d) for d in jp.domains]
        assert dataclasses.astuple(p.spec())[1:] == \
            dataclasses.astuple(jp.spec())[1:]


def test_pipeline_device_and_checkpoint_contract(tmp_path):
    th = A.mlp_handle(in_dim=48, widths=(8,), n_classes=10)
    task = ImageTaskConfig(n_classes=10, img_hw=(4, 4))
    data = lambda s, b: image_batch(task, s, b, device="cpu")  # noqa: E731
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            A.SearchPipeline(th, "diana", data_fn=data)
    with pytest.raises(FileNotFoundError, match="no committed"):
        A.SearchPipeline(th, "diana", data_fn=data, device="cpu",
                         resume_from=str(tmp_path / "ck")).run()
    meta = T.tree_map(lambda t: t.to("meta"), th.init(
        torch.Generator().manual_seed(0), A.Platform.get("diana").spec()))
    with pytest.raises(ValueError, match="init_params"):
        A.SearchPipeline(th, "diana", data_fn=data,
                         device="cpu").run(init_params=meta)
    wrong = lambda s, b: tuple(t.to("meta") for t in data(s, b))  # noqa
    with pytest.raises(ValueError, match="data_fn"):
        A.SearchPipeline(th, "diana", data_fn=wrong, device="cpu").run()
    res = engine.run_odimo(
        facades_tuple(), th.config, A.Platform.get("diana").spec(),
        A.Platform.get("diana").cost_model(),
        A.SearchConfig(**dict(TINY, pretrain_steps=1, search_steps=1,
                              finetune_steps=1)), data, device="cpu")
    assert len(res.assignments) == 2 and res.latency > 0
    assert set(res.history) == {"pretrain", "search", "finetune"}


def facades_tuple():
    return (facades.mlp_init, facades.mlp_apply, facades.mlp_plan)
