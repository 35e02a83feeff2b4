"""The ODiMO search's building blocks in the port against the JAX package,
forward values and ``torch.autograd`` gradients against ``jax.grad`` on
the same numpy inputs: fake quantization (a weight exactly at the clip
bound, where JAX's ``jnp.clip`` passes half the gradient), ``ste_ceil``,
every platform's cost model, the smooth max and the latency / energy
regularizers with respect to the alphas, the mixed and the discretized
weight, the temperature schedule, the exact cost of a mapping, the Fig. 3
reorg pass, the baselines, AdamW over three steps, and the synthetic
image stream; then the façades (ResNet20_tiny, MobileNetV1_tiny, the MLP
and the encoder) with JAX's parameters carried across: logits in every
mode within 1e-5 and `make_loss_fn`'s loss and gradients in the fp,
search and finetune modes."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as JA  # noqa: E402
from repro.core import baselines as jbl  # noqa: E402
from repro.core import cost_models as jcm  # noqa: E402
from repro.core import discretize as jdisc  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import odimo as jodimo  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.data.pipeline import ImageTaskConfig as JTask  # noqa: E402
from repro.data.pipeline import image_batch as j_image_batch  # noqa: E402
from repro.models import cnn as JC  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import api as A  # noqa: E402
from repro_torch.core import baselines as bl  # noqa: E402
from repro_torch.core import cost_models as cm  # noqa: E402
from repro_torch.core import discretize as disc  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core import losses  # noqa: E402
from repro_torch.core import odimo  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.data.pipeline import ImageTaskConfig, image_batch  # noqa: E402
from repro_torch.models import cnn as C  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

PLATFORMS = ("diana", "diana_abstract", "diana_ideal_shutdown", "tpu_v5e",
             "gap9_like", "gpu_tc_like")
GEOMS = [(64, 64, 3, 3, 8, 8), (3, 16, 3, 3, 32, 32), (4096, 512),
         (300, 40, 1, 1, 1, 1, 4), (1200, 33, 1, 1, 1, 1)]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.requires_grad_(True) if grad else t


def _close(got, want, rtol=1e-6, atol=0.0):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _grad_parity(jf, tf, *args, rtol=1e-6, jit=False):
    """``jf`` / ``tf`` on the same numpy ``args``: values and the
    gradients of their sums with respect to every argument, within
    ``rtol``.  A gradient of an argument smaller than the output (a scale,
    an alpha row, a count) is a sum over the output's elements, which the
    two packages add in other orders: it is held within ``rtol`` plus the
    float32 rounding of that sum, 1e-6 x the output's L1 norm."""
    ja = [jnp.asarray(a) for a in args]
    maybe_jit = jax.jit if jit else (lambda f: f)
    out = np.asarray(maybe_jit(jf)(*ja))
    jv, jg = maybe_jit(jax.value_and_grad(
        lambda *a: jnp.sum(jf(*a)), argnums=tuple(range(len(args)))))(*ja)
    ta = [_t(a, grad=True) for a in args]
    tv = torch.sum(tf(*ta))
    tg = torch.autograd.grad(tv, ta, allow_unused=True)
    l1 = float(np.abs(out.astype(np.float64)).sum())
    _close(tv, jv, rtol=rtol, atol=1e-6 * l1)
    for g, want, a in zip(tg, jg, ta):
        atol = 1e-6 * l1 if a.numel() < out.size else 0.0
        _close(torch.zeros_like(a) if g is None else g, want, rtol=rtol,
               atol=atol)


# --------------------------------------------------------------------------
# quantization
# --------------------------------------------------------------------------

def _weights_at_bound(seed=0):
    """Weights whose largest magnitude is exactly 1 (and -1), at log-scale
    0: ``x / exp(0)`` sits on the clip bound in both packages."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(-0.9, 0.9, size=(3, 3, 4, 8)).astype(np.float32)
    w[0, 0, 0, 0], w[1, 2, 3, 4] = 1.0, -1.0
    return w


@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_fake_quant_forward_and_grad_at_the_clip_bound(bits):
    w = _weights_at_bound()
    _grad_parity(lambda w, s: jquant.fake_quant(w, s, bits) ** 2,
                 lambda w, s: quant.fake_quant(w, s, bits) ** 2,
                 w, np.float32(0.0))
    # the bound's element passes half the gradient, as jnp.clip does
    if bits < 16:
        t = _t(w, grad=True)
        quant.fake_quant(t, torch.tensor(0.0), bits).sum().backward()
        assert float(t.grad[0, 0, 0, 0]) == 0.5
        assert float(t.grad[1, 2, 3, 4]) == 0.5


def test_fake_quant_per_channel_scales_and_outside_the_clip():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    ls = np.log(np.abs(w).max(0) * 0.7).astype(np.float32)  # some clipped
    _grad_parity(lambda w, s: jquant.fake_quant(w, s, 8) * w,
                 lambda w, s: quant.fake_quant(w, s, 8) * w, w, ls)


@pytest.mark.parametrize("bits", [7, 8, 16])
def test_fake_quant_act_forward_and_grad(bits):
    rng = np.random.default_rng(2)
    x = np.maximum(rng.normal(size=(4, 6, 6, 8)), 0).astype(np.float32)
    x[0, 0, 0, :3] = (0.0, 1.0, 2.5)     # the lower bound, the upper, past
    _grad_parity(lambda x, s: jquant.fake_quant_act(x, s, bits) ** 2,
                 lambda x, s: quant.fake_quant_act(x, s, bits) ** 2,
                 x, np.float32(0.0))


def test_quant_helpers_match_jax():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(5, 7)).astype(np.float32)
    for per_channel in (False, True):
        _close(quant.init_log_scale(_t(w), per_channel=per_channel),
               jquant.init_log_scale(jnp.asarray(w), per_channel=per_channel))
    codes = quant.quantize_int(_t(w), 0.5, 8)
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(jquant.quantize_int(jnp.asarray(w), 0.5, 8)))
    _close(quant.dequantize_int(codes, 0.5, 8),
           jquant.dequantize_int(jnp.asarray(codes.numpy()), 0.5, 8))
    c = rng.integers(0, 256, size=(9,)).astype(np.int32)
    np.testing.assert_array_equal(
        quant.truncate_lsb(torch.from_numpy(c)).numpy(),
        np.asarray(jquant.truncate_lsb(jnp.asarray(c))))
    assert [dataclasses.astuple(d) for d in quant.TPU_DOMAINS] == \
        [dataclasses.astuple(d) for d in jquant.TPU_DOMAINS]
    assert dataclasses.astuple(quant.TPU_INT4) == \
        dataclasses.astuple(jquant.TPU_INT4)


# --------------------------------------------------------------------------
# cost models and losses
# --------------------------------------------------------------------------

def test_ste_ceil_forward_and_grad():
    x = np.asarray([0.3, 1.0, 1.7, 511.9, 512.0, 513.2], np.float32)
    _grad_parity(lambda x: jcm.ste_ceil(x) * x, lambda x: cm.ste_ceil(x) * x,
                 x)


@pytest.mark.parametrize("name", PLATFORMS)
def test_cost_model_latency_forward_and_grad(name):
    """Every platform's latency at continuous counts (some near 0, where a
    domain switches off), and its gradient with respect to the counts."""
    tcm, jc = A.Platform.get(name).cost_model(), JA.Platform.get(name)
    jcmodel = jc.cost_model()
    n = len(jc.domains)
    rng = np.random.default_rng(4)
    for g in GEOMS:
        for counts in (rng.uniform(0.5, 40.0, n),
                       np.r_[1e-7, rng.uniform(1, 9, n - 1)]):
            counts = counts.astype(np.float32)
            _grad_parity(
                lambda c: jcmodel.latency(jcm.LayerGeometry(*g), c),
                lambda c: tcm.latency(cm.LayerGeometry(*g), c), counts)
    _close(tcm.p_act(), jcmodel.p_act())
    _close(tcm.p_idle(), jcmodel.p_idle())


def test_cost_model_prices_split_batches_as_single_calls():
    """The (N, K) batch of `baselines.min_cost` gives each column's
    single-split latency bit for bit."""
    for name in PLATFORMS:
        model = A.Platform.get(name).cost_model()
        n = len(model.domains)
        g = cm.LayerGeometry(64, 48, 3, 3, 8, 8)
        k = torch.arange(49, dtype=torch.float32)
        batch = torch.stack([k, 48 - k] + [k * 0 + 5] * (n - 2))
        lat = model.latency(g, batch)
        for j in (0, 7, 48):
            assert torch.equal(lat[:, j], model.latency(g, batch[:, j]))


@pytest.mark.parametrize("name,smooth_beta", [
    ("diana", None), ("diana", 50.0), ("tpu_v5e", None), ("gap9_like", 50.0)])
def test_regularizers_grad_with_respect_to_alphas(name, smooth_beta):
    """`latency_loss` / `energy_loss` and `smooth_max` through
    ``alpha_bar``: values and gradients with respect to the alphas, within
    1e-5 relative: they pass through float32 exp and log, which XLA's CPU
    rounds otherwise than PyTorch in about a tenth of the inputs (against
    the correctly rounded value: XLA's exp 9 %, log 15 %, PyTorch's 1 %)."""
    tcm = A.Platform.get(name).cost_model()
    jcmodel = JA.Platform.get(name).cost_model()
    n = len(tcm.domains)
    geoms = GEOMS[:2] + GEOMS[3:]
    rng = np.random.default_rng(5)
    alphas = [(rng.normal(size=(n, g[1])) * 0.5).astype(np.float32)
              for g in geoms]
    tau = 0.5
    for fn in ("latency_loss", "energy_loss"):
        def jf(*al):
            return getattr(jlosses, fn)(
                jcmodel, [jcm.LayerGeometry(*g) for g in geoms],
                [jodimo.alpha_bar(a, tau) for a in al], smooth_beta)

        def tf(*al):
            return getattr(losses, fn)(
                tcm, [cm.LayerGeometry(*g) for g in geoms],
                [odimo.alpha_bar(a, tau) for a in al], smooth_beta)
        _grad_parity(jf, tf, *alphas, rtol=1e-5, jit=True)
    x = rng.normal(size=(3, 5)).astype(np.float32) * 100
    _grad_parity(lambda x: jlosses.smooth_max(x, 7.0),
                 lambda x: losses.smooth_max(x, 7.0), x, rtol=1e-5)


@pytest.mark.parametrize("name", ["diana", "tpu_v5e", "gap9_like"])
def test_exact_cost_of_a_mapping(name):
    tcm = A.Platform.get(name).cost_model()
    jcmodel = JA.Platform.get(name).cost_model()
    n = len(tcm.domains)
    rng = np.random.default_rng(6)
    geoms = [g for g in GEOMS]
    counts = [np.bincount(rng.integers(0, n, g[1]), minlength=n)
              for g in geoms]
    tg = [cm.LayerGeometry(*g) for g in geoms]
    jg = [jcm.LayerGeometry(*g) for g in geoms]
    assert float(losses.exact_latency(tcm, tg, counts)) == \
        float(jlosses.exact_latency(jcmodel, jg, counts))
    assert float(losses.exact_energy(tcm, tg, counts)) == \
        float(jlosses.exact_energy(jcmodel, jg, counts))


def test_cross_entropy_forward_and_grad():
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(8, 10)).astype(np.float32) * 3
    y = rng.integers(0, 10, 8)
    _grad_parity(lambda l: jlosses.cross_entropy(l, jnp.asarray(y)),
                 lambda l: losses.cross_entropy(l, torch.from_numpy(y)),
                 logits)


# --------------------------------------------------------------------------
# the ODiMO state
# --------------------------------------------------------------------------

def _state(rng, n, c_out, w):
    return {"alpha": (rng.normal(size=(n, c_out)) * 0.3).astype(np.float32),
            "log_scales": np.stack(
                [np.float32(0.0)] + [np.float32(np.log(np.abs(w).max()))
                                     * (1 + 0.1 * i) for i in range(n - 1)])
            .astype(np.float32)}


@pytest.mark.parametrize("platform", ["diana", "tpu_v5e", "gap9_like"])
def test_effective_and_discretized_weight_forward_and_grad(platform):
    jspec = JA.Platform.get(platform).spec()
    spec = A.Platform.get(platform).spec()
    w = _weights_at_bound(8)
    st = _state(np.random.default_rng(9), spec.n_domains, 8, w)
    for tau in (1.0, 0.37):
        _grad_parity(
            lambda w, a, s: jodimo.effective_weight(
                w, {"alpha": a, "log_scales": s}, jspec, tau) ** 2,
            lambda w, a, s: odimo.effective_weight(
                w, {"alpha": a, "log_scales": s}, spec, tau) ** 2,
            w, st["alpha"], st["log_scales"], rtol=1e-5)
    _grad_parity(
        lambda w, a, s: jodimo.discretized_weight(
            w, {"alpha": a, "log_scales": s}, jspec) ** 2,
        lambda w, a, s: odimo.discretized_weight(
            w, {"alpha": a, "log_scales": s}, spec) ** 2,
        w, st["alpha"], st["log_scales"])
    tst = {k: _t(v) for k, v in st.items()}
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    np.testing.assert_array_equal(odimo.assignment(tst).numpy(),
                                  np.asarray(jodimo.assignment(jst)))
    np.testing.assert_array_equal(
        odimo.domain_counts(tst, spec.n_domains).numpy(),
        np.asarray(jodimo.domain_counts(jst, spec.n_domains)))
    _close(odimo.expected_counts(tst, 0.3), jodimo.expected_counts(jst, 0.3))


def test_init_layer_state_and_tau_schedule():
    spec = odimo.ODiMOSpec()
    w = _t(_weights_at_bound(10) * 0.3)
    st = odimo.init_layer_state(torch.Generator().manual_seed(0), w, spec)
    assert tuple(st["alpha"].shape) == (2, 8)
    assert float(st["alpha"].abs().max()) < 0.1
    _close(st["log_scales"], np.full(2, np.log(0.3), np.float32), rtol=1e-6)
    jspec = jodimo.ODiMOSpec()
    for total in (1, 5, 400):
        for step in sorted({0, 1, total // 2, total - 1, total, total + 3}):
            _close(odimo.tau_schedule(step, total, spec),
                   jodimo.tau_schedule(step, total, jspec))


# --------------------------------------------------------------------------
# the reorg pass and the baselines
# --------------------------------------------------------------------------

def _reorg_pair(layers_np, assigns, in_axis):
    jl = [jdisc.ReorgLayer(w=jnp.asarray(w), b=jnp.asarray(b), assign=a,
                           in_axis=in_axis) for (w, b), a in
          zip(layers_np, assigns)]
    tl = [disc.ReorgLayer(w=_t(w), b=_t(b), assign=a, in_axis=in_axis)
          for (w, b), a in zip(layers_np, assigns)]
    return jl, tl


def test_reorg_chain_keeps_an_mlps_function():
    rng = np.random.default_rng(11)
    dims = [12, 10, 9, 5]
    layers_np = [(rng.normal(size=(dims[i], dims[i + 1])).astype(np.float32),
                  rng.normal(size=(dims[i + 1],)).astype(np.float32))
                 for i in range(3)]
    assigns = [rng.integers(0, 2, d) for d in dims[1:]]
    jl, tl = _reorg_pair(layers_np, assigns, 0)
    new, bounds = disc.reorg_chain(tl, 2)
    jnew, jbounds = jdisc.reorg_chain(jl, 2)
    assert bounds == jbounds
    for a, b in zip(new, jnew):
        np.testing.assert_array_equal(a.w.numpy(), np.asarray(b.w))
        np.testing.assert_array_equal(a.assign, b.assign)
    x = _t(rng.normal(size=(4, 12)))

    def fwd(ls):
        h = x
        for l in ls:
            h = torch.relu(h @ l.w + l.b)
        return h
    _close(fwd(new), fwd(tl).numpy(), rtol=1e-5, atol=1e-6)
    assert disc.sublayer_slices(bounds[0]) == jdisc.sublayer_slices(bounds[0])


def test_reorg_chain_keeps_a_conv_chains_function():
    import torch.nn.functional as F
    rng = np.random.default_rng(12)
    chans = [3, 8, 6]
    layers_np = [(rng.normal(size=(3, 3, chans[i], chans[i + 1]))
                  .astype(np.float32),
                  rng.normal(size=(chans[i + 1],)).astype(np.float32))
                 for i in range(2)]
    assigns = [rng.integers(0, 2, c) for c in chans[1:]]
    _, tl = _reorg_pair(layers_np, assigns, -2)
    art = {"domains": [{}, {}],
           "layers": [{"assignment": a.tolist()} for a in assigns]}
    new, _ = disc.reorg_chain_from_artifact(tl, art)
    x = _t(rng.normal(size=(2, 3, 7, 7)))

    def fwd(ls):
        h = x
        for l in ls:
            h = torch.relu(F.conv2d(h, l.w.permute(3, 2, 0, 1), l.b,
                                    padding=1))
        return h
    _close(fwd(new), fwd(tl).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(new[0].assign, np.sort(assigns[0]))
    with pytest.raises(ValueError, match="layers"):
        disc.reorg_chain_from_artifact(tl[:1], art)


def test_baselines_match_jax():
    geoms = [(3, 16, 3, 3, 32, 32), (16, 32), (32, 10)]
    tg = [cm.LayerGeometry(*g) for g in geoms]
    jg = [jcm.LayerGeometry(*g) for g in geoms]
    for fn in ("all_8bit", "all_ternary", "io8_backbone_ternary"):
        for a, b in zip(getattr(bl, fn)(tg), getattr(jbl, fn)(jg)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(bl.all_domain(tg, 1), jbl.all_domain(jg, 1)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# AdamW and the image stream
# --------------------------------------------------------------------------

@pytest.mark.parametrize("grad_scale", [0.3, 0.02])
def test_adamw_three_steps_match_jax(grad_scale):
    """Three updates of a tree with alphas and an unused (zero-gradient)
    leaf: params, moments, the step and the grad norms within 1e-5
    relative (the bias corrections' float32 powers round otherwise in the
    last bit); at grad scale 0.3 the norm (~2) clips at 1.0, at 0.02 (~0.1)
    it passes unclipped."""
    rng = np.random.default_rng(13)

    def tree(s):
        return {"w": (rng.normal(size=(6, 5)) * s).astype(np.float32),
                "l": [{"odimo": {"alpha": (rng.normal(size=(2, 5)) * s)
                                 .astype(np.float32)},
                       "act_log_scale": np.float32(s)}],
                "z": np.zeros(3, np.float32)}
    params = tree(1.0)
    grads = [tree(grad_scale) for _ in range(3)]
    for g in grads:
        g["z"] = np.zeros(3, np.float32)
    norms = [float(np.sqrt(sum(np.sum(np.square(x))
                               for x in jax.tree.leaves(g)))) for g in grads]
    assert all((n > 1.0) == (grad_scale > 0.1) for n in norms), norms
    jc = jadamw.AdamWConfig(lr=2e-3)
    tc = adamw.AdamWConfig(lr=2e-3)
    jp, tp = jax.tree.map(jnp.asarray, params), jax.tree.map(_t, params)
    js, ts = jadamw.init(jp, jc), adamw.init(tp, tc)
    for g in grads:
        jp, js, jn = jadamw.update(jax.tree.map(jnp.asarray, g), js, jp, jc)
        tp, ts, tn = adamw.update(jax.tree.map(_t, g), ts, tp, tc)
        _close(tn, jn)
    assert int(ts.step) == int(js.step) == 3
    for a, b in zip(T.leaves(tp) + T.leaves(ts.mu) + T.leaves(ts.nu),
                    jax.tree.leaves(jp) + jax.tree.leaves(js.mu) +
                    jax.tree.leaves(js.nu)):
        _close(a, b, rtol=1e-5, atol=1e-9)
    for step in (0, 5, 10, 50, 200):
        _close(adamw.warmup_cosine(step, peak_lr=1e-3, warmup=10, total=100),
               jadamw.warmup_cosine(step, peak_lr=1e-3, warmup=10,
                                    total=100))


def test_image_batch_is_a_pure_function_of_seed_step_shard():
    task = ImageTaskConfig(n_classes=10, img_hw=(8, 8))
    x, y = image_batch(task, 3, 16, device="cpu")
    assert tuple(x.shape) == (16, 8, 8, 3) and x.dtype == torch.float32
    assert y.dtype == torch.int64 and int(y.min()) >= 0 and int(y.max()) < 10
    x2, y2 = image_batch(task, 3, 16, device="cpu")
    assert torch.equal(x, x2) and torch.equal(y, y2)
    assert not torch.equal(image_batch(task, 4, 16, device="cpu")[0], x)
    assert not torch.equal(image_batch(task, 3, 16, shard=1,
                                       device="cpu")[0], x)


# --------------------------------------------------------------------------
# the façades in every mode
# --------------------------------------------------------------------------

MODELS = {
    "resnet20_tiny": (lambda m: m.cnn_handle(
        (JC if m is JA else C).RESNET20_TINY), (16, 16), 10),
    "mobilenetv1_tiny": (lambda m: m.cnn_handle(
        (JC if m is JA else C).MBV1_TINY), (32, 32), 2),
    "mlp": (lambda m: m.mlp_handle(in_dim=48, widths=(24, 16), n_classes=10),
            (4, 4), 10),
    "encoder": (lambda m: m.transformer_handle(
        in_dim=12, n_tokens=4, d_model=16, n_layers=1, n_classes=10,
        n_heads=2), (4, 4), 10),
}


@pytest.fixture(scope="module")
def facades():
    """{name: (JAX handle, JAX params, port handle, port params, JAX batch,
    port batch)}: JAX's init (PRNGKey 0) carried across."""
    out = {}
    jspec = JA.Platform.get("diana").spec()
    for name, (make, hw, nc) in MODELS.items():
        jh, th = make(JA), make(A)
        jp = jax.jit(lambda key: jh.init(key, jspec))(jax.random.PRNGKey(0))
        x, y = j_image_batch(JTask(n_classes=nc, img_hw=hw), 0, 8)
        out[name] = (jh, jp, th,
                     params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
                     (x, y), (_t(x), torch.from_numpy(np.asarray(y))
                              .to(torch.int64)))
    return out


QUANTIZED_CNN = {"resnet20_tiny", "mobilenetv1_tiny"}


def _flip_rule(what, got, want, margin_tol=1e-2):
    """A quantized CNN's output against JAX's where the two disagree by
    more than 1e-5: an activation whose fake-quant input lies within an
    ulp of a rounding half-point can round the other way under another
    summation order (one step, exp(1) / 127 at init, which then travels
    through every later layer).  Such a run must still agree within 1e-2
    relative L2 and in each row's argmax where JAX's top-2 margin exceeds
    1e-2."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"{what}: quantizer flip, max |diff| "
          f"{np.abs(got - want).max():.3g}, relative L2 {rel:.3g}")
    assert rel < 1e-2, (what, rel)
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > margin_tol
    np.testing.assert_array_equal(got.argmax(-1)[sure],
                                  want.argmax(-1)[sure])


@pytest.mark.parametrize("mode", ["fp", "search", "finetune", "deploy"])
@pytest.mark.parametrize("name", list(MODELS))
def test_facade_logits_in_every_mode(facades, name, mode):
    """Logits within 1e-5 of JAX's; the quantized modes of the CNNs under
    `_flip_rule` where a fake-quant rounding went the other way."""
    jh, jp, th, tp, (x, _), (tx, _) = facades[name]
    spec, jspec = A.Platform.get("diana").spec(), JA.Platform.get(
        "diana").spec()
    with torch.no_grad():
        got = th.apply(tp, tx, spec, mode, 0.5).numpy()
    want = np.asarray(jax.jit(
        lambda p, x: jh.apply(p, x, jspec, mode, 0.5))(jp, x))
    if mode == "fp" or name not in QUANTIZED_CNN or \
            np.abs(got - want).max() <= 1e-5:
        _close(got, want, rtol=0, atol=1e-5)
    else:
        _flip_rule(f"{name} {mode}", got, want)


def _off_discontinuities(params, seed):
    """``params`` with seeded nonzero biases and the weight log-scales
    raised by 1e-3.  At init every bias is 0, so a sum of ternary weights
    times quantized activations is often exactly 0, where ReLU's gate
    follows the summation order; and each layer's largest weight sits on
    the clip bound, where the gradient halves or vanishes on the last ulp
    of ``exp(log(max|w|))`` (JAX's exp and log round otherwise than
    PyTorch's).  The bound itself is held by the fake-quant tests above."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        keys = [getattr(p, "key", None) for p in path]
        if keys[-1] == "b":
            return jnp.asarray(rng.normal(size=leaf.shape) * 0.05,
                               jnp.float32)
        if keys[-1] == "log_scales":
            return leaf + jnp.float32(1e-3)
        return leaf
    return jax.tree_util.tree_map_with_path(move, params)


def _loss_and_grads(facades, name, mode, dtype):
    """`make_loss_fn`'s value and gradients in both packages, on JAX's
    params moved off the discontinuities and the batch, both cast to
    ``dtype``: ((loss, task, reg), gradient leaves with paths) for JAX,
    ((loss, task, reg), gradient leaves) for the port."""
    jh, jp, th, _, (x, y), _ = facades[name]
    jp = jax.tree.map(lambda a: np.asarray(a, dtype),
                      _off_discontinuities(jp, 14))
    x = np.asarray(x, dtype)
    tp = params_from_jax(jp, "cpu")
    tx, ty = torch.from_numpy(x), torch.from_numpy(np.asarray(y)).to(
        torch.int64)
    jspec, spec = JA.Platform.get("diana").spec(), A.Platform.get(
        "diana").spec()
    cfg, jcfg = engine.SearchConfig(lam=1e-6), jengine.SearchConfig(lam=1e-6)
    with jax.enable_x64(dtype == np.float64):
        jloss = jengine.make_loss_fn(
            lambda p, x, mode, tau: jh.apply(p, x, jspec, mode, tau),
            jh.plan(), jspec, JA.Platform.get("diana").cost_model(), jcfg,
            jh.layers)
        (jv, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True),
                                 static_argnums=(3,))(
            jax.tree.map(jnp.asarray, jp), (jnp.asarray(x), jnp.asarray(y)),
            0.5, mode)
        jleaves = [(path, np.asarray(w))
                   for path, w in jax.tree_util.tree_leaves_with_path(jg)]
        jvals = [float(v) for v in (jv, *jaux)]
    loss = engine.make_loss_fn(
        lambda p, x, mode, tau: th.apply(p, x, spec, mode, tau), th.plan(),
        spec, A.Platform.get("diana").cost_model(), cfg, th.layers)
    pl = T.leaves_with_paths(tp)
    req = [leaf.clone().requires_grad_(True) for _, leaf in pl]
    tv, taux = loss(T.unflatten(tp, req), (tx, ty), 0.5, mode)
    tg = torch.autograd.grad(tv, req, allow_unused=True)
    assert len(jleaves) == len(tg)
    got = [(torch.zeros_like(leaf) if g is None else g).numpy()
           for (_, leaf), g in zip(pl, tg)]
    tvals = [float(v.detach()) if torch.is_tensor(v) else float(v)
             for v in (tv, *taux)]
    return jvals, jleaves, tvals, got


def _grads_by_group(jleaves, got):
    """Relative L2 of the port's gradients against JAX's, by leaf group
    (the leaves' last key: w, b, alpha, log_scales, act_log_scale); a
    group whose JAX gradient is 0 (the alphas in mode finetune) must be 0
    in the port too and is left out."""
    groups = {}
    for (path, w), g in zip(jleaves, got):
        a = groups.setdefault(getattr(path[-1], "key", None), ([], []))
        a[0].append(g.ravel())
        a[1].append(w.ravel())
    rel = {}
    for key, (a, b) in groups.items():
        a, b = np.concatenate(a), np.concatenate(b)
        if not b.any():
            assert not a.any(), key
            continue
        rel[key] = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    return rel


@pytest.mark.parametrize("mode", ["fp", "search", "finetune"])
@pytest.mark.parametrize("name", list(MODELS))
def test_make_loss_fn_loss_and_grads(facades, name, mode):
    """`make_loss_fn` on diana (lambda 1e-6, the latency regularizer in
    mode search): the loss and the task part within 1e-6 relative, the
    regularizer within 1e-5 (through exp), each leaf's gradient within
    1e-5 of the model's largest.  Where a quantized CNN mode shows a
    rounding flip (see `_flip_rule`), the float32 loss within 1e-3 and
    each leaf group's gradient within 5e-2 relative L2 (readings on
    ResNet20_tiny: 1.5-2.5e-2 in search, 0.8-1.1e-2 in finetune), and the
    float64 run, where no rounding flips, under the rules above."""
    jvals, jleaves, tvals, got = _loss_and_grads(facades, name, mode,
                                                 np.float32)
    _close(tvals[2], jvals[2], rtol=1e-5)
    if mode != "fp" and name in QUANTIZED_CNN and \
            abs(tvals[0] - jvals[0]) > 1e-6 * abs(jvals[0]):
        # a fake-quant rounding went the other way (see `_flip_rule`)
        _close(tvals[0], jvals[0], rtol=1e-3)
        rel = _grads_by_group(jleaves, got)
        print(f"{name} {mode}: quantizer flip, loss {tvals[0]} against "
              f"{jvals[0]}, gradient relative L2 by leaf group "
              f"{ {k: f'{v:.3g}' for k, v in rel.items()} }")
        assert max(rel.values()) < 5e-2, rel
        jvals, jleaves, tvals, got = _loss_and_grads(facades, name, mode,
                                                     np.float64)
        _close(tvals[2], jvals[2], rtol=1e-5)
    for a, b in zip(tvals[:2], jvals[:2]):
        _close(a, b, rtol=1e-6)
    # each leaf within 1e-5 of the largest gradient of the model: a leaf
    # that is one number (a scale) sums many terms that cancel
    want = [w for _, w in jleaves]
    scale = max(float(np.abs(w).max()) for w in want)
    for (path, _), g, w in zip(jleaves, got, want):
        np.testing.assert_allclose(
            g, w, rtol=0, atol=1e-5 * scale,
            err_msg=f"{name} {mode} {jax.tree_util.keystr(path)}")
