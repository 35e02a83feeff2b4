"""The port's training path against the JAX package's, on the CPU.

``lm_loss`` of every reduced arch (float32, the port's parameters given
to both packages, numpy batches) within 1e-5 relative (xlstm 5e-4, the
tolerance of its chunked form in ``tests/test_ssm.py``); the gradients of
yi-9b, zamba2, deepseek (the MoE aux included) and seamless (the encoder)
against ``jax.grad``, a leaf passing when ``max|d| <= 1e-4 * max|g_jax| +
1e-6``; above 2048 tokens (the chunked attention) likewise.  ``remat``
changes nothing, bit for bit; `chunked_ce` equals a full log-softmax
cross-entropy and JAX's.  The trainer: ``main`` (with and without int8
gradient compression) on JAX's token batches and parameters against JAX's
``main`` for 5 steps within 1e-4 relative; a resume bit-identical to an
uninterrupted run; ``train_cnn`` on JAX's image batches against JAX's,
its emitted mapping's names and counts equal; the CLI's device and flag
rules, and ``python -m repro_torch.launch.train``."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jcfgbase  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import cnn as JC  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.checkpoint import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import cnn as C  # noqa: E402
from repro_torch.models import transformer as TR  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["yi-9b", "h2o-danube-3-4b", "nemotron-4-15b", "command-r-35b",
         "zamba2-1.2b", "xlstm-1.3b", "deepseek-v2-lite-16b", "arctic-480b",
         "llama-3.2-vision-11b", "seamless-m4t-large-v2"]
#: lm_loss relative tolerance: float32 sums in another order; xlstm's
#: chunked mLSTM divides by a clamped denominator that amplifies last-bit
#: differences (its prefill parity tests hold 5e-4)
LOSS_RTOL = {"xlstm-1.3b": 5e-4}
GRAD_ARCHS = ["yi-9b", "zamba2-1.2b", "deepseek-v2-lite-16b",
              "seamless-m4t-large-v2"]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(arch):
    jcfgbase.load_all()
    f32 = dict(param_dtype="float32")
    return (dataclasses.replace(jcfgbase.reduce_for_smoke(jcfgbase.get(arch)),
                                **f32),
            dataclasses.replace(cfgbase.reduce_for_smoke(cfgbase.get(arch)),
                                **f32))


def _to_jax(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), tree)


def _model(arch, S=32, B=2, seed=0):
    """(jcfg, cfg, JAX params, port params, JAX batch, port batch): the
    port's float32 init (llama's cross gates set to 0.5: JAX's init 0
    would leave the frontend unread), numpy tokens and frontend rows."""
    jcfg, cfg = _cfgs(arch)
    params = TR.init_lm(torch.Generator().manual_seed(seed), cfg)
    if "cross" in cfg.pattern:
        params["units"][cfg.pattern.index("cross")]["gate"].fill_(0.5)
    rng = np.random.default_rng(seed)
    tok, tgt = (rng.integers(0, cfg.vocab, (B, S)) for _ in range(2))
    jb = {"tokens": jnp.asarray(tok, jnp.int32),
          "targets": jnp.asarray(tgt, jnp.int32)}
    tb = {"tokens": torch.from_numpy(tok), "targets": torch.from_numpy(tgt)}
    if cfg.frontend:
        fe = rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model))
        jb["frontend"] = jnp.asarray(fe, jnp.float32)
        tb["frontend"] = torch.from_numpy(fe.astype(np.float32))
    return jcfg, cfg, _to_jax(params), params, jb, tb


def _grads_close(got, want):
    gl, wl = T.leaves(got), jax.tree_util.tree_leaves_with_path(want)
    assert len(gl) == len(wl)
    for g, (path, w) in zip(gl, wl):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * float(np.abs(w).max()) + 1e-6, \
            jax.tree_util.keystr(path)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in GRAD_ARCHS])
def test_lm_loss_matches_jax(arch):
    """The archs whose gradients are not compared (that test holds the
    others' losses)."""
    jcfg, cfg, jp, p, jb, tb = _model(arch)
    want = float(jax.jit(lambda q, b: JT.lm_loss(q, jcfg, b))(jp, jb))
    with torch.no_grad():
        got = float(TR.lm_loss(p, cfg, tb))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL.get(arch, 1e-5))


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_jax(arch):
    jcfg, cfg, jp, p, jb, tb = _model(arch)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda q, b: JT.lm_loss(q, jcfg, b)))(jp, jb)
    loss, grads = train.value_and_grad(lambda q: TR.lm_loss(q, cfg, tb), p)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _grads_close(grads, jg)
    if cfg.moe is not None:       # the aux is in the loss, as in JAX
        x = p["emb"][tb["tokens"]]
        pos = torch.arange(x.shape[1])[None, :]
        with torch.no_grad():
            aux = float(TR.backbone(p, cfg, x, pos)[2])
        jaux = float(JT.backbone(jp, jcfg, jp["emb"][jb["tokens"]],
                                 jnp.asarray(pos.numpy()))[2])
        assert aux > 0.5
        np.testing.assert_allclose(aux, jaux, rtol=1e-6)
    if cfg.encoder_layers:        # the encoder is reached
        assert all(bool(g.ne(0).any()) for g in T.leaves(grads["enc_units"]))


def test_lm_loss_past_2048_tokens_matches_jax():
    """Sq 3072 takes the chunked attention in both packages (on the CPU
    the port's is the differentiable plain version)."""
    jcfg, cfg, jp, p, jb, tb = _model("yi-9b", S=3072, B=1)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda q, b: JT.lm_loss(q, jcfg, b)))(jp, jb)
    loss, grads = train.value_and_grad(lambda q: TR.lm_loss(q, cfg, tb), p)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _grads_close(grads, jg)


def test_remat_changes_nothing():
    _, cfg, _, p, _, tb = _model("zamba2-1.2b", S=40)
    l0, g0 = train.value_and_grad(lambda q: TR.lm_loss(q, cfg, tb), p)
    l1, g1 = train.value_and_grad(
        lambda q: TR.lm_loss(q, cfg, tb, remat=True), p)
    assert float(l0) == float(l1)
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(g0), T.leaves(g1)))


def test_ssd_gradient_stays_finite_where_jax_is_nan():
    """Mamba2's chunked SSD over 300 steps with dt in [0.5, 1.5): a
    chunk's decay exp(ca_t - ca_s) overflows float32 above the diagonal.
    JAX masks it after the exp, so its gradient is NaN (the reason
    full-width zamba2 trains only in the port); the port masks the
    exponent: its forward within 1e-4 of JAX's, its float32 gradient
    finite and within 1e-4 of the largest float64 one."""
    from repro.models import ssm as JS
    from repro_torch.models import ssm as S
    rng = np.random.default_rng(0)
    xs, bt, ct = (rng.standard_normal(s).astype(np.float32)
                  for s in ((1, 300, 2, 4), (1, 300, 3), (1, 300, 3)))
    dt = (0.5 + rng.random((1, 300, 2))).astype(np.float32)
    h0 = np.zeros((1, 2, 4, 3), np.float32)

    def jloss(*a):
        h, y = JS._ssd_chunked(*a, jnp.asarray(h0))
        return jnp.sum(y * y) + jnp.sum(h)
    ins = (xs, bt, ct, dt, -dt)
    jg = jax.grad(jloss, argnums=tuple(range(5)))(*map(jnp.asarray, ins))
    assert np.isnan(np.asarray(jg[4])).any()
    _, jy = JS._ssd_chunked(*map(jnp.asarray, ins + (h0,)))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        ts = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in ins]
        h, y = S._ssd_chunked(*ts, torch.from_numpy(h0).to(dtype))
        if dtype == torch.float32:
            np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                                       rtol=1e-4, atol=1e-4)
        grads[dtype] = torch.autograd.grad((y * y).sum() + h.sum(), ts)
    for g, ref in zip(grads[torch.float32], grads[torch.float64]):
        assert bool(torch.isfinite(g).all())
        assert float((g.double() - ref).abs().max()) <= \
            1e-4 * float(ref.abs().max())


def test_chunked_ce_matches_full_cross_entropy_and_jax():
    """1100 positions: two chunks of 512, the last 76 left out (JAX's
    rule); against a float32 ``F.cross_entropy`` over the first 1024
    positions and JAX's `chunked_ce`, within 1e-6."""
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, 1100, 16)).astype(np.float32)
    w = rng.standard_normal((16, 50)).astype(np.float32)
    t = rng.integers(0, 50, (2, 1100))
    got = float(TR.chunked_ce(torch.from_numpy(h), torch.from_numpy(w),
                              torch.from_numpy(t)))
    full = torch.nn.functional.cross_entropy(
        (torch.from_numpy(h[:, :1024]) @ torch.from_numpy(w)).reshape(-1, 50),
        torch.from_numpy(t[:, :1024]).reshape(-1))
    want = JT.chunked_ce(jnp.asarray(h), jnp.asarray(w), jnp.asarray(t))
    np.testing.assert_allclose(got, float(full), rtol=1e-6)
    np.testing.assert_allclose(got, float(want), rtol=1e-6)


# --------------------------------------------------------------- trainer

ARGS = ["--arch", "yi-9b", "--reduce", "--steps", "5", "--batch", "2",
        "--seq", "16", "--warmup", "2", "--log-every", "1"]


@pytest.fixture
def float32_reduce(monkeypatch):
    """Both packages' ``--reduce`` configs in float32 (bfloat16 rounds
    differently in the two frameworks)."""
    for mod in (jcfgbase, cfgbase):
        orig = mod.reduce_for_smoke
        monkeypatch.setattr(mod, "reduce_for_smoke", lambda c, _o=orig:
                            dataclasses.replace(_o(c), param_dtype="float32"))


@pytest.mark.parametrize("compress", [False, True])
def test_main_matches_jax_on_its_batches(float32_reduce, monkeypatch,
                                         compress):
    """The port's ``main`` on JAX's parameters and token batches: its 5
    losses within 1e-4 relative of JAX's ``main``."""
    flags = ARGS + (["--compress-grads"] if compress else [])
    want = jtrain.main(flags)
    jcfg = jcfgbase.reduce_for_smoke(jcfgbase.get("yi-9b"))
    jp = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    monkeypatch.setattr(TR, "init_lm", lambda gen, cfg: TR.params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu"))

    class Loader:
        def __init__(self, kind, cfg, batch, seq_len, device):
            self.j = jdata.ShardedLoader(kind, jdata.TokenTaskConfig(
                vocab=cfg.vocab), batch=batch, seq_len=seq_len)

        def get(self, step):
            return tuple(torch.from_numpy(np.asarray(a, np.int64))
                         for a in self.j.get(step))
    monkeypatch.setattr(train, "ShardedLoader", Loader)
    got = train.main(flags + ["--device", "cpu"])
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_resume_is_bit_identical(tmp_path, capsys):
    """4 steps in one run, and 2 steps, a checkpoint, then ``--resume``
    to 4: the same losses and the same step-4 checkpoint, leaf hash for
    leaf hash; the warmup covers the first run's steps, so its learning
    rates do not depend on its length."""
    base = ["--arch", "zamba2-1.2b", "--reduce", "--batch", "2", "--seq",
            "24", "--warmup", "2", "--device", "cpu", "--ckpt-every", "100"]
    whole = train.main(base + ["--steps", "4", "--ckpt-dir",
                               str(tmp_path / "a")])
    first = train.main(base + ["--steps", "2", "--ckpt-dir",
                               str(tmp_path / "b")])
    rest = train.main(base + ["--steps", "4", "--ckpt-dir",
                              str(tmp_path / "b"), "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert first + rest == whole
    manifests = [json.loads((tmp_path / d / "step_00000004" /
                             "manifest.json").read_text()) for d in "ab"]
    assert manifests[0]["hashes"] == manifests[1]["hashes"]
    assert ckpt.restore_extra(tmp_path / "b", 4) == {"step": 4}


def test_train_cnn_matches_jax_on_its_batches(monkeypatch, tmp_path):
    """``train_cnn`` on resnet20_tiny from JAX's parameters on JAX's image
    batches: 6 losses within 1e-4 relative of JAX's, and the emitted
    mappings' layer names and counts equal."""
    flags = ["--arch", "cnn:resnet20_tiny", "--steps", "6", "--batch", "16",
             "--warmup", "2", "--lr", "1e-3", "--platform", "diana"]
    want = jtrain.main(flags + ["--emit-mapping", str(tmp_path / "j.json")])
    jcfg = JC.get_config("resnet20_tiny")
    jinit, _, _ = JC.get_model(jcfg)
    jp = jinit(jax.random.PRNGKey(0), jcfg, None)
    init, apply, plan = C.get_model(C.get_config("resnet20_tiny"))
    monkeypatch.setattr(C, "get_model", lambda cfg: (
        lambda gen, c: TR.params_from_jax(jax.tree.map(np.asarray, jp),
                                          "cpu"), apply, plan))
    from repro_torch.data import pipeline as tdata

    def batch(task, step, n, device):
        x, y = jdata.image_batch(jdata.ImageTaskConfig(
            n_classes=task.n_classes, img_hw=task.img_hw), step, n)
        return torch.from_numpy(np.asarray(x)), \
            torch.from_numpy(np.asarray(y, np.int64))
    monkeypatch.setattr(tdata, "image_batch", batch)
    got = train.main(flags + ["--emit-mapping", str(tmp_path / "t.json"),
                              "--device", "cpu"])
    np.testing.assert_allclose(got, want, rtol=1e-4)
    arts = [json.loads((tmp_path / f"{w}.json").read_text())["layers"]
            for w in "jt"]
    assert [(a["name"], a["counts"]) for a in arts[0]] == \
        [(a["name"], a["counts"]) for a in arts[1]]


def test_cli_device_and_flag_rules(monkeypatch):
    """Without CUDA the trainer refuses the default ``--device cuda``
    (exit 2) and never falls back; a bias needs ``--emit-mapping``; an
    unknown platform fails before training."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (ARGS, ARGS + ["--mapping-bias", "aimc", "--device", "cpu"]):
        with pytest.raises(SystemExit) as e:
            train.main(argv)
        assert e.value.code == 2
    with pytest.raises(KeyError):
        train.main(ARGS + ["--emit-mapping", "m.json", "--platform", "nope",
                           "--device", "cpu"])


def test_python_m_launch_train(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "yi-9b",
         "--reduce", "--steps", "2", "--batch", "2", "--seq", "16",
         "--device", "cpu", "--emit-mapping", str(tmp_path / "m.json"),
         "--platform", "diana"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[train] done." in out.stdout
    assert (tmp_path / "m.json").exists()
