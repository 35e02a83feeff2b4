"""The port's training substrate against the JAX package's, on the CPU:
the token task (its permutation bit for bit; the stream deterministic in
(step, shard), targets the tokens shifted by one, ~10 % corruption) and
`ShardedLoader` (deterministic, resharding); AdamW with weight decay,
clipping and bfloat16 moments on JAX's gradients (float32 state within
1e-6, bfloat16 moments bit for bit); int8 gradient compression (codes,
scales and residuals bit for bit over several steps, error feedback
converging, 4x fewer bytes); `ElasticPlan` and `TrainSupervisor` (crash /
restart, the non-finite skip) against JAX's; and the lowering CLI
(``python -m repro_torch.runtime``): its lines and its saved plan equal
JAX's ``lower.main`` on the same artifact, ``--arch`` validating against
shape-only params, exit 2 on a `LoweringError`."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as jdata  # noqa: E402
from repro.distributed import fault_tolerance as jft  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.runtime.lower import main as jlower_main  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.data.pipeline import (ShardedLoader,  # noqa: E402
                                       TokenTaskConfig, token_batch,
                                       token_permutation)
from repro_torch.distributed import fault_tolerance as ft  # noqa: E402
from repro_torch.optim import adamw, compression  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- data

def test_token_permutation_is_jax_bit_for_bit():
    """JAX's stream follows the same permutation: every uncorrupted step
    of its batch is ``perm[x_t]``."""
    cfg = TokenTaskConfig(vocab=97)
    perm = token_permutation(cfg)
    np.testing.assert_array_equal(
        perm, np.random.default_rng(cfg.seed).permutation(cfg.vocab))
    tok, tgt = (np.asarray(a) for a in jdata.token_batch(
        jdata.TokenTaskConfig(vocab=97), 3, 8, 64))
    follows = perm[tok] == tgt
    assert 0.8 < follows.mean() < 0.98


def test_token_stream_deterministic_and_shifted():
    cfg = TokenTaskConfig(vocab=97)
    a1, b1 = token_batch(cfg, 5, 8, 256, device="cpu")
    a2, b2 = token_batch(cfg, 5, 8, 256, device="cpu")
    assert torch.equal(a1, a2) and torch.equal(b1, b2)
    assert a1.shape == b1.shape == (8, 256) and a1.dtype == torch.int64
    assert torch.equal(a1[:, 1:], b1[:, :-1])
    a3, _ = token_batch(cfg, 6, 8, 256, device="cpu")
    a4, _ = token_batch(cfg, 5, 8, 256, shard=1, device="cpu")
    assert not torch.equal(a1, a3) and not torch.equal(a1, a4)
    perm = torch.from_numpy(token_permutation(cfg))
    corrupt = (perm[a1] != b1).double().mean()
    assert 0.05 < float(corrupt) < 0.15


def test_sharded_loader_deterministic_and_resharding():
    cfg = TokenTaskConfig(vocab=97)
    ld = ShardedLoader("token", cfg, batch=8, seq_len=16, shard=0,
                       n_shards=2, device="cpu")
    x0, _ = ld.get(5)
    assert x0.shape == (4, 16) and torch.equal(x0, ld.get(5)[0])
    ld.reshard(shard=1, n_shards=4)
    x1, _ = ld.get(5)
    assert x1.shape == (2, 16)
    assert torch.equal(x1, token_batch(cfg, 5, 2, 16, 1, 4, device="cpu")[0])
    from repro_torch.data.pipeline import ImageTaskConfig
    img = ShardedLoader("image", ImageTaskConfig(n_classes=4, img_hw=(8, 8)),
                        batch=8, device="cpu")
    x, y = img.get(0)
    assert x.shape == (8, 8, 8, 3) and y.shape == (8,)


# ---------------------------------------------------------------- optimizer

def _params():
    rng = np.random.default_rng(0)
    return {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": [rng.standard_normal(4).astype(np.float32)]}


def _bf16(tree, keys=("b",)):
    """Leaves under ``keys`` in bfloat16 (numpy float32 in, torch out)."""
    return {k: T.tree_map(lambda a: torch.from_numpy(a).to(
        torch.bfloat16 if k in keys else torch.float32), v)
        for k, v in tree.items()}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_weight_decay_and_moments_match_jax(moments):
    """AdamW with decay 0.1, clipping at 0.5, a bfloat16 leaf, on JAX's
    gradients over 4 steps: params and state within 1e-6 (the global
    norm's float32 sum runs in another order), bfloat16 moments bit for
    bit."""
    md = getattr(torch, moments)
    cfg = adamw.AdamWConfig(lr=1e-2, weight_decay=0.1, clip_norm=0.5,
                            moment_dtype=md)
    jcfg = jadamw.AdamWConfig(lr=1e-2, weight_decay=0.1, clip_norm=0.5,
                              moment_dtype=getattr(jnp, moments))
    p = _bf16(_params())
    jp = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), p)
    st, jst = adamw.init(p, cfg), jadamw.init(jp, jcfg)
    rng = np.random.default_rng(1)
    for _ in range(4):
        jg = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
            x.shape), x.dtype), jp)
        g = jax.tree.map(lambda x: torch.from_numpy(np.asarray(
            x, np.float32)).to(torch.bfloat16 if x.dtype == jnp.bfloat16
                               else torch.float32), jg)
        p, st, gn = adamw.update(g, st, p, cfg)
        jp, jst, jgn = jadamw.update(jg, jst, jp, jcfg)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
    for a, b in zip(T.leaves((p, st)), jax.tree.leaves((jp, jst))):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), atol=1e-6)
    if moments == "bfloat16":
        for a, b in zip(T.leaves((st.mu, st.nu)),
                        jax.tree.leaves((jst.mu, jst.nu))):
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))


def test_adamw_defaults_and_no_clipping():
    """The defaults are JAX's; ``clip_norm=None`` reports the norm and
    leaves the gradient unscaled."""
    for f in ("lr", "b1", "b2", "eps", "weight_decay", "clip_norm"):
        assert getattr(adamw.AdamWConfig(), f) == \
            getattr(jadamw.AdamWConfig(), f)
    cfg = adamw.AdamWConfig(lr=0.1, clip_norm=None)
    params = {"x": torch.tensor(5.0)}
    state = adamw.init(params, cfg)
    for _ in range(200):
        grads = {"x": 2 * (params["x"] - 2.0)}
        params, state, gn = adamw.update(grads, state, params, cfg)
    assert abs(float(params["x"]) - 2.0) < 1e-2


# ------------------------------------------------------------- compression

def test_compression_bit_for_bit_with_jax():
    """Codes, scales and residuals over 4 steps of fresh gradients (a
    bfloat16 leaf, a zero leaf) equal JAX's bit for bit."""
    rng = np.random.default_rng(2)
    shapes = {"w": (40, 7), "b": (13,), "z": (3,)}
    res = compression.init_residual(
        {k: torch.zeros(s) for k, s in shapes.items()})
    jres = jcomp.init_residual({k: jnp.zeros(s) for k, s in shapes.items()})
    for _ in range(4):
        g = {k: (rng.standard_normal(s) * 3).astype(np.float32)
             for k, s in shapes.items()}
        g["z"][:] = 0
        tg = _bf16(g)
        jg = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), tg)
        comp, res = compression.compress_with_feedback(tg, res)
        jc, jres = jcomp.compress_with_feedback(jg, jres)
        got = T.leaves(comp, is_leaf=lambda x: isinstance(
            x, compression.Q8))
        want = jax.tree_util.tree_leaves(jc, is_leaf=lambda x: isinstance(
            x, jcomp.Q8))
        for q, jq in zip(got, want):
            np.testing.assert_array_equal(q.codes.numpy(),
                                          np.asarray(jq.codes))
            assert float(q.scale) == float(jq.scale)
        for a, b in zip(T.leaves(res), jax.tree.leaves(jres)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(T.leaves(compression.decompress(comp)),
                        jax.tree.leaves(jcomp.decompress(jc))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert compression.compressed_bytes(comp) == \
            jcomp.compressed_bytes(jc)


def test_compression_error_feedback_converges():
    x = torch.tensor([5.0, -3.0])
    residual = {"x": torch.zeros(2)}
    for _ in range(300):
        g = {"x": 2 * (x - torch.tensor([1.0, 2.0]))}
        comp, residual = compression.compress_with_feedback(g, residual)
        x = x - 0.05 * compression.decompress(comp)["x"]
    np.testing.assert_allclose(x.numpy(), [1.0, 2.0], atol=5e-2)


def test_compression_is_4x_smaller():
    g = {"w": torch.ones((256, 256))}
    comp, _ = compression.compress_with_feedback(
        g, compression.init_residual(g))
    assert compression.compressed_bytes(comp) < 256 * 256 * 4 / 3.5


# ------------------------------------------------------------ fault tolerance

def test_elastic_plan_matches_jax():
    for shape, hosts, cph in (((16, 16), 48, 4), ((8, 1), 1, 4),
                              ((2, 4), 2, 4), ((4, 8), 1, 4)):
        p = ft.ElasticPlan(old_shape=shape, new_hosts=hosts,
                           chips_per_host=cph)
        jp = jft.ElasticPlan(old_shape=shape, new_hosts=hosts,
                             chips_per_host=cph)
        assert p.propose() == jp.propose()
        assert p.needs_reshard == jp.needs_reshard
    assert ft.ElasticPlan((16, 16), 48).propose() == (12, 16)


def _supervise(mod, crash_at=None, nan_at=()):
    store = {}

    def save_fn(step, state):
        store["ckpt"] = (step, state)

    def restore_fn():
        return store.get("ckpt", (0, 0.0))

    def step_fn(state, step):
        gn = float("nan") if step in nan_at else 1.0
        return state + 1.0, {"grad_norm": gn}
    sup = mod.TrainSupervisor(step_fn, save_fn, restore_fn, ckpt_every=10,
                              inject_crash_at=crash_at)
    final = sup.run(40)
    return final, [(e["event"], e["step"]) for e in sup.log
                   if e["event"] in ("crash", "skip_nonfinite")], store


@pytest.mark.parametrize("crash_at,nan_at", [(25, ()), (None, (3, 17)),
                                             (12, (4, 30))])
def test_supervisor_crash_restart_and_nonfinite_skip_match_jax(crash_at,
                                                               nan_at):
    """A crash restarts from the last committed step and replays; a
    non-finite step keeps the old state: final step, state, events and
    the last checkpoint equal JAX's supervisor's."""
    got = _supervise(ft, crash_at, nan_at)
    want = _supervise(jft, crash_at, nan_at)
    assert got == want
    (final, state), events, _ = got
    assert final == 40
    assert ("crash", crash_at) in events or crash_at is None
    assert state == 40.0 - len(nan_at)


def test_supervisor_gives_up_after_too_many_nonfinite_steps():
    sup = ft.TrainSupervisor(lambda s, i: (s, {"grad_norm": float("inf")}),
                             lambda *a: None, lambda: (0, 0), max_bad_steps=2)
    with pytest.raises(RuntimeError, match="too many"):
        sup.run(10)


# ------------------------------------------------------------ lowering CLI

@pytest.fixture(scope="module")
def zamba_artifact(tmp_path_factory):
    """A diana artifact of reduced zamba2 (min-cost split, static
    activation scales), emitted from the port's parameters."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.launch.train import emit_static_mapping
    from repro_torch.models import transformer as TR
    cfg = cfgbase.reduce_for_smoke(cfgbase.get("zamba2-1.2b"))
    params = TR.init_lm(torch.Generator().manual_seed(0), cfg)
    path = tmp_path_factory.mktemp("lower") / "m.json"
    emit_static_mapping(params, cfg, "diana", path, act_log_scale=2.0)
    return path


@pytest.mark.parametrize("flags", [[], ["--arch", "zamba2-1.2b", "--reduce"],
                                   ["--block-n", "16", "--strict"]])
def test_lower_cli_matches_jax(zamba_artifact, tmp_path, capsys, flags):
    from repro_torch.runtime.lower import main
    main([str(zamba_artifact), "--out", str(tmp_path / "t.json")] + flags)
    got = capsys.readouterr().out.replace(str(tmp_path / "t.json"), "OUT")
    jlower_main([str(zamba_artifact), "--out", str(tmp_path / "j.json")] +
                flags)
    want = capsys.readouterr().out.replace(str(tmp_path / "j.json"), "OUT")
    assert got == want and "[lower] wrote OUT" in got
    assert json.loads((tmp_path / "t.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())


def test_lower_cli_refuses_a_foreign_artifact(zamba_artifact, capsys):
    """An artifact lowered against another arch's shapes: exit 2 and
    JAX's error line."""
    from repro_torch.runtime.lower import main
    argv = [str(zamba_artifact), "--arch", "yi-9b", "--reduce"]
    with pytest.raises(SystemExit) as e:
        main(argv)
    got = capsys.readouterr().err
    with pytest.raises(SystemExit) as je:
        jlower_main(argv)
    assert e.value.code == je.value.code == 2
    assert got == capsys.readouterr().err and got.startswith(
        "[lower] ERROR:")


def test_python_m_runtime(zamba_artifact, tmp_path):
    import os
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.runtime", str(zamba_artifact),
         "--arch", "zamba2-1.2b", "--reduce", "--out",
         str(tmp_path / "p.json")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("[lower] ") and (tmp_path / "p.json").exists()
