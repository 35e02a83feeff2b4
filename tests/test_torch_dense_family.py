"""The rest of the dense LM family in the port against the JAX package:
h2o-danube-3-4b (sliding window, head dim 120 at full width), nemotron-4-15b
(LayerNorm with a bias, squared-ReLU ungated FFN) and command-r-35b
(LayerNorm, attention and FFN in parallel, the head tied to the embedding).
Each runs reduced by ``reduce_for_smoke`` (d_model 64, head dim 16, two
layers; h2o's window 16) with float32 parameters imported from the JAX
package through numpy.

Tolerances: LayerNorm and the ungated FFN within 1e-6 (float32, the same
operations in the same order).  Logits within 1e-4, the bar of
``test_torch_model.py``: fp on the int8 KV cache (the bf16 cache turns a
last-bit difference of the two frameworks' float32 matmuls into a bf16
step, see there) and planned on diana with static activation scales, both
on the int8 cache.  h2o's prompts run past its 16-token window, so the
window masks keys at prefill, in chunks and at decode; its long prefill
(Sq 2560 in a 3072-slot cache) takes the chunked path in both packages.
Engines: tokens, finish reasons, admitted / finished steps and stats
identical to JAX's `Engine`, planned on diana, dense and paged with the
prefix cache on (the JAX package's gate: ``"attn"`` is prefix-safe)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro import serving as js  # noqa: E402
from repro.configs import base as jcfgbase  # noqa: E402
from repro.launch.train import emit_static_mapping as j_emit  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.managed import matmul_backend  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch import serving as ts  # noqa: E402
from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.train import emit_static_mapping  # noqa: E402
from repro_torch.models import _backend  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCHS = ["h2o-danube-3-4b", "nemotron-4-15b", "command-r-35b"]
#: each reduced arch's diana plan at max_cout 64: the 64-wide projections
#: searched, the 128-wide FFN inputs and the head pinned to int8
HISTS = {"h2o-danube-3-4b": {"quant_matmul": 5, "split_ternary": 10},
         "nemotron-4-15b": {"quant_matmul": 3, "split_ternary": 10},
         "command-r-35b": {"quant_matmul": 4, "split_ternary": 10}}
B, P, STEPS = 2, 24, 4


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a))


_MODELS = {}


def _model(arch, planned, tmp_path_factory):
    """(jcfg, cfg, jparams, params, jbackend, backend, JAX artifact, port
    artifact) of reduced ``arch``, float32, int8 KV cache; planned on
    diana (JAX on its plain oracles) or fp.  One per module."""
    key = (arch, planned)
    if key in _MODELS:
        return _MODELS[key]
    jcfgbase.load_all()
    over = dict(param_dtype="float32", kv_cache_dtype="int8")
    jcfg = dataclasses.replace(
        jcfgbase.reduce_for_smoke(jcfgbase.get(arch)), **over)
    cfg = dataclasses.replace(
        cfgbase.reduce_for_smoke(cfgbase.get(arch)), **over)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    jbackend = backend = jart = art = None
    if planned:
        tmp = tmp_path_factory.mktemp("artifact")
        jart = j_emit(jparams, jcfg, "diana", tmp / "j.json", max_cout=64,
                      act_log_scale=2.0)
        art = emit_static_mapping(params, cfg, "diana", tmp / "t.json",
                                  max_cout=64, act_log_scale=2.0)
        jbackend = jrt.PlannedBackend(jrt.lower(jart, params=jparams),
                                      jparams, reference=True)
        backend = rt.PlannedBackend(rt.lower(art.to_dict(), params=params),
                                    params)
        assert not backend.unbound
    _MODELS[key] = (jcfg, cfg, jparams, params, jbackend, backend, jart,
                    art)
    return _MODELS[key]


@pytest.fixture(scope="module", params=[(a, p) for a in ARCHS
                                        for p in (False, True)],
                ids=[f"{a}-{'diana' if p else 'fp'}" for a in ARCHS
                     for p in (False, True)])
def model(request, tmp_path_factory):
    return _model(*request.param, tmp_path_factory)


@pytest.fixture(scope="module", params=ARCHS)
def planned(request, tmp_path_factory):
    return _model(request.param, True, tmp_path_factory)


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


# --- layers ----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_norm_matches_jax(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64), dtype=np.float32) * 2 + 0.5
    jp = JL.init_norm(64, jnp.float32, kind)
    p = L.init_norm(64, torch.float32, kind=kind)
    assert sorted(p) == sorted(jp)
    for leaf in p:     # a trained scale and bias, not ones and zeros
        draw = rng.standard_normal(64, dtype=np.float32)
        jp[leaf] = jnp.asarray(draw)
        p[leaf] = _t(draw)
    _close(L.norm(p, _t(x), kind), JL.norm(jp, jnp.asarray(x), kind), 1e-6)


def test_ungated_relu2_ffn_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 64), dtype=np.float32)
    jp = JL.init_ffn(jax.random.PRNGKey(3), 64, 128, False, jnp.float32)
    p = T.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    assert sorted(p) == ["down", "up"]
    _close(L.ffn(p, _t(x), "relu2"), JL.ffn(jp, jnp.asarray(x), "relu2"),
           1e-6)


# --- params ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_tree_and_shapes_match_jax(arch):
    jcfgbase.load_all()
    jcfg = jcfgbase.reduce_for_smoke(jcfgbase.get(arch))
    cfg = cfgbase.reduce_for_smoke(cfgbase.get(arch))
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    fresh = T.init_lm(torch.Generator().manual_seed(0), cfg)
    imported = T.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for tree in (fresh, imported):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert [p for p, _ in flat] == [p for p, _ in jflat]
        for (path, leaf), (_, jleaf) in zip(flat, jflat):
            assert tuple(leaf.shape) == tuple(jleaf.shape), path
            assert str(leaf.dtype).split(".")[-1] == str(jleaf.dtype), path
    assert ("head" in fresh) == (not cfg.tie_embeddings)
    unit = fresh["units"][0]
    assert ("norm2" in unit) == (not cfg.parallel_block)
    assert ("bias" in unit["norm1"]) == (cfg.norm == "layernorm")
    assert ("gate" in unit["ffn"]) == cfg.gated_ffn


def test_init_check_refuses_only_the_families_still_missing():
    cfg = cfgbase.reduce_for_smoke(cfgbase.get("yi-9b"))
    for over in (dict(norm="layernorm"), dict(parallel_block=True),
                 dict(tie_embeddings=True), dict(sliding_window=8)):
        T.init_lm(torch.Generator().manual_seed(0),
                  dataclasses.replace(cfg, **over))
    # every pattern of known block kinds runs (tests/test_torch_patterns.py
    # holds two against JAX); only a kind JAX does not know is refused
    T.init_lm(torch.Generator().manual_seed(0),
              dataclasses.replace(cfg, pattern=("mlstm", "slstm")))
    with pytest.raises(ValueError, match="unknown block kind"):
        T.init_lm(torch.Generator().manual_seed(0),
                  dataclasses.replace(cfg, pattern=("attn", "ffn")))


# --- logits ----------------------------------------------------------------

def _prompts(vocab, n=B, length=P, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (n, length),
                                                dtype=np.int32)


def test_prefill_and_dense_decode_match_jax(model):
    """A prefill of 24 tokens, then 4 teacher-forced dense decode steps:
    h2o's window (16) masks the first keys of every later row."""
    jcfg, cfg, jparams, params, jbackend, backend, _, _ = model
    prompts = _prompts(cfg.vocab)
    jc = JT.init_cache(jcfg, B, P + STEPS)
    tc = T.init_cache(cfg, B, P + STEPS, device="cpu")
    with matmul_backend(jbackend), _backend.use(backend):
        jl, jc = JT.prefill(jparams, jcfg, jnp.asarray(prompts), jc)
        tl, tc = T.prefill(params, cfg, _t(prompts).long(), tc)
        _close(tl, jl)
        for i in range(STEPS):
            tok = np.argmax(np.asarray(jl), -1)
            jl, jc = JT.decode_step(jparams, jcfg, jnp.asarray(tok), jc,
                                    P + i)
            tl, tc = T.decode_step(params, cfg, _t(tok), tc, P + i)
            _close(tl, jl)


def test_prefill_with_lengths_matches_jax(model):
    jcfg, cfg, jparams, params, jbackend, backend, _, _ = model
    prompts = _prompts(cfg.vocab, seed=2)
    lengths = np.array([P, 17], np.int32)
    with matmul_backend(jbackend), _backend.use(backend):
        jl, _ = JT.prefill(jparams, jcfg, jnp.asarray(prompts),
                           JT.init_cache(jcfg, B, P),
                           lengths=jnp.asarray(lengths))
        tl, _ = T.prefill(params, cfg, _t(prompts).long(),
                          T.init_cache(cfg, B, P, device="cpu"),
                          lengths=_t(lengths).long())
    _close(tl, jl)


def test_prefill_chunk_and_paged_decode_match_jax(model):
    """Chunks of 8 with mixed valid counts (0 for a slot that is idle or
    decoding) into shuffled page tables, then paged decode steps with one
    slot masked: logits of the live rows within 1e-4, the int8 pools
    equal outside the trash page.  Slot 0 reaches 26 tokens, past h2o's
    window."""
    jcfg, cfg, jparams, params, jbackend, backend, _, _ = model
    rng = np.random.default_rng(3)
    Bc, C, ps, W = 3, 8, 4, 8
    rows = 1 + 20
    pages = np.zeros((Bc, W), np.int32)
    perm = rng.permutation(np.arange(1, rows))
    pages[0, :7], pages[1, :3], pages[2, :5] = perm[:7], perm[7:10], \
        perm[10:15]
    jcaches = JT.init_paged_cache(jcfg, Bc, rows, ps)
    caches = T.init_paged_cache(cfg, Bc, rows, ps, device="cpu")
    steps = [("chunk", [0, 0, 0], [8, 5, 0]), ("chunk", [8, 5, 0], [8, 0, 8]),
             ("chunk", [16, 5, 8], [8, 0, 6]),
             ("decode", [24, 5, 14], [1, 1, 0]),
             ("decode", [25, 6, 14], [1, 0, 1])]
    with matmul_backend(jbackend), _backend.use(backend):
        for kind, index, live in steps:
            index = np.array(index)
            if kind == "chunk":
                tokens = rng.integers(0, cfg.vocab, (Bc, C))
                jl, jcaches = JT.prefill_chunk(
                    jparams, jcfg, jnp.asarray(tokens, jnp.int32), jcaches,
                    jnp.asarray(index, jnp.int32),
                    jnp.asarray(live, jnp.int32), jnp.asarray(pages))
                tl, caches = T.prefill_chunk(
                    params, cfg, _t(tokens), caches, _t(index),
                    torch.tensor(live), _t(pages).long())
            else:
                token = rng.integers(0, cfg.vocab, Bc)
                act = np.array(live, bool)
                jl, jcaches = JT.decode_step(
                    jparams, jcfg, jnp.asarray(token, jnp.int32), jcaches,
                    jnp.asarray(index, jnp.int32), active=jnp.asarray(act),
                    pages=jnp.asarray(pages))
                tl, caches = T.decode_step(
                    params, cfg, _t(token), caches, _t(index),
                    active=_t(act), pages=_t(pages).long())
            live_rows = np.nonzero(np.array(live))[0]
            _close(tl[live_rows], np.asarray(jl)[live_rows])
            for key in ("k", "v"):
                np.testing.assert_array_equal(
                    caches["units"][0][key][:, 1:].numpy(),
                    np.asarray(jcaches["units"][0][key])[:, 1:])


# --- mapping artifacts -----------------------------------------------------

def test_mapping_names_counts_and_plans_match_jax(planned):
    """Names, counts, assignments and the lowered plans of the port's
    emission equal JAX's: LayerNorm biases are no layers, command-r's tied
    head emits none."""
    jcfg, cfg, jparams, params, _, _, jart, art = planned
    jd, td = jart.to_dict(), art.to_dict()
    names = [l["name"] for l in td["layers"]]
    assert names == [l["name"] for l in jd["layers"]]
    for a, b in zip(td["layers"], jd["layers"]):
        assert a["counts"] == b["counts"], a["name"]
        assert a["assignment"] == b["assignment"], a["name"]
    assert ("head" in names) == (not cfg.tie_embeddings)
    assert not any("norm" in n for n in names)
    per_layer = 6 if cfg.gated_ffn else 5
    assert len(names) == cfg.n_layers * (per_layer + 1) + \
        (0 if cfg.tie_embeddings else 1)
    plan = rt.lower(td, params=params)
    assert plan.kernel_histogram() == HISTS[cfg.name] == \
        jrt.lower(jart, params=jparams).kernel_histogram()


# --- engines ---------------------------------------------------------------

ENGINE_STATS = ("decode_steps", "prefill_calls", "kv_capacity_bytes",
                "kv_peak_bytes", "resumes", "preemptions")
PAGED_STATS = ("kv_peak_pages", "kv_page_bytes", "prefix_lookups",
               "prefix_hit_requests", "prefix_hit_tokens", "cow_copies",
               "page_evictions")


def _trace(m, vocab):
    """Seven requests behind one 12-token system prompt (prompts 14-32
    tokens, past h2o's window), 2-8 new tokens, one arrival a step."""
    return m.synthetic_trace(7, vocab=vocab, min_prompt=2, max_prompt=20,
                             min_new=2, max_new=8, seed=4, arrival_every=1,
                             shared_prefix=12)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_engine_matches_jax(planned, layout):
    jcfg, cfg, jparams, params, jbackend, backend, _, _ = planned
    kw = dict(max_batch=3, max_len=48, page_size=4, kv_layout=layout)
    jeng = js.Engine(jcfg, jparams, backend=jbackend, **kw)
    eng = ts.Engine(cfg, params, backend=backend, **kw)
    if layout == "paged":
        assert eng.prefix_cache and jeng.prefix_cache
    jres = jeng.run(_trace(js, cfg.vocab))
    res = eng.run(_trace(ts, cfg.vocab))
    assert len(res) == len(jres) == 7
    for a, b in zip(res, jres):
        assert (a.rid, a.tokens, a.finish_reason, a.admitted_step,
                a.finished_step) == (b.rid, [int(t) for t in b.tokens],
                                     b.finish_reason, b.admitted_step,
                                     b.finished_step)
    keys = ENGINE_STATS + (PAGED_STATS if layout == "paged" else ())
    for key in keys:
        assert eng.stats[key] == jeng.stats[key], key
    if layout == "paged":
        assert eng.stats["prefix_hit_tokens"] > 0


# --- h2o's long prefill ----------------------------------------------------

PROMPT, CACHE = 2560, 3072


@pytest.mark.parametrize("fp", [False, True], ids=["diana", "fp"])
def test_h2o_long_prefill_takes_the_windowed_chunked_path(fp, monkeypatch,
                                                         tmp_path_factory):
    """Sq 2560 in a 3072-slot cache: both packages take the chunked path
    (Sq > 2048), whose window of 16 leaves each row 16 of its 2560 keys.
    Planned logits within 1e-4; fp within 5e-4, the bar of
    ``test_torch_attention.py``'s long prefill on the int8 cache (the
    float32 projections round into the cache a code apart now and
    then)."""
    jcfg, cfg, jparams, params, jbackend, backend, _, _ = _model(
        "h2o-danube-3-4b", not fp, tmp_path_factory)
    windows = []

    def counting(*args, **kw):
        windows.append(kw.get("window"))
        return chunked(*args, **kw)
    chunked = A.chunked_attention
    monkeypatch.setattr(A, "chunked_attention", counting)
    jcalls = []
    jchunked = JA.chunked_attention

    def jcounting(*args, **kw):
        jcalls.append(kw.get("window"))
        return jchunked(*args, **kw)
    monkeypatch.setattr(JA, "chunked_attention", jcounting)
    prompts = _prompts(cfg.vocab, n=1, length=PROMPT, seed=5)
    with matmul_backend(jbackend), _backend.use(backend):
        jl, _ = JT.prefill(jparams, jcfg, jnp.asarray(prompts),
                           JT.init_cache(jcfg, 1, CACHE))
        tl, _ = T.prefill(params, cfg, _t(prompts).long(),
                          T.init_cache(cfg, 1, CACHE, device="cpu"))
    assert windows == [16] * cfg.n_layers
    # JAX traces its layer scan's body once
    assert jcalls and set(jcalls) == {16}
    _close(tl, jl, 5e-4 if fp else 1e-4)


# --- the serve CLI ---------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_planned_batch(arch, tmp_path, capsys):
    """``serve --arch <arch> --reduce --device cpu`` on the artifact of the
    params it builds (seed 0), at full coverage."""
    cfg = cfgbase.reduce_for_smoke(cfgbase.get(arch))
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    path = tmp_path / "m.json"
    emit_static_mapping(params, cfg, "diana", path, max_cout=64)
    tokens, stats = serve.main([
        "--arch", arch, "--reduce", "--device", "cpu", "--requests", "2",
        "--prompt-len", "20", "--gen-len", "4", "--mapping", str(path),
        "--require-full-coverage"])
    out = capsys.readouterr().out
    assert tuple(tokens.shape) == (2, 4)
    assert 0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab
    for want in ("per-layer planned execution", ", 0 unbound",
                 "split_ternary"):
        assert want in out, want


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_engine(arch, capsys):
    serve.main(["--arch", arch, "--reduce", "--device", "cpu", "--engine",
                "--requests", "4", "--prompt-len", "20", "--gen-len", "4",
                "--max-batch", "2", "--shared-prefix", "8"])
    out = capsys.readouterr().out
    for want in ("engine[continuous]", "ttft p50", "paged kv:"):
        assert want in out, want
