"""arctic-480b in the port against the JAX package: attention blocks whose
FFN is a MoE (128 experts top-2 at full width) beside a dense residual FFN
on the same normed input, reduced by ``reduce_for_smoke`` (2 layers,
d_model 64, 4 heads of 16, 8 experts top-2 of d_ff 64, the residual FFN
96 wide) with float32 parameters imported from the JAX package through
numpy.

Tolerances: logits within 1e-4, the bar of ``test_torch_model.py``, fp and
planned on diana (max_cout 64: the residual FFN's 96-wide inputs and the
head pinned to int8, the rest mixed; static activation scales, JAX on its
plain oracles), on the int8 KV cache, whose codes equal JAX's.  Mapping
artifacts: layer names, order, counts and assignments equal JAX's (the
expert tensors are no layers), and so are the lowered plans' kernel
histograms.  Engines: tokens, finish reasons, admitted / finished steps and
stats identical to JAX's `Engine`, dense and paged (prefix cache off under
MoE in both packages); speculation refused with JAX's message."""
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
from repro.models import transformer as JT  # noqa: E402
from repro.models.managed import matmul_backend  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch import serving as ts  # noqa: E402
from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.train import emit_static_mapping  # noqa: E402
from repro_torch.models import _backend  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "arctic-480b"
B, P, STEPS = 2, 24, 4
#: the reduced model's diana plan at max_cout 64: per repeat wq, wk, wv,
#: wo (64 wide), the router (8) and the residual FFN's down (64) mixed;
#: its gate and up (96) and the 128-wide head pinned to int8
HIST = {"quant_matmul": 5, "split_ternary": 12}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a))


_MODELS = {}


def _model(planned, tmp_path_factory):
    """(jcfg, cfg, jparams, params, jbackend, backend, JAX artifact, port
    artifact), float32, int8 KV cache; planned on diana (JAX on its plain
    oracles) or fp.  One per module."""
    if planned in _MODELS:
        return _MODELS[planned]
    jcfgbase.load_all()
    over = dict(param_dtype="float32", kv_cache_dtype="int8")
    jcfg = dataclasses.replace(
        jcfgbase.reduce_for_smoke(jcfgbase.get(ARCH)), **over)
    cfg = dataclasses.replace(cfgbase.reduce_for_smoke(cfgbase.get(ARCH)),
                              **over)
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
    _MODELS[planned] = (jcfg, cfg, jparams, params, jbackend, backend, jart,
                        art)
    return _MODELS[planned]


@pytest.fixture(scope="module", params=[False, True], ids=["fp", "diana"])
def model(request, tmp_path_factory):
    return _model(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def planned(tmp_path_factory):
    return _model(True, tmp_path_factory)


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def _prompts(vocab, n=B, length=P, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (n, length),
                                                dtype=np.int32)


# --- trees -----------------------------------------------------------------

def _same_tree(tree, jtree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert [p for p, _ in flat] == [p for p, _ in jflat]
    return flat, jflat


def test_params_tree_and_shapes_match_jax():
    """Fresh and imported params: JAX's tree (one stacked unit holding
    attention, the MoE's expert stacks and float32 router, the dense
    residual FFN and norm2), shapes and dtypes, leaf for leaf."""
    jcfgbase.load_all()
    jcfg = jcfgbase.reduce_for_smoke(jcfgbase.get(ARCH))
    cfg = cfgbase.reduce_for_smoke(cfgbase.get(ARCH))
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    fresh = T.init_lm(torch.Generator().manual_seed(0), cfg)
    imported = T.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    for tree in (fresh, imported):
        flat, jflat = _same_tree(tree, jparams)
        for (path, leaf), (_, jleaf) in zip(flat, jflat):
            assert tuple(leaf.shape) == tuple(jleaf.shape), path
            assert str(leaf.dtype).split(".")[-1] == str(jleaf.dtype), path
    unit = fresh["units"][0]
    assert sorted(unit) == ["attn", "ffn", "moe", "norm1", "norm2"]
    assert unit["moe"]["up"].shape == (2, 8, 64, 64)
    assert unit["moe"]["router"]["w"].dtype == torch.float32
    assert unit["ffn"]["up"]["w"].shape == (2, 64, 96)
    assert "first_dense" not in fresh


def test_a_moe_block_without_the_residual_has_no_norm2_as_in_jax():
    """Without ``moe_dense_residual`` JAX's block holds no ``norm2`` and
    normalises the MoE's input with ``norm1``; the port's tree and logits
    follow it."""
    jcfgbase.load_all()
    over = dict(param_dtype="float32", moe_dense_residual=False)
    jcfg = dataclasses.replace(jcfgbase.reduce_for_smoke(jcfgbase.get(ARCH)),
                               **over)
    cfg = dataclasses.replace(cfgbase.reduce_for_smoke(cfgbase.get(ARCH)),
                              **over)
    jparams = JT.init_lm(jax.random.PRNGKey(1), jcfg)
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    assert sorted(params["units"][0]) == ["attn", "moe", "norm1"]
    _same_tree(T.init_lm(torch.Generator().manual_seed(0), cfg), jparams)
    prompts = _prompts(cfg.vocab, seed=5)
    jl, _ = JT.prefill(jparams, jcfg, jnp.asarray(prompts),
                       JT.init_cache(jcfg, B, P))
    tl, _ = T.prefill(params, cfg, _t(prompts).long(),
                      T.init_cache(cfg, B, P, device="cpu"))
    _close(tl, jl)


def test_dense_residual_runs_beside_the_moe():
    """One block by hand: x + attention, then the MoE FFN and the dense
    residual FFN on the same ``norm2`` of it, summed."""
    cfg = dataclasses.replace(cfgbase.reduce_for_smoke(cfgbase.get(ARCH)),
                              param_dtype="float32")
    params = T.init_lm(torch.Generator().manual_seed(2), cfg)
    blk = T._repeat(params["units"][0], 0)
    x = torch.randn((B, 6, cfg.d_model), generator=torch.Generator()
                    .manual_seed(3))
    pos = torch.arange(6)[None, :]
    got, _, _ = T.block_apply(blk, x, "attn", cfg, pos)
    ao, _ = T.A.gqa(blk["attn"], L.norm(blk["norm1"], x), pos,
                    T._attn_cfg(cfg))
    h = x + ao
    h2 = L.norm(blk["norm2"], h)
    mo, _ = M.moe_ffn(blk["moe"], h2, cfg.moe)
    want = h + (mo + L.ffn(blk["ffn"], h2, cfg.act))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float((want - (h + mo)).abs().max()) > 1e-2


def test_cache_trees_match_jax():
    """Dense and paged cache specs, the layout markers and the batch axes:
    JAX's trees, k and v paged."""
    jcfgbase.load_all()
    jcfg = dataclasses.replace(jcfgbase.reduce_for_smoke(jcfgbase.get(ARCH)),
                               kv_cache_dtype="int8")
    cfg = dataclasses.replace(cfgbase.reduce_for_smoke(cfgbase.get(ARCH)),
                              kv_cache_dtype="int8")
    for tree, jtree in ((T.cache_specs(cfg, 3, 40),
                         JT.cache_specs(jcfg, 3, 40)),
                        (T.paged_cache_specs(cfg, 3, 9, 4),
                         JT.paged_cache_specs(jcfg, 3, 9, 4))):
        flat, jflat = _same_tree(tree, jtree)
        for (path, leaf), (_, jleaf) in zip(flat, jflat):
            assert tuple(leaf.shape) == tuple(jleaf.shape), path
            assert leaf.dtype == torch.int8, path
    assert T.cache_kv_axes(cfg) == JT.cache_kv_axes(jcfg) == {
        "units": ({"k": "page1", "v": "page1"},)}


# --- logits ----------------------------------------------------------------

def test_prefill_and_dense_decode_match_jax(model):
    """A prefill of 24 tokens (capacity dispatch over 48 tokens), then 4
    teacher-forced decode steps; the int8 KV caches equal."""
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
    for got, want in zip(T.tree_leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_with_lengths_matches_jax(model):
    """Ragged prefill: the padded tail takes no expert capacity."""
    jcfg, cfg, jparams, params, jbackend, backend, _, _ = model
    prompts = _prompts(cfg.vocab, seed=2)
    lengths = np.array([P, 13], np.int32)
    with matmul_backend(jbackend), _backend.use(backend):
        jl, _ = JT.prefill(jparams, jcfg, jnp.asarray(prompts),
                           JT.init_cache(jcfg, B, P),
                           lengths=jnp.asarray(lengths))
        tl, _ = T.prefill(params, cfg, _t(prompts).long(),
                          T.init_cache(cfg, B, P, device="cpu"),
                          lengths=_t(lengths).long())
    _close(tl, jl)


def test_prefill_chunk_and_paged_decode_match_jax(model):
    """Chunks of 8 with mixed valid counts into shuffled page tables, then
    paged decode steps with one slot masked: logits of the live rows
    within 1e-4, the int8 pools equal outside the trash page."""
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
    """Names in JAX's flatten order, counts, assignments and the lowered
    plan's histogram equal JAX's: per repeat attention's four, the dense
    residual FFN's three and the router; the expert tensors are no
    layers."""
    jcfg, cfg, jparams, params, _, _, jart, art = planned
    jd, td = jart.to_dict(), art.to_dict()
    names = [l["name"] for l in td["layers"]]
    assert names == [l["name"] for l in jd["layers"]]
    for a, b in zip(td["layers"], jd["layers"]):
        assert a["counts"] == b["counts"], a["name"]
        assert a["assignment"] == b["assignment"], a["name"]
    per_repeat = ["units/0/attn/wk", "units/0/attn/wo", "units/0/attn/wq",
                  "units/0/attn/wv", "units/0/ffn/down", "units/0/ffn/gate",
                  "units/0/ffn/up", "units/0/moe/router"]
    assert names == ["head"] + [f"{n}@{r}" for n in per_repeat
                                for r in range(2)]
    plan = rt.lower(td, params=params)
    assert plan.kernel_histogram() == HIST == \
        jrt.lower(jart, params=jparams).kernel_histogram()


# --- engines ---------------------------------------------------------------

ENGINE_STATS = ("decode_steps", "prefill_calls", "kv_capacity_bytes",
                "kv_peak_bytes", "resumes", "preemptions")
PAGED_STATS = ("kv_peak_pages", "kv_page_bytes", "prefix_lookups",
               "prefix_hit_requests", "prefix_hit_tokens", "cow_copies",
               "page_evictions")


def _trace(m, vocab):
    """Seven requests (prompts 2-20 tokens, 2-8 new), one arrival a step,
    behind a 12-token shared prompt that the prefix cache may not serve
    under MoE."""
    return m.synthetic_trace(7, vocab=vocab, min_prompt=2, max_prompt=20,
                             min_new=2, max_new=8, seed=4, arrival_every=1,
                             shared_prefix=12)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_engine_matches_jax(model, layout):
    """Tokens, finish reasons, admitted / finished steps and stats equal
    JAX's `Engine`: slots retire and refill while others decode, so the
    padded admission groups, the chunks' masked rows and the retired
    slots' decode rows all go through the MoE's masked dispatch."""
    jcfg, cfg, jparams, params, jbackend, backend, _, _ = model
    kw = dict(max_batch=3, max_len=48, page_size=4, kv_layout=layout,
              prefix_cache=True)
    jeng = js.Engine(jcfg, jparams, backend=jbackend, **kw)
    eng = ts.Engine(cfg, params, backend=backend, **kw)
    assert not eng.prefix_cache and not jeng.prefix_cache
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
    assert eng.stats.get("prefix_hit_tokens", 0) == 0


def test_speculation_is_refused_as_in_jax(planned):
    jcfg, cfg, jparams, params, jbackend, backend, _, _ = planned
    kw = dict(max_batch=2, max_len=32, kv_layout="paged",
              speculate=("draft", "target"))
    with pytest.raises(ValueError) as jerr:
        js.Engine(jcfg, jparams, backend=jbackend, **kw)
    with pytest.raises(ValueError) as err:
        ts.Engine(cfg, params, backend=backend, **kw)
    assert str(err.value) == str(jerr.value)
    assert "MoE" in str(err.value)


# --- the serve CLI ---------------------------------------------------------

def test_serve_cli_planned_batch_and_engine(tmp_path, capsys):
    """``serve --arch arctic-480b --reduce --device cpu`` on the artifact
    of the params it builds (seed 0) at full coverage, through serve_batch
    and through ``--engine`` on both layouts."""
    cfg = cfgbase.reduce_for_smoke(cfgbase.get(ARCH))
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    path = tmp_path / "m.json"
    emit_static_mapping(params, cfg, "diana", path, max_cout=64)
    tokens, _ = serve.main([
        "--arch", ARCH, "--reduce", "--device", "cpu", "--requests", "2",
        "--prompt-len", "20", "--gen-len", "4", "--mapping", str(path),
        "--require-full-coverage"])
    out = capsys.readouterr().out
    assert tuple(tokens.shape) == (2, 4)
    assert 0 <= int(tokens.min()) and int(tokens.max()) < cfg.vocab
    for want in ("per-layer planned execution", ", 0 unbound",
                 "split_ternary", "quant_matmul"):
        assert want in out, want
    for layout in ("paged", "dense"):
        serve.main(["--arch", ARCH, "--reduce", "--device", "cpu",
                    "--engine", "--requests", "4", "--prompt-len", "20",
                    "--gen-len", "4", "--max-batch", "2", "--kv-layout",
                    layout])
        out = capsys.readouterr().out
        assert "engine[continuous]" in out and "ttft p50" in out
