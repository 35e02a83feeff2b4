"""The hybrid zamba2 family in the port's serving stack against the JAX
package's, on float32 reduced zamba2 (6 + 2 blocks, d_model 64) with the
JAX package's parameters.

Mapping: the port's ``emit_static_mapping`` names, counts and
assignments equal JAX's (``units/{i}/mamba/in_proj@r``,
``rem/{i}/mamba/out_proj``, ``shared/attn/wq``), and so do the lowered
plans' kernel histograms.  Engines: the dense and the paged `Engine` on a
mixed trace give tokens, finish reasons, admitted and finished steps and
every stat of JAX's `Engine`, fp (bf16 KV) and planned on diana with static
activation scales on the int8 KV cache, as serve runs a diana artifact
(JAX on its plain oracles).  JAX's dense admission casts the first
group's Mamba2 conv carry into the KV dtype (ROADMAP Queue 3); the port
keeps the carry in the activation dtype, so the dense comparisons give
JAX's pool that carry too, and unshimmed the port's dense and paged
engines agree with JAX's paged one under int8 KV.
The prefix cache is gated off for the recurrent arch.  Speculation:
`PlanSet({"target": digital, "draft": aimc 0.05})` gives target-only's
tokens, JAX's tokens and every speculative stat of JAX's engine, with
partial accepts replayed (counted by wrapping ``Engine._replay``).  CLI:
the ``serve`` commands of ``scripts/ci_smoke.sh`` for zamba2 with
``--device cpu``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro import serving as js  # noqa: E402
from repro.configs import base as jcfgbase  # noqa: E402
from repro.launch.train import emit_static_mapping as j_emit  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch import serving as ts  # noqa: E402
from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.train import emit_static_mapping  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BIASES = {"diana": None, "target": ("digital", 1.0), "draft": ("aimc", 0.05)}


@pytest.fixture(scope="module")
def zamba(tmp_path_factory):
    """(jcfg, cfg, jparams, params, JAX artifacts, port artifacts) of
    float32 reduced zamba2: diana's min-cost split, the all-digital
    target and the 5 %-ternary draft, static activation scales."""
    tmp = tmp_path_factory.mktemp("hybrid")
    jcfgbase.load_all()
    jcfg = dataclasses.replace(
        jcfgbase.reduce_for_smoke(jcfgbase.get("zamba2-1.2b")),
        param_dtype="float32")
    cfg = dataclasses.replace(
        cfgbase.reduce_for_smoke(cfgbase.get("zamba2-1.2b")),
        param_dtype="float32")
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    jarts = {k: j_emit(jparams, jcfg, "diana", tmp / f"j_{k}.json",
                       act_log_scale=2.0, bias=b) for k, b in BIASES.items()}
    arts = {k: emit_static_mapping(params, cfg, "diana", tmp / f"{k}.json",
                                   act_log_scale=2.0, bias=b)
            for k, b in BIASES.items()}
    return jcfg, cfg, jparams, params, jarts, arts


@pytest.mark.parametrize("name", sorted(BIASES))
def test_mapping_names_counts_and_kernels_match_jax(zamba, name):
    jcfg, cfg, jparams, params, jarts, arts = zamba
    jd, td = jarts[name].to_dict(), arts[name].to_dict()
    assert [l["name"] for l in td["layers"]] == \
        [l["name"] for l in jd["layers"]]
    names = [l["name"] for l in td["layers"]]
    assert {"units/0/mamba/in_proj@0", "rem/1/mamba/out_proj",
            "shared/attn/wq", "shared/ffn/down", "head"} <= set(names)
    assert len(names) == 22
    for a, b in zip(td["layers"], jd["layers"]):
        assert a["counts"] == b["counts"], a["name"]
        assert a["assignment"] == b["assignment"], a["name"]
    hist = rt.lower(td, params=params).kernel_histogram()
    assert hist == jrt.lower(jarts[name], params=jparams).kernel_histogram()
    if name == "diana":
        assert hist == {"split_ternary": 22}


def _tokens(results):
    return {r.rid: [int(t) for t in r.tokens] for r in results}


def _trace(m, vocab, **kw):
    """A mixed trace: prompts 3-29 tokens, 2-8 new, two arrivals a step."""
    rng = np.random.default_rng(kw.pop("seed", 1))
    return [m.Request(rid=i, prompt=rng.integers(0, vocab, int(
        rng.integers(3, 30))).astype(np.int32),
        max_new_tokens=int(rng.integers(2, 9)), arrival_step=i // 2)
        for i in range(kw.pop("n", 7))]


ENGINE_STATS = ("decode_steps", "prefill_calls", "kv_capacity_bytes",
                "kv_peak_bytes", "resumes", "preemptions")
PAGED_STATS = ("kv_peak_pages", "kv_page_bytes", "prefix_lookups",
               "prefix_hit_requests", "prefix_hit_tokens", "cow_copies",
               "page_evictions")


def _activation_dtype_carry(monkeypatch, jcfg):
    """Route around a quirk of the reference (ROADMAP Queue 3): JAX's
    dense engine scatters its first admission group's Mamba2 conv carry
    into a pool leaf of the KV dtype, which truncates it (the model
    returns the carry in the activation dtype, and later groups land in
    the leaf that the first decode step re-typed).  Give that pool the
    activation dtype's carry from the start, as the port holds it."""
    init = JT.init_cache

    def init_cache(cfg, B, S_max):
        return jax.tree_util.tree_map_with_path(
            lambda path, leaf: leaf.astype(jcfg.param_dtype)
            if getattr(path[-1], "key", None) == "conv" else leaf,
            init(cfg, B, S_max))
    monkeypatch.setattr(JT, "init_cache", init_cache)


def _engines(zamba, layout, planned, kv):
    """JAX and port engines of one configuration (fresh per test)."""
    jcfg, cfg, jparams, params, jarts, _ = zamba
    jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv)
    cfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
    jbackend = backend = None
    if planned:
        art = jarts["diana"]
        jbackend = jrt.PlannedBackend(jrt.lower(art, params=jparams),
                                      jparams, reference=True)
        backend = rt.PlannedBackend(rt.lower(art.to_dict(), params=params),
                                    params)
    kw = dict(max_batch=3, max_len=48, page_size=4, kv_layout=layout)
    return (js.Engine(jcfg, jparams, backend=jbackend, **kw),
            ts.Engine(cfg, params, backend=backend, **kw))


@pytest.mark.parametrize("layout,planned,kv", [
    ("dense", False, "bfloat16"), ("dense", True, "int8"),
    ("paged", False, "bfloat16"), ("paged", True, "int8")],
    ids=["dense-fp", "dense-diana-int8", "paged-fp", "paged-diana-int8"])
def test_engine_matches_jax(zamba, layout, planned, kv, monkeypatch):
    """Tokens, finish reasons, admitted / finished steps and the engine's
    stats identical to JAX's `Engine` on a mixed trace: slots retire and
    refill while others decode (dense: ragged group prefills scattered
    into the pool, JAX's pool holding the conv carry in the activation
    dtype as the port's does; paged: chunks of 8 carrying the recurrent
    state, and each admitted slot's state zeroed)."""
    if layout == "dense":
        _activation_dtype_carry(monkeypatch, zamba[0])
    jeng, eng = _engines(zamba, layout, planned, kv)
    cfg = zamba[1]
    jres = jeng.run(_trace(js, cfg.vocab))
    res = eng.run(_trace(ts, cfg.vocab))
    assert eng._has_recurrent and jeng._has_recurrent
    for a, b in zip(res, jres):
        assert (a.rid, a.tokens, a.finish_reason, a.admitted_step,
                a.finished_step) == (b.rid, [int(t) for t in b.tokens],
                                     b.finish_reason, b.admitted_step,
                                     b.finished_step)
    keys = ENGINE_STATS + (PAGED_STATS if layout == "paged" else ())
    for key in keys:
        assert eng.stats[key] == jeng.stats[key], key


def test_dense_and_paged_agree_under_int8_kv(zamba):
    """The port holds the conv carry in the activation dtype in both
    layouts, so under the int8 KV cache its dense engine gives the paged
    engines' tokens (JAX's paged engine's too), where JAX's dense engine
    casts the first admission group's carry to int8 at its scatter."""
    jpaged, paged = _engines(zamba, "paged", True, "int8")
    _, dense = _engines(zamba, "dense", True, "int8")
    vocab = zamba[1].vocab
    want = _tokens(jpaged.run(_trace(js, vocab)))
    assert _tokens(paged.run(_trace(ts, vocab))) == want
    assert _tokens(dense.run(_trace(ts, vocab))) == want


def test_prefix_cache_is_gated_off_for_recurrent_state(zamba):
    """Recurrent state is not page-resident, so a shared prompt prefix
    must not be served from cache: the engine turns the prefix cache off
    (both packages), and a shared-prefix trace gives JAX's tokens with no
    prefix hit."""
    jcfg, cfg, jparams, params, _, _ = zamba
    kw = dict(max_batch=2, max_len=64, page_size=4, kv_layout="paged",
              prefix_cache=True)
    jeng = js.Engine(jcfg, jparams, **kw)
    eng = ts.Engine(cfg, params, **kw)
    assert not eng.prefix_cache and not jeng.prefix_cache
    trace = dict(n=4, vocab=cfg.vocab, seed=2, min_prompt=4, max_prompt=8,
                 min_new=2, max_new=4, shared_prefix=12)
    jres = jeng.run(js.synthetic_trace(**trace))
    res = eng.run(ts.synthetic_trace(**trace))
    assert _tokens(res) == _tokens(jres)
    assert eng.stats["prefix_hit_tokens"] == 0 == \
        jeng.stats["prefix_hit_tokens"]


def test_fault_paths_walk_every_cache_leaf(zamba):
    """The engine's page corruption (fault injection) and KV accounting
    address the cache by `cache_kv_axes`, not by ``caches["units"]``
    alone: a corrupted page is NaN in the shared block's k / v and nowhere
    in the recurrent state, which the KV bytes leave out."""
    _, cfg, _, params, _, _ = zamba
    eng = ts.Engine(cfg, params, max_batch=2, max_len=16, page_size=4)
    caches = T.init_paged_cache(cfg, 2, eng.num_pages + 1, 4, "cpu")
    for leaf in T.tree_leaves(caches):
        leaf.fill_(1)
    eng._corrupt_pages(caches, [3])
    for leaf, ax in zip(T.tree_leaves(caches),
                        T.tree_leaves(eng._kv_axes)):
        if ax.startswith("page"):
            assert bool(leaf[:, 3].isnan().all())
            assert not bool(leaf[:, 2].isnan().any())
        else:
            assert not bool(leaf.isnan().any())
    assert eng._kv_capacity_bytes == 2 * 4 * 2 * cfg.n_kv_heads * cfg.hd \
        * eng.num_pages                  # k and v bf16, one use, no state


_SPEC_TRACE = dict(n=4, seed=3, min_prompt=4, max_prompt=10, min_new=4,
                   max_new=10)


def test_speculative_replay_matches_target_only_and_jax(zamba):
    """The JAX package's hybrid template: a 5 %-ternary draft accepts
    part of its tokens, so rounds replay the committed tokens over the
    restored recurrent state.  Tokens equal target-only's and JAX's, every
    speculative stat equals JAX's, and replays ran."""
    jcfg, cfg, jparams, params, jarts, _ = zamba
    variants = {v: jarts[v] for v in ("target", "draft")}
    jbank = jrt.PlanSet({v: jrt.lower(a, params=jparams)
                         for v, a in variants.items()}, jparams,
                        default="target", reference=True)
    bank = rt.PlanSet({v: rt.lower(a.to_dict(), params=params)
                       for v, a in variants.items()}, params,
                      default="target")
    kw = dict(_SPEC_TRACE)
    n = kw.pop("n")
    eng = dict(max_batch=2, max_len=64, kv_layout="paged")
    jspec = js.Engine(jcfg, jparams, backend=jbank,
                      speculate=("draft", "target"), draft_k=4, **eng)
    spec = ts.Engine(cfg, params, backend=bank,
                     speculate=("draft", "target"), draft_k=4, **eng)
    replays = []
    replay = spec._replay

    def counting(x, drafted, caches, snap, valid):
        replays.append(valid.copy())
        return replay(x, drafted, caches, snap, valid)
    spec._replay = counting
    ref = ts.Engine(cfg, params, backend=bank, **eng)
    got = _tokens(spec.run(ts.synthetic_trace(n, vocab=cfg.vocab, **kw)))
    want = _tokens(ref.run(ts.synthetic_trace(n, vocab=cfg.vocab, **kw)))
    jgot = _tokens(jspec.run(js.synthetic_trace(n, vocab=cfg.vocab, **kw)))
    assert got == want == jgot
    st, jst = spec.stats, jspec.stats
    for key in ("spec_rounds", "spec_drafted", "spec_accepted",
                "spec_committed", "spec_acceptance", "spec_tokens_per_round",
                "decode_steps", "prefill_calls"):
        assert st[key] == jst[key], key
    assert 0 < st["spec_acceptance"] < 1
    assert replays and all(0 < v.max() <= 4 for v in replays)


# --- the serve CLI ---------------------------------------------------------

@pytest.fixture(scope="module")
def cli_mappings(tmp_path_factory):
    """Artifacts of the params ``serve --arch zamba2-1.2b --reduce --seed
    0 --device cpu`` builds (bf16): diana's split, the digital target and
    the 5 %-ternary draft (static scales), as ``scripts/ci_smoke.sh``'s
    train steps emit them."""
    tmp = tmp_path_factory.mktemp("cli")
    cfg = cfgbase.reduce_for_smoke(cfgbase.get("zamba2-1.2b"))
    params = T.init_lm(torch.Generator().manual_seed(0), cfg)
    out = {}
    for name, bias, act in (("mapping", None, None),
                            ("spec_target", ("digital", 1.0), 2.0),
                            ("spec_draft", ("aimc", 0.05), 2.0)):
        out[name] = tmp / f"{name}.json"
        emit_static_mapping(params, cfg, "diana", out[name],
                            act_log_scale=act, bias=bias)
    return out


ARGS = ["--arch", "zamba2-1.2b", "--reduce", "--device", "cpu"]


def test_serve_cli_planned_batch(cli_mappings, capsys):
    tokens, _ = serve.main(ARGS + [
        "--requests", "2", "--prompt-len", "16", "--gen-len", "4",
        "--mapping", str(cli_mappings["mapping"]),
        "--require-full-coverage"])
    out = capsys.readouterr().out
    assert tuple(tokens.shape) == (2, 4)
    for want in ("per-layer planned execution", ", 0 unbound",
                 "kernel histogram:", "split_ternary"):
        assert want in out, want


def test_serve_cli_engine(cli_mappings, capsys):
    serve.main(ARGS + [
        "--engine", "--requests", "4", "--prompt-len", "12", "--gen-len",
        "4", "--max-batch", "2", "--mapping", str(cli_mappings["mapping"]),
        "--require-full-coverage"])
    out = capsys.readouterr().out
    for want in ("engine[continuous]", "ttft p50", "paged kv:"):
        assert want in out, want


def test_serve_cli_speculative_bank(cli_mappings, capsys):
    serve.main(ARGS + [
        "--engine", "--requests", "4", "--prompt-len", "12", "--gen-len",
        "8", "--max-batch", "2",
        "--mapping", str(cli_mappings["spec_target"]),
        "--speculate", str(cli_mappings["spec_draft"]), "--draft-k", "4",
        "--check-spec-parity", "--require-full-coverage"])
    out = capsys.readouterr().out
    assert "planset bank:" in out
    assert "spec tokens identical to target-only: True" in out
    acc = out.split("acceptance=")[1].split()[0]
    assert float(acc) > 0, acc
