"""The port's precision bank (``repro_torch.runtime.PlanSet``) and the
engine features on it -- self-speculative decoding and SLO routing --
against the JAX package's ``repro.runtime.PlanSet`` and ``repro.serving
.Engine`` on the same numpy inputs: reduced yi-9b with float32 parameters
carried across by ``T.params_from_jax``, diana artifacts with static
activation scales (``act_log_scale=2.0``), the JAX banks on the plain
oracles (``reference=True``).

Dedup: ``shared_layers()`` names the same layers and variants as JAX's
for identical, divergent and fully divergent banks; the bytes are the
port's own (K padded to 16, the split kernels' N to 16), held against its
own sum over unique storages.  Speculation gives target-only tokens
exactly and the JAX engine's tokens and counts; SLO routing the JAX
engine's tokens, per-request variants and ``by_slo``.  The hybrid
(recurrent) replay of the JAX package waits for the hybrid archs."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import runtime as jrt  # noqa: E402
from repro import serving as js  # noqa: E402
from repro.api import MappingArtifact  # noqa: E402
from repro.configs import base as jcfgbase  # noqa: E402
from repro.launch.train import emit_static_mapping as j_emit  # noqa: E402
from repro.models import _backend as j_backend  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.managed import matmul_backend  # noqa: E402
from repro_torch import runtime as rt  # noqa: E402
from repro_torch import serving as ts  # noqa: E402
from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import _backend  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def yi(tmp_path_factory):
    """(jcfg, cfg, jparams, params, artifacts): reduced yi-9b in float32
    (bf16 KV cache, the default), and diana artifacts with static scales:
    the all-digital target, the all-ternary ("aimc", 1.0) and a ternary-
    tinted ("aimc", 0.05) draft; and the card's bank at reduced width
    (``max_cout=64`` pins the 5 widest layers to quant_matmul): diana
    (split_ternary on the other 10) and diana_ternary (ternary_matmul)."""
    tmp = tmp_path_factory.mktemp("planset")
    jcfgbase.load_all()
    over = dict(param_dtype="float32")
    jcfg = dataclasses.replace(
        jcfgbase.reduce_for_smoke(jcfgbase.get("yi-9b")), **over)
    cfg = dataclasses.replace(
        cfgbase.reduce_for_smoke(cfgbase.get("yi-9b")), **over)
    jparams = JT.init_lm(jax.random.PRNGKey(0), jcfg)
    params = T.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    arts = {name: j_emit(jparams, jcfg, "diana", tmp / f"{name}.json",
                         act_log_scale=2.0, bias=bias)
            for name, bias in (("target", ("digital", 1.0)),
                               ("ternary", ("aimc", 1.0)),
                               ("tinted", ("aimc", 0.05)))}
    for name, bias in (("diana", None), ("diana_ternary", ("aimc", 1.0))):
        arts[name] = j_emit(jparams, jcfg, "diana", tmp / f"{name}.json",
                            max_cout=64, act_log_scale=2.0, bias=bias)
    return jcfg, cfg, jparams, params, arts


def _flip_layer(art, layer_name, domain=1):
    """A copy of ``art`` with one layer's channels forced to ``domain``:
    the minimal divergent variant (every other layer coincides)."""
    doc = art.to_dict()
    for layer in doc["layers"]:
        if layer["name"] == layer_name:
            n = len(layer["assignment"])
            layer["assignment"] = [domain] * n
            layer["counts"] = [n if d == domain else 0
                               for d in range(len(doc["domains"]))]
    return MappingArtifact.from_dict(doc)


def _banks(yi, variants, default):
    """The JAX bank (plain oracles) and the port's over the same
    artifacts: ``variants`` {name: MappingArtifact}."""
    _, _, jparams, params, _ = yi
    jbank = jrt.PlanSet({v: jrt.lower(a, params=jparams)
                         for v, a in variants.items()}, jparams,
                        default=default, reference=True)
    bank = rt.PlanSet({v: rt.lower(a.to_dict(), params=params)
                       for v, a in variants.items()}, params,
                      default=default)
    return jbank, bank


def _tokens(results):
    return {r.rid: [int(t) for t in r.tokens] for r in results}


def _both_traces(**kw):
    return (js.synthetic_trace(**kw), ts.synthetic_trace(**kw))


# --------------------------------------------------------------------------
# dedup accounting
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["identical", "divergent", "fully",
                                  "card"])
def test_shared_layers_match_jax(yi, kind):
    """The bank shares the layers JAX's shares; its bytes hold the port's
    own arithmetic: identical variants cost one bind, divergent ones
    strictly less than two binds, fully divergent ones share nothing, and
    the card's bank shares its pinned quant_matmul layers."""
    _, _, _, params, arts = yi
    target = arts["diana" if kind == "card" else "target"]
    other = {"identical": target,
             "divergent": _flip_layer(target, "head"),
             "fully": arts["ternary"],
             "card": arts["diana_ternary"]}[kind]
    jbank, bank = _banks(yi, {"target": target, "draft": other}, "target")
    assert bank.shared_layers() == jbank.shared_layers()
    assert bank.fully_covered and bank.coverage_diff() == {}
    rep = bank.memory_report()
    single = rt.PlannedBackend(rt.lower(target.to_dict(), params=params),
                               params)
    alone = rt.PlannedBackend(rt.lower(other.to_dict(), params=params),
                              params)
    two_binds = single.prepared_bytes() + alone.prepared_bytes()
    assert rep["variants"] == {"target": single.prepared_bytes(),
                               "draft": alone.prepared_bytes()}
    assert rep["sum_variant_bytes"] == two_binds
    assert rep["dedup_saved_bytes"] == two_binds - rep["prepared_bytes"]
    entries = len(bank.variant("target").by_name)
    if kind == "identical":
        assert rep["prepared_bytes"] == single.prepared_bytes()
        assert len(rep["shared_layers"]) == entries
    elif kind == "divergent":
        assert "head" not in rep["shared_layers"]
        assert len(rep["shared_layers"]) == entries - 1
        assert 0 < rep["prepared_bytes"] < two_binds
    elif kind == "fully":
        assert rep["shared_layers"] == {} and rep["dedup_saved_bytes"] == 0
    else:
        shared = set(rep["shared_layers"])
        pinned = {lp.name.partition("@")[0]
                  for lp in bank.variant("target").plan.layers
                  if lp.kernel == "quant_matmul"}
        assert shared == pinned and rep["dedup_saved_bytes"] > 0


def test_prepared_nbytes_counts_unique_storages(yi):
    """A layer's K-major ``w_q`` is a view of its own (N, K) copy and the
    bias is the params' own tensor: each storage counts once, however
    many fields or entries hold it."""
    _, _, _, params, arts = yi
    backend = rt.PlannedBackend(rt.lower(arts["target"].to_dict(),
                                         params=params), params)
    preps = [p for e in backend._by_name.values()
             for p in (e if isinstance(e, list) else [e])]
    storages = {}
    for p in preps:
        for f in ("inv", "w_perm", "b", "w_q", "sw", "w_bf16", "w_t_packed",
                  "act_scale", "act_sx"):
            t = getattr(p, f)
            if t is not None:
                s = t.untyped_storage()
                storages[s.data_ptr()] = s.nbytes()
    assert backend.prepared_bytes() == sum(storages.values())
    assert rt.prepared_nbytes(preps + preps) == sum(storages.values())
    q = next(p for p in preps if p.w_q is not None)
    assert q.w_q.untyped_storage().nbytes() == q.w_q.numel()


# --------------------------------------------------------------------------
# variant selection + coverage
# --------------------------------------------------------------------------

def test_variant_selection_matches_single_plan_bind_and_jax(yi):
    """The draft variant under the bank gives the draft plan's single
    bind's logits exactly, and the JAX bank's within 1e-5; the default is
    the target; ``plan_variant`` publishes the same key."""
    jcfg, cfg, jparams, params, arts = yi
    jbank, bank = _banks(yi, {"target": arts["target"],
                              "draft": arts["ternary"]}, "target")
    draft_only = rt.PlannedBackend(rt.lower(arts["ternary"].to_dict(),
                                            params=params), params)
    tokens = np.arange(12, dtype=np.int32).reshape(1, 12) % cfg.vocab

    def logits(backend, variant):
        with _backend.use(backend):
            out, _ = T.prefill(params, cfg, torch.from_numpy(tokens).long(),
                               T.init_cache(cfg, 1, 16, device="cpu"),
                               variant=variant)
        return out.numpy()

    def jlogits(variant):
        with matmul_backend(jbank):
            out, _ = JT.prefill(jparams, jcfg, jnp.asarray(tokens),
                                JT.init_cache(jcfg, 1, 16), variant=variant)
        return np.asarray(out)

    draft = logits(bank, "draft")
    np.testing.assert_array_equal(draft, logits(draft_only, None))
    assert not np.array_equal(logits(bank, None), draft)
    with _backend.plan_variant("draft"):
        np.testing.assert_array_equal(logits(bank, None), draft)
    for variant in ("draft", "target"):
        np.testing.assert_allclose(logits(bank, variant), jlogits(variant),
                                   rtol=0, atol=1e-5)


def test_coverage_diff_names_layers_like_jax(yi):
    """A variant lowered without params from an artifact naming a layer
    the params lack leaves that layer unbound on that variant only: the
    diff names it, as JAX's does."""
    _, _, _, _, arts = yi
    target = arts["target"]
    doc = target.to_dict()
    kept = doc["layers"][0]["name"]
    doc["layers"] = [l for l in doc["layers"] if l["name"] == kept]
    jbank, bank = _banks(yi, {"full": target,
                              "partial": MappingArtifact.from_dict(doc)},
                         "full")
    assert bank.coverage_diff() == jbank.coverage_diff() == {}
    assert bank.coverage() == jbank.coverage()
    doc = target.to_dict()
    doc["layers"][0] = dict(doc["layers"][0], name="units/9/no_such")
    ghost = MappingArtifact.from_dict(doc)
    _, _, jparams, params, _ = yi
    jbank = jrt.PlanSet({"full": jrt.lower(target, params=jparams),
                         "ghost": jrt.lower(ghost)}, jparams, default="full")
    bank = rt.PlanSet({"full": rt.lower(target.to_dict(), params=params),
                       "ghost": rt.lower(ghost.to_dict())}, params,
                      default="full")
    assert bank.coverage_diff() == jbank.coverage_diff() == \
        {"ghost": ["units/9/no_such"]}
    assert not bank.fully_covered and not jbank.fully_covered
    assert bank.coverage() == jbank.coverage()


def test_unknown_variant_error_matches_jax(yi):
    _, _, _, _, arts = yi
    jbank, bank = _banks(yi, {"only": arts["target"]}, None)
    with j_backend.plan_variant("nope"), \
            pytest.raises(jrt.ExecutionError) as want:
        jbank("head", None, None)
    with _backend.plan_variant("nope"), \
            pytest.raises(rt.ExecutionError) as got:
        bank("head", None, None)
    assert str(got.value) == str(want.value)


def test_prefill_chunk_full_logits_matches_jax(yi):
    """``full_logits=True``: the logits at every chunk position, (B, C,
    V), under the selected variant, as JAX's; the last valid row is the
    default return."""
    jcfg, cfg, jparams, params, arts = yi
    jbank, bank = _banks(yi, {"target": arts["target"],
                              "draft": arts["tinted"]}, "target")
    B, C, ps, W = 2, 5, 4, 4
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (B, C)).astype(np.int32)
    index = np.array([0, 3], np.int32)
    valid = np.array([5, 4], np.int32)
    pages = np.array([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)
    with matmul_backend(jbank):
        want, _ = JT.prefill_chunk(
            jparams, jcfg, jnp.asarray(tokens),
            JT.init_paged_cache(jcfg, B, 1 + B * W, ps), jnp.asarray(index),
            jnp.asarray(valid), jnp.asarray(pages), variant="draft",
            full_logits=True)
    t = lambda a: torch.from_numpy(a).long()
    with _backend.use(bank):
        got, _ = T.prefill_chunk(
            params, cfg, t(tokens),
            T.init_paged_cache(cfg, B, 1 + B * W, ps, device="cpu"),
            t(index), t(valid), t(pages), variant="draft", full_logits=True)
        last, _ = T.prefill_chunk(
            params, cfg, t(tokens),
            T.init_paged_cache(cfg, B, 1 + B * W, ps, device="cpu"),
            t(index), t(valid), t(pages), variant="draft")
    assert tuple(got.shape) == (B, C, cfg.vocab)
    for b in range(B):
        v = int(valid[b])
        np.testing.assert_allclose(got[b, :v].numpy(),
                                   np.asarray(want)[b, :v], rtol=0,
                                   atol=1e-4)
        assert torch.equal(got[b, v - 1], last[b])


# --------------------------------------------------------------------------
# self-speculative decoding
# --------------------------------------------------------------------------

_SPEC_TRACE = dict(n=4, seed=3, min_prompt=4, max_prompt=10, min_new=4,
                   max_new=10)


def _spec_runs(yi, draft, draft_k):
    """(port spec engine, port spec tokens, port target-only tokens, JAX
    spec engine, JAX spec tokens)."""
    jcfg, cfg, jparams, params, arts = yi
    jbank, bank = _banks(yi, {"target": arts["target"], "draft": draft},
                         "target")
    kw = dict(_SPEC_TRACE)
    jtrace, trace = _both_traces(n=kw.pop("n"), vocab=cfg.vocab, **kw)
    eng = dict(max_batch=2, max_len=64, kv_layout="paged")
    spec = ts.Engine(cfg, params, backend=bank,
                     speculate=("draft", "target"), draft_k=draft_k, **eng)
    jspec = js.Engine(jcfg, jparams, backend=jbank,
                      speculate=("draft", "target"), draft_k=draft_k, **eng)
    ref = ts.Engine(cfg, params, backend=bank, **eng)
    return (spec, _tokens(spec.run(trace)), _tokens(ref.run(trace)), jspec,
            _tokens(jspec.run(jtrace)))


@pytest.mark.parametrize("draft,draft_k", [("tinted", 4), ("ternary", 2),
                                           ("ternary", 4)])
def test_speculative_tokens_equal_target_only_and_jax(yi, draft, draft_k):
    """A divergent draft still gives target-only tokens exactly;
    acceptance only sets the speed.  Tokens and every speculative count
    equal the JAX engine's."""
    spec, got, want, jspec, jgot = _spec_runs(yi, yi[4][draft], draft_k)
    assert got == want == jgot
    st, jst = spec.stats, jspec.stats
    assert st["spec_rounds"] > 0 and 0 <= st["spec_acceptance"] <= 1.0
    for key in ("spec_rounds", "spec_drafted", "spec_accepted",
                "spec_committed", "spec_acceptance", "spec_tokens_per_round",
                "decode_steps", "prefill_calls"):
        assert st[key] == jst[key], key
    assert st["spec_committed"] == sum(len(t) - 1 for t in got.values())


def test_speculative_identical_draft_accepts_everything(yi):
    spec, got, want, jspec, jgot = _spec_runs(yi, yi[4]["target"], 4)
    assert got == want == jgot
    assert spec.stats["spec_acceptance"] == 1.0
    assert spec.stats["spec_tokens_per_round"] > 1.0
    assert spec.stats["spec_tokens_per_round"] == \
        jspec.stats["spec_tokens_per_round"]


def test_speculative_round_launches_per_variant(yi, monkeypatch):
    """Each round makes k draft decode steps under the draft variant and
    one verify chunk under the target: quant_matmul 5 (k + 1), the draft's
    ternary_matmul 10 k, the target's split_ternary 10 per round on the
    reduced model (its 5 pinned and 10 wk / wv layers)."""
    _, cfg, _, params, arts = yi
    _, bank = _banks(yi, {"target": arts["diana"],
                          "draft": arts["diana_ternary"]}, "target")
    hist = {v: bank.variant(v).plan.kernel_histogram()
            for v in ("target", "draft")}
    assert hist == {"target": {"quant_matmul": 5, "split_ternary": 10},
                    "draft": {"quant_matmul": 5, "ternary_matmul": 10}}
    counts = dict.fromkeys(("quant_matmul", "ternary_matmul",
                            "split_ternary"), 0)
    for name in counts:
        orig = getattr(ops, f"{name}_op")

        def counting(*a, _orig=orig, _name=name, **kw):
            counts[_name] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(ops, f"{name}_op", counting)
    k = 3
    req = ts.Request(rid=0, prompt=np.arange(6) % cfg.vocab,
                     max_new_tokens=9)
    eng = ts.Engine(cfg, params, max_batch=2, max_len=64, backend=bank,
                    speculate=("draft", "target"), draft_k=k)
    eng.run([req])
    chunks, rounds = eng.stats["prefill_calls"], eng.stats["spec_rounds"]
    assert rounds == eng.stats["decode_steps"] > 0
    assert counts == {"quant_matmul": 5 * (chunks + rounds * (k + 1)),
                      "ternary_matmul": 10 * k * rounds,
                      "split_ternary": 10 * (chunks + rounds)}


# --------------------------------------------------------------------------
# SLO routing
# --------------------------------------------------------------------------

def test_slo_routing_matches_jax_and_each_request_alone(yi):
    """Routed requests get their class's variant with the numbers of
    serving them alone under it; tokens, per-request variants, steps and
    ``by_slo`` (latencies aside) equal the JAX engine's."""
    jcfg, cfg, jparams, params, arts = yi
    variants = {"default": arts["target"], "cheap": arts["ternary"]}
    jbank, bank = _banks(yi, variants, "default")
    routes = {"interactive": "cheap", "batch": "default"}
    jtrace, trace = _both_traces(n=4, vocab=cfg.vocab, seed=5, min_prompt=4,
                                 max_prompt=8, min_new=3, max_new=6,
                                 slo_classes=["batch", "interactive"])
    eng = ts.Engine(cfg, params, max_batch=2, max_len=64, backend=bank,
                    slo_routes=routes)
    jeng = js.Engine(jcfg, jparams, max_batch=2, max_len=64, backend=jbank,
                     slo_routes=routes)
    assert not eng.prefix_cache and not jeng.prefix_cache
    got, jgot = eng.run(trace), jeng.run(jtrace)
    assert _tokens(got) == _tokens(jgot)
    assert [(r.variant, r.slo, r.admitted_step, r.finished_step)
            for r in got] == [(r.variant, r.slo, r.admitted_step,
                               r.finished_step) for r in jgot]
    for key in ("decode_steps", "prefill_calls"):
        assert eng.stats[key] == jeng.stats[key], key
    summ = ts.summarize(got, eng.stats["wall_s"])["by_slo"]
    jsumm = js.summarize(jgot, jeng.stats["wall_s"])["by_slo"]
    assert set(summ) == set(jsumm) == {"batch", "interactive"}
    for cls in summ:
        assert summ[cls]["requests"] == jsumm[cls]["requests"] == 2
    for req in trace:
        solo = rt.PlanSet({"v": bank.variant(routes[req.slo]).plan}, params)
        (alone,) = ts.Engine(cfg, params, max_batch=1, max_len=64,
                             backend=solo).run([req])
        assert alone.tokens == _tokens(got)[req.rid], req.rid


def test_slo_unrouted_class_error_matches_jax(yi):
    jcfg, cfg, jparams, params, arts = yi
    jbank, bank = _banks(yi, {"default": arts["target"]}, None)
    jtrace, trace = _both_traces(n=2, vocab=cfg.vocab,
                                 slo_classes=["silver"])
    with pytest.raises(ValueError, match="no route") as want:
        js.Engine(jcfg, jparams, max_batch=2, max_len=64, backend=jbank,
                  slo_routes={"gold": "default"}).run(jtrace)
    with pytest.raises(ValueError) as got:
        ts.Engine(cfg, params, max_batch=2, max_len=64, backend=bank,
                  slo_routes={"gold": "default"}).run(trace)
    assert str(got.value) == str(want.value)
